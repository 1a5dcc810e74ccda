// Single-pass FASTQ parse + 2-bit pack (layer L0, component C2).
//
// The NumPy columnar parser (bwtpu/readblock.py) plus the separate
// 2-bit packing pass measured ~950 ms per 262 K-read batch on this
// host (multi-pass memory traffic on a 2-core VM; docs/DESIGN.md
// "page-fault wall"). This pass reads the raw file bytes once and
// emits everything the engine and the SAM formatter need:
//   - seq matrix      uint8[n, L] ASCII, uppercased
//   - qual matrix     uint8[n, L]
//   - id blob/offsets (QNAME = header minus '@', cut at first
//                      whitespace — bwtpu/io.py::read_fastq rule)
//   - read_words      int32[n, W] 2-bit packed bases (A=0 C=1 G=2 T=3;
//                      base j -> bit 2*(j%16) of word j/16, matching
//                      bwtpu/kernels/verify2.py::pack_reads)
//   - amb_bits        int32[n, W] same layout, bit set where the char
//                      is not ACGT (N etc.) — such bases never match.
//
// Scope: strict 4-line records, uniform length (the fast path shape).
// Anything else returns a negative rc and the caller falls back to the
// Python parsers, which accept the general format.

#include <cstdint>
#include <cstring>

namespace {

struct Tables {
    uint8_t upper[256];
    uint8_t code[256];  // 2-bit base code (0 for non-ACGT)
    uint8_t amb[256];   // 1 where not ACGT
    Tables() {
        for (int i = 0; i < 256; ++i) {
            upper[i] = (i >= 'a' && i <= 'z') ? uint8_t(i - 32) : uint8_t(i);
            code[i] = 0;
            amb[i] = 1;
        }
        const char* b = "ACGT";
        for (int i = 0; i < 4; ++i) {
            code[uint8_t(b[i])] = uint8_t(i);
            code[uint8_t(b[i] + 32)] = uint8_t(i);
            amb[uint8_t(b[i])] = 0;
            amb[uint8_t(b[i] + 32)] = 0;
        }
    }
} T;

// [start, end) of the next line; returns false at EOF. Trims \r.
inline bool next_line(const uint8_t* d, int64_t size, int64_t& cur,
                      int64_t& s, int64_t& e) {
    if (cur >= size) return false;
    s = cur;
    const void* nl = memchr(d + cur, '\n', size_t(size - cur));
    if (nl == nullptr) {
        e = size;
        cur = size;
    } else {
        e = static_cast<const uint8_t*>(nl) - d;
        cur = e + 1;
    }
    if (e > s && d[e - 1] == '\r') --e;
    return true;
}

}  // namespace

extern "C" {

// Pass 1: count records, detect uniform length, sum id bytes.
// rc 0 = fast-path OK; -1 = not 4-line/uniform/valid (caller falls back)
//
// Every `stride` records (when stride > 0 and samples != null), the
// scanner records (record index, byte offset, id bytes so far) into
// samples[3 * k] — checkpoint state from which bwtpu_fastq_parse_range
// can resume mid-file, so the fill pass splits across threads (ctypes
// releases the GIL, so plain Python threads parallelize it).
// sample_cap caps k; out_n_samples reports how many were written.
int bwtpu_fastq_scan(const uint8_t* data, int64_t size, int64_t* out_n,
                     int32_t* out_L, int64_t* out_id_bytes,
                     int64_t stride, int64_t* samples, int64_t sample_cap,
                     int64_t* out_n_samples) {
    int64_t cur = 0, s, e, n = 0, idb = 0;
    int64_t L = -1;
    int64_t ns = 0;
    while (true) {
        if (stride > 0 && samples != nullptr && n % stride == 0 &&
            ns < sample_cap && cur < size) {
            samples[3 * ns] = n;
            samples[3 * ns + 1] = cur;
            samples[3 * ns + 2] = idb;
            ++ns;
        }
        if (!next_line(data, size, cur, s, e)) break;
        if (e == s && cur >= size) break;  // trailing blank line
        if (e == s || data[s] != '@') return -1;
        int64_t hlen = e - s - 1;
        int64_t idl = hlen;
        for (int64_t j = 0; j < hlen; ++j) {
            uint8_t c = data[s + 1 + j];
            if (c == ' ' || c == '\t') {
                idl = j;
                break;
            }
        }
        idb += idl;
        if (!next_line(data, size, cur, s, e)) return -1;  // seq
        int64_t sl = e - s;
        if (L < 0) L = sl;
        if (sl != L || L == 0) return -1;
        if (!next_line(data, size, cur, s, e)) return -1;  // +
        if (e == s || data[s] != '+') return -1;
        if (!next_line(data, size, cur, s, e)) return -1;  // qual
        if (e - s != L) return -1;
        ++n;
    }
    if (n == 0 || L <= 0 || L > (1 << 20)) return -1;
    *out_n = n;
    *out_L = int32_t(L);
    *out_id_bytes = idb;
    if (out_n_samples != nullptr) *out_n_samples = ns;
    return 0;
}

// Pass 2 (range form): fill records [rec0, rec0 + n) of the GLOBAL
// caller-allocated outputs, resuming the parse at byte offset byte0
// with id-blob cursor idb0 — the checkpoint triple bwtpu_fastq_scan
// sampled. id_off[rec0] must already be set by the caller; this fills
// id_off[rec0 + 1 .. rec0 + n]. Ranges are disjoint, so threads fill
// concurrently without synchronization.
int bwtpu_fastq_parse_range(const uint8_t* data, int64_t size,
                            int64_t rec0, int64_t byte0, int64_t idb0,
                            int64_t n, int32_t L, uint8_t* seq,
                            uint8_t* qual, uint8_t* id_blob,
                            int64_t* id_off, int32_t* read_words,
                            int32_t* amb_bits) {
    const int32_t W = (L + 15) / 16;
    int64_t cur = byte0, s, e;
    int64_t idp = idb0;
    seq += rec0 * int64_t(L);
    qual += rec0 * int64_t(L);
    id_off += rec0;
    read_words += rec0 * int64_t(W);
    amb_bits += rec0 * int64_t(W);
    for (int64_t i = 0; i < n; ++i) {
        if (!next_line(data, size, cur, s, e)) return -2;  // header
        int64_t hlen = e - s - 1;
        const uint8_t* h = data + s + 1;
        int64_t idl = hlen;
        for (int64_t j = 0; j < hlen; ++j) {
            if (h[j] == ' ' || h[j] == '\t') {
                idl = j;
                break;
            }
        }
        memcpy(id_blob + idp, h, size_t(idl));
        idp += idl;
        id_off[i + 1] = idp;

        if (!next_line(data, size, cur, s, e)) return -2;  // seq
        const uint8_t* sp = data + s;
        uint8_t* so = seq + i * int64_t(L);
        int32_t* rw = read_words + i * int64_t(W);
        int32_t* ab = amb_bits + i * int64_t(W);
        for (int32_t w = 0; w < W; ++w) {
            uint32_t wv = 0, av = 0;
            int32_t base = w * 16;
            int32_t m = (L - base < 16) ? L - base : 16;
            for (int32_t t = 0; t < m; ++t) {
                uint8_t c = sp[base + t];
                so[base + t] = T.upper[c];
                wv |= uint32_t(T.code[c]) << (2 * t);
                av |= uint32_t(T.amb[c]) << (2 * t);
            }
            rw[w] = int32_t(wv);
            ab[w] = int32_t(av);
        }
        if (!next_line(data, size, cur, s, e)) return -2;  // +
        if (!next_line(data, size, cur, s, e)) return -2;  // qual
        memcpy(qual + i * int64_t(L), data + s, size_t(L));
    }
    return 0;
}

// Pass 2, whole file (compatibility wrapper).
int bwtpu_fastq_parse(const uint8_t* data, int64_t size, int64_t n,
                      int32_t L, uint8_t* seq, uint8_t* qual,
                      uint8_t* id_blob, int64_t* id_off,
                      int32_t* read_words, int32_t* amb_bits) {
    id_off[0] = 0;
    return bwtpu_fastq_parse_range(data, size, 0, 0, 0, n, L, seq, qual,
                                   id_blob, id_off, read_words, amb_bits);
}

}  // extern "C"
