// Batch SAM record formatter (layer L0, component C14 — SURVEY.md §3.3).
//
// The Python per-record formatter (bwtpu/sam.py::_record) measures
// ~0.32 M reads/s (round 3, this host) — far below the device align
// rate — so the production emission path formats whole batches here:
// the host supplies flat arrays (id blob + offsets, dense seq/qual
// matrices, per-record FLAG/RNAME/POS/MAPQ/NM columns) and this pass
// writes the final SAM bytes in one sweep. Field layout is pinned by
// bwtpu/sam.py (QNAME FLAG RNAME POS MAPQ CIGAR RNEXT PNEXT TLEN SEQ
// QUAL [NM:i:x]); byte equality with the Python formatter is asserted
// in tests/test_fastpath.py.
//
// Reverse-strand records emit the reverse complement of SEQ and the
// reversed QUAL (complement table matches bwtpu/dna.py::revcomp_str:
// A<->T, C<->G, everything else -> 'N').

#include <cstdint>
#include <cstring>

namespace {

char comp_table[256];

struct CompInit {
    CompInit() {
        // matches bwtpu/dna.py::revcomp_str, which uppercases first:
        // lowercase acgt complement like their uppercase forms
        for (int i = 0; i < 256; ++i) comp_table[i] = 'N';
        const char* from = "ATCGatcg";
        const char* to = "TAGCTAGC";
        for (int i = 0; i < 8; ++i)
            comp_table[uint8_t(from[i])] = to[i];
    }
} comp_init;

// unsigned decimal; returns chars written
inline int u64_to_chars(uint64_t v, char* p) {
    char tmp[20];
    int k = 0;
    do {
        tmp[k++] = char('0' + v % 10);
        v /= 10;
    } while (v);
    for (int i = 0; i < k; ++i) p[i] = tmp[k - 1 - i];
    return k;
}

inline int i64_to_chars(int64_t v, char* p) {
    if (v < 0) {
        *p = '-';
        return 1 + u64_to_chars(uint64_t(-(v + 1)) + 1, p + 1);
    }
    return u64_to_chars(uint64_t(v), p);
}

}  // namespace

extern "C" {

// Format n single- or paired-end SAM records into `out`.
// Returns bytes written, or -1 if out_cap could be exceeded (caller
// sizes out with bwtpu/samfast.py's upper bound, so -1 is a bug trap).
// v2: adds `trunc` (bool[n] or nullptr) — records of reads whose
// results are still capacity-truncated after the engine's bounded
// self-healing retries get a trailing "xo:i:1" tag (lowercase tags are
// reserved for local use by the SAM spec; VERDICT r3 item 3 "mark the
// read in SAM instead of a log line"). Renamed so a stale .so predating
// this signature fails attribute lookup and triggers the rebuild path
// in bwtpu/samfast.py rather than corrupting memory.
int64_t bwtpu_sam_format2(
    const uint8_t* id_blob, const int64_t* id_off,
    const uint8_t* seq,   // n * L ASCII, uppercase
    const uint8_t* qual,  // n * L or nullptr (emits '*')
    int32_t L, int64_t n,
    const uint8_t* mapped,     // bool[n]
    const int32_t* flag,       // full FLAG per record
    const int32_t* rname_id,   // contig id; only read when mapped
    const int64_t* pos1,       // 1-based POS; only read when mapped
    const int32_t* mapq,       // only read when mapped
    const int32_t* rnext_id,   // -1 -> '*', -2 -> '=', else contig id
    const int64_t* pnext1,
    const int64_t* tlen,       // only read when mapped
    const int32_t* nm,         // NM:i tag; only emitted when mapped
    const uint8_t* revcomp,    // bool[n]: revcomp SEQ / reverse QUAL
    const uint8_t* trunc,      // bool[n] or nullptr: append xo:i:1
    const uint8_t* rname_blob, const int64_t* rname_off,
    uint8_t* out, int64_t out_cap) {
    char* p = reinterpret_cast<char*>(out);
    char* end = p + out_cap;
    // worst case per record outside id/rname/seq/qual:
    // 11 tabs + flag(5) + pos(20) + mapq(11) + cigar(11) + pnext(20)
    // + tlen(20) + "NM:i:"(5) + nm(11) + "\txo:i:1"(7) + newline + slack
    const int64_t FIXED = 136;
    char cigar[16];
    int cigar_len = u64_to_chars(uint64_t(L), cigar);
    cigar[cigar_len] = 'M';
    ++cigar_len;

    for (int64_t i = 0; i < n; ++i) {
        int64_t idl = id_off[i + 1] - id_off[i];
        int64_t rnl = 0;
        int32_t rid = -1;
        bool is_mapped = mapped[i] != 0;
        if (is_mapped) {
            rid = rname_id[i];
            rnl = rname_off[rid + 1] - rname_off[rid];
        }
        int32_t rxid = rnext_id[i];
        int64_t rxl = (rxid >= 0) ? rname_off[rxid + 1] - rname_off[rxid] : 1;
        if (p + idl + rnl + rxl + 2 * int64_t(L) + FIXED > end) return -1;

        // QNAME
        memcpy(p, id_blob + id_off[i], size_t(idl));
        p += idl;
        *p++ = '\t';
        // FLAG
        p += i64_to_chars(flag[i], p);
        *p++ = '\t';
        if (is_mapped) {
            memcpy(p, rname_blob + rname_off[rid], size_t(rnl));
            p += rnl;
            *p++ = '\t';
            p += i64_to_chars(pos1[i], p);
            *p++ = '\t';
            p += i64_to_chars(mapq[i], p);
            *p++ = '\t';
            memcpy(p, cigar, size_t(cigar_len));
            p += cigar_len;
            *p++ = '\t';
        } else {
            memcpy(p, "*\t0\t0\t*\t", 8);
            p += 8;
        }
        // RNEXT
        if (rxid == -1) {
            *p++ = '*';
        } else if (rxid == -2) {
            *p++ = '=';
        } else {
            memcpy(p, rname_blob + rname_off[rxid], size_t(rxl));
            p += rxl;
        }
        *p++ = '\t';
        // PNEXT
        p += i64_to_chars(pnext1[i], p);
        *p++ = '\t';
        // TLEN (unmapped records pin "0" — bwtpu/sam.py::_record)
        p += i64_to_chars(is_mapped ? tlen[i] : 0, p);
        *p++ = '\t';
        // SEQ
        const uint8_t* s = seq + i * int64_t(L);
        if (revcomp[i]) {
            for (int32_t j = L - 1; j >= 0; --j) *p++ = comp_table[s[j]];
        } else {
            memcpy(p, s, size_t(L));
            p += L;
        }
        *p++ = '\t';
        // QUAL
        if (qual == nullptr) {
            *p++ = '*';
        } else {
            const uint8_t* q = qual + i * int64_t(L);
            if (revcomp[i]) {
                for (int32_t j = L - 1; j >= 0; --j) *p++ = char(q[j]);
            } else {
                memcpy(p, q, size_t(L));
                p += L;
            }
        }
        if (is_mapped) {
            memcpy(p, "\tNM:i:", 6);
            p += 6;
            p += i64_to_chars(nm[i], p);
        }
        if (trunc != nullptr && trunc[i]) {
            memcpy(p, "\txo:i:1", 7);
            p += 7;
        }
        *p++ = '\n';
    }
    return p - reinterpret_cast<char*>(out);
}

}  // extern "C"
