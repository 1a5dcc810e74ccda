# Copy of bwtpu/readblock.py for the port; only its imports differ (tests/test_torch_hostcopy.py).
"""Columnar read I/O — the production FASTQ path (layer L0, C2).

The object-per-read parser (bwtpu.io.read_fastq) measures ~0.38 M
reads/s (round 3, this host): Read construction alone caps the
end-to-end rate far below the device rate. This module keeps the whole
file in flat NumPy columns instead — byte blob + offset arrays for ids,
a dense (n, L) uint8 ASCII matrix for uniform-length sequences/quals —
so parsing is a handful of vectorized passes and downstream encoding
(2-bit packing) reads straight from the matrix.

Scope: the uniform-length 4-line FASTQ fast path (the shape of every
BASELINE config read set). Anything else (ragged lengths, FASTA reads,
multi-line records) returns None from the sniffing loader and callers
fall back to bwtpu.io.read_reads.
"""

from __future__ import annotations

import dataclasses
import gzip

import numpy as np

from bwtpu_torch import dna
from bwtpu_torch.io import Read


@dataclasses.dataclass
class ReadBlock:
    """Columnar batch of n uniform-length reads."""

    n: int
    L: int
    id_blob: np.ndarray  # uint8[sum id lens]
    id_off: np.ndarray  # int64[n + 1]
    seq: np.ndarray  # uint8[n, L] ASCII, uppercased
    qual: np.ndarray | None  # uint8[n, L]
    # 2-bit packed payload (int32[n, W]); filled by the native parser,
    # else computed on demand by pack_block
    words: np.ndarray | None = None
    amb: np.ndarray | None = None

    def slice(self, lo: int, hi: int) -> "ReadBlock":
        hi = min(hi, self.n)
        return ReadBlock(
            n=hi - lo,
            L=self.L,
            id_blob=self.id_blob[self.id_off[lo] : self.id_off[hi]],
            id_off=(self.id_off[lo : hi + 1] - self.id_off[lo]),
            seq=self.seq[lo:hi],
            qual=self.qual[lo:hi] if self.qual is not None else None,
            words=self.words[lo:hi] if self.words is not None else None,
            amb=self.amb[lo:hi] if self.amb is not None else None,
        )

    def ids(self) -> list[str]:
        blob = self.id_blob.tobytes()
        off = self.id_off
        return [
            blob[off[i] : off[i + 1]].decode("ascii") for i in range(self.n)
        ]

    def to_reads(self) -> list[Read]:
        """Materialize Read objects (tests / fallback interop)."""
        ids = self.ids()
        seqs = self.seq
        quals = self.qual
        return [
            Read(
                rid=ids[i],
                seq=seqs[i].tobytes().decode("ascii"),
                qual=quals[i].tobytes().decode("ascii") if quals is not None else None,
            )
            for i in range(self.n)
        ]

    @classmethod
    def from_reads(cls, reads: list[Read]) -> "ReadBlock | None":
        """Columnarize a uniform-length Read list (None if ragged)."""
        if not reads:
            return None
        L = len(reads[0].seq)
        if any(len(r.seq) != L for r in reads):
            return None
        has_q = all(r.qual is not None and len(r.qual) == L for r in reads)
        seq = np.frombuffer(
            "".join(r.seq for r in reads).encode("ascii"), dtype=np.uint8
        ).reshape(len(reads), L)
        qual = (
            np.frombuffer(
                "".join(r.qual for r in reads).encode("ascii"), dtype=np.uint8
            ).reshape(len(reads), L)
            if has_q
            else None
        )
        ids = [r.rid.encode("ascii") for r in reads]
        off = np.zeros(len(reads) + 1, dtype=np.int64)
        off[1:] = np.cumsum([len(i) for i in ids])
        # seq kept verbatim: file parsers uppercase (read_fastq rule),
        # but direct Read objects must round-trip byte-for-byte
        return cls(
            n=len(reads), L=L,
            id_blob=np.frombuffer(b"".join(ids), dtype=np.uint8),
            id_off=off, seq=seq, qual=qual,
        )


def concat_blocks(b1: ReadBlock, b2: ReadBlock) -> ReadBlock:
    """Row-concatenated block [b1 rows | b2 rows] — one device dispatch
    for a paired batch (mates stacked on the batch axis). Requires
    equal L; packed payloads survive when both blocks carry them."""
    if b1.L != b2.L:
        raise ValueError("concat requires equal L")

    def cat(a, b):
        return None if a is None or b is None else np.concatenate([a, b])

    return ReadBlock(
        n=b1.n + b2.n, L=b1.L,
        id_blob=np.concatenate([b1.id_blob, b2.id_blob]),
        id_off=np.concatenate([b1.id_off, b1.id_off[-1] + b2.id_off[1:]]),
        seq=np.concatenate([b1.seq, b2.seq]),
        qual=cat(b1.qual, b2.qual),
        words=cat(b1.words, b2.words),
        amb=cat(b1.amb, b2.amb),
    )


def interleave_blocks(b1: ReadBlock, b2: ReadBlock) -> ReadBlock:
    """Row-interleaved block [b1[0], b2[0], b1[1], b2[1], ...] — the SAM
    record order of a paired batch (mate records adjacent). Requires
    equal n and L; packed payloads are dropped (emission-only use)."""
    if b1.n != b2.n or b1.L != b2.L:
        raise ValueError("interleave requires equal n and L")
    n, L = b1.n, b1.L
    seq = np.stack([b1.seq, b2.seq], axis=1).reshape(2 * n, L)
    qual = None
    if b1.qual is not None and b2.qual is not None:
        qual = np.stack([b1.qual, b2.qual], axis=1).reshape(2 * n, L)
    l1 = np.diff(b1.id_off)
    l2 = np.diff(b2.id_off)
    lens_i = np.stack([l1, l2], axis=1).reshape(-1)
    off_i = np.zeros(2 * n + 1, dtype=np.int64)
    off_i[1:] = np.cumsum(lens_i)
    blob = np.empty(int(off_i[-1]), dtype=np.uint8)

    def place(dst_starts, lens, src_blob):
        total = int(lens.sum())
        if total == 0:
            return
        excl = np.zeros(len(lens), dtype=np.int64)
        excl[1:] = np.cumsum(lens)[:-1]
        dst = np.repeat(dst_starts, lens) + (
            np.arange(total, dtype=np.int64) - np.repeat(excl, lens)
        )
        blob[dst] = src_blob

    place(off_i[0 : 2 * n : 2], l1, b1.id_blob)
    place(off_i[1 : 2 * n : 2], l2, b2.id_blob)
    return ReadBlock(n=2 * n, L=L, id_blob=blob, id_off=off_i, seq=seq,
                     qual=qual)


def _upper(a: np.ndarray) -> np.ndarray:
    return np.where((a >= 97) & (a <= 122), a - 32, a)


_SCAN_STRIDE = 8192  # records per resume checkpoint (see fastq.cc)


def _native_parse(data: np.ndarray, threads: int | None = None
                  ) -> ReadBlock | None:
    """csrc/fastq.cc parse + 2-bit pack (None -> fall back).

    The scan pass samples resume checkpoints every _SCAN_STRIDE
    records; the fill pass then runs as `threads` disjoint
    bwtpu_fastq_parse_range calls on Python threads (ctypes releases
    the GIL), splitting the memory-bound work across cores — this host
    moves ~190 MB/s/core (docs/DESIGN.md "e2e host roofline"), so the
    parse wall halves with the second core."""
    import ctypes
    import os

    from bwtpu_torch import sais

    lib = sais._load_native()
    if lib is None or not hasattr(lib, "bwtpu_fastq_scan"):
        return None
    data = np.ascontiguousarray(data, dtype=np.uint8)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    i32 = ctypes.POINTER(ctypes.c_int32)
    i64 = ctypes.POINTER(ctypes.c_int64)
    n = ctypes.c_int64(0)
    L = ctypes.c_int32(0)
    idb = ctypes.c_int64(0)
    nsamp = ctypes.c_int64(0)
    cap = int(data.size // (8 * _SCAN_STRIDE)) + 2
    samples = np.zeros((cap, 3), dtype=np.int64)
    rc = lib.bwtpu_fastq_scan(
        data.ctypes.data_as(u8), ctypes.c_int64(data.size),
        ctypes.byref(n), ctypes.byref(L), ctypes.byref(idb),
        ctypes.c_int64(_SCAN_STRIDE), samples.ctypes.data_as(i64),
        ctypes.c_int64(cap), ctypes.byref(nsamp),
    )
    if rc != 0:
        return None
    n, L, idb, nsamp = n.value, L.value, idb.value, nsamp.value
    W = (L + 15) // 16
    seq = np.empty((n, L), dtype=np.uint8)
    qual = np.empty((n, L), dtype=np.uint8)
    id_blob = np.empty(max(idb, 1), dtype=np.uint8)
    id_off = np.empty(n + 1, dtype=np.int64)
    words = np.empty((n, W), dtype=np.int32)
    amb = np.empty((n, W), dtype=np.int32)

    T = threads if threads is not None else min(2, os.cpu_count() or 1)
    # range starts must sit on scan checkpoints; pick ~evenly spaced ones
    if T > 1 and nsamp > 1:
        picks = sorted({int(t * nsamp // T) for t in range(T)})
        bounds = [tuple(samples[k]) for k in picks]  # (rec, byte, idb)
    else:
        bounds = [(0, 0, 0)]
    bounds.append((n, data.size, idb))

    def parse_range(k):
        rec0, byte0, idb0 = bounds[k]
        n_k = bounds[k + 1][0] - rec0
        id_off[rec0] = idb0
        return lib.bwtpu_fastq_parse_range(
            data.ctypes.data_as(u8), ctypes.c_int64(data.size),
            ctypes.c_int64(int(rec0)), ctypes.c_int64(int(byte0)),
            ctypes.c_int64(int(idb0)), ctypes.c_int64(int(n_k)),
            ctypes.c_int32(L),
            seq.ctypes.data_as(u8), qual.ctypes.data_as(u8),
            id_blob.ctypes.data_as(u8), id_off.ctypes.data_as(i64),
            words.ctypes.data_as(i32), amb.ctypes.data_as(i32),
        )

    if len(bounds) > 2:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(len(bounds) - 1) as ex:
            rcs = list(ex.map(parse_range, range(len(bounds) - 1)))
    else:
        rcs = [parse_range(0)]
    if any(r != 0 for r in rcs):
        return None
    return ReadBlock(
        n=n, L=L, id_blob=id_blob[:idb], id_off=id_off, seq=seq, qual=qual,
        words=words, amb=amb,
    )


def read_fastq_block(path: str) -> ReadBlock | None:
    """Parse a strict 4-line-record, uniform-length FASTQ into a
    ReadBlock (native single-pass parser when available, vectorized
    NumPy otherwise). Returns None when the file does not fit the
    fast-path shape (caller falls back to io.read_fastq, whose output
    is byte-equivalent)."""
    data = _load_bytes(path)
    if data.size == 0:
        return None
    blk = _native_parse(data)
    if blk is not None:
        return blk
    if data[-1] != 10:  # ensure trailing newline so lines == nl count
        data = np.concatenate([data, np.array([10], dtype=np.uint8)])
    nl = np.flatnonzero(data == 10)
    n_lines = len(nl)
    if n_lines % 4 != 0:
        return None
    starts = np.empty(n_lines, dtype=np.int64)
    starts[0] = 0
    starts[1:] = nl[:-1] + 1
    ends = nl.astype(np.int64)
    # strip \r for CRLF files
    if data.size > 1 and np.any(data[ends - 1] == 13):
        ends = ends - (data[np.maximum(ends - 1, 0)] == 13)

    h_start, h_end = starts[0::4], ends[0::4]
    s_start, s_end = starts[1::4], ends[1::4]
    p_start = starts[2::4]
    q_start, q_end = starts[3::4], ends[3::4]
    n = len(h_start)
    if not (
        np.all(data[h_start] == ord("@")) and np.all(data[p_start] == ord("+"))
    ):
        return None
    slen = s_end - s_start
    L = int(slen[0]) if n else 0
    if L == 0 or not np.all(slen == L) or not np.all(q_end - q_start == L):
        return None

    seq = _upper(data[s_start[:, None] + np.arange(L)])
    qual = data[q_start[:, None] + np.arange(L)]

    # ids: header minus '@', cut at first whitespace (io.read_fastq rule)
    hs = h_start + 1
    hlen = h_end - hs
    maxh = int(hlen.max(initial=0))
    hm = data[np.minimum(hs[:, None] + np.arange(maxh), data.size - 1)]
    col_ok = np.arange(maxh)[None, :] < hlen[:, None]
    white = ((hm == 32) | (hm == 9)) & col_ok
    idlen = np.where(white.any(axis=1), white.argmax(axis=1), hlen)
    total = int(idlen.sum())
    off = np.zeros(n + 1, dtype=np.int64)
    off[1:] = np.cumsum(idlen)
    pos_in_id = np.arange(total, dtype=np.int64) - np.repeat(off[:-1], idlen)
    id_blob = data[np.repeat(hs, idlen) + pos_in_id]
    return ReadBlock(n=n, L=L, id_blob=id_blob, id_off=off, seq=seq, qual=qual)


def _load_bytes(path: str) -> np.ndarray:
    if str(path).endswith(".gz"):
        with open(path, "rb") as f:
            raw = gzip.decompress(f.read())
        return np.frombuffer(raw, dtype=np.uint8)
    return np.fromfile(path, dtype=np.uint8)


def _fastq_line_arrays(data: np.ndarray):
    """4-line FASTQ structure scan -> (h_start, h_end, s_start, s_end,
    q_start, q_end) line-bound arrays, or None if not 4-line FASTQ."""
    if data.size == 0:
        return None
    if data[-1] != 10:  # ensure trailing newline so lines == nl count
        data = np.concatenate([data, np.array([10], dtype=np.uint8)])
    nl = np.flatnonzero(data == 10)
    n_lines = len(nl)
    if n_lines % 4 != 0:
        return None
    starts = np.empty(n_lines, dtype=np.int64)
    starts[0] = 0
    starts[1:] = nl[:-1] + 1
    ends = nl.astype(np.int64)
    if data.size > 1 and np.any(data[ends - 1] == 13):  # CRLF
        ends = ends - (data[np.maximum(ends - 1, 0)] == 13)
    h_start, h_end = starts[0::4], ends[0::4]
    s_start, s_end = starts[1::4], ends[1::4]
    p_start = starts[2::4]
    q_start, q_end = starts[3::4], ends[3::4]
    if len(h_start) and not (
        np.all(data[h_start] == ord("@")) and np.all(data[p_start] == ord("+"))
    ):
        return None
    return data, h_start, h_end, s_start, s_end, q_start, q_end


def _ids_from_headers(data, h_start, h_end):
    """Vectorized id extraction: header minus '@', cut at first
    whitespace (io.read_fastq rule) -> (id_blob, id_off)."""
    n = len(h_start)
    hs = h_start + 1
    hlen = h_end - hs
    maxh = int(hlen.max(initial=0))
    hm = data[np.minimum(hs[:, None] + np.arange(maxh), data.size - 1)]
    col_ok = np.arange(maxh)[None, :] < hlen[:, None]
    white = ((hm == 32) | (hm == 9)) & col_ok
    idlen = np.where(white.any(axis=1), white.argmax(axis=1), hlen)
    total = int(idlen.sum())
    off = np.zeros(n + 1, dtype=np.int64)
    off[1:] = np.cumsum(idlen)
    pos_in_id = np.arange(total, dtype=np.int64) - np.repeat(off[:-1], idlen)
    id_blob = data[np.repeat(hs, idlen) + pos_in_id]
    return id_blob, off


def read_fastq_stream_ragged(path: str, chunk: int, start: int = 0):
    """Length-bucketed columnar stream for MIXED-length 4-line FASTQ
    (VERDICT r3 item 7 — the single-process twin of multihost.py's
    bucketed schedule): ragged streams stay on the packed columnar
    pipelines instead of demoting to the ~0.38 M reads/s object-per-
    read path.

    Returns (n_reads, max_len, generator) or None if the file is not
    4-line FASTQ. The generator yields, per INPUT-ORDER chunk of
    `chunk` records, a list of (ReadBlock, orig_idx int64[nb]) — one
    uniform-length block per distinct read length in the chunk, plus
    that block's original record indices (chunk-local) so the caller's
    reorder buffer can emit in input order. `start` skips chunks
    without building their blocks (cursor resume, cli.py)."""
    data = _load_bytes(path)
    scan = _fastq_line_arrays(data)
    if scan is None:
        return None
    data, h_start, h_end, s_start, s_end, q_start, q_end = scan
    n = len(h_start)
    slen = s_end - s_start
    if n == 0 or np.any(q_end - q_start != slen) or np.any(slen <= 0):
        return None
    max_len = int(slen.max())

    def build(sub):
        """Uniform-length ReadBlock for record indices `sub`."""
        L = int(slen[sub[0]])
        seq = _upper(data[s_start[sub][:, None] + np.arange(L)])
        qual = data[q_start[sub][:, None] + np.arange(L)]
        id_blob, id_off = _ids_from_headers(data, h_start[sub], h_end[sub])
        return ReadBlock(n=len(sub), L=L, id_blob=id_blob, id_off=id_off,
                         seq=seq, qual=qual)

    def gen():
        for lo in range(start * chunk, n, chunk):
            idx = np.arange(lo, min(lo + chunk, n), dtype=np.int64)
            groups = []
            for L in np.unique(slen[idx]):
                sub = idx[slen[idx] == L]
                groups.append((build(sub), sub - lo))
            yield groups

    return n, max_len, gen()


def read_fastq_stream(path: str, chunk: int, start: int = 0):
    """(n_reads, L, iterator of ReadBlocks of `chunk` records each,
    last one partial) — or None if the file does not fit the fast-path
    shape. `start` skips the first `start` chunks WITHOUT parsing them
    (checkpointed resume, cli.py --resume).

    One cheap scan pass records a resume checkpoint every `chunk`
    records; each chunk is then parsed independently
    (bwtpu_fastq_parse_range) ONE CHUNK AHEAD on a background thread,
    so the memory-bound parse overlaps whatever the consumer does with
    the previous chunk (dispatch, hit assembly, SAM write) — on this
    2-core ~190 MB/s/core host that overlap is most of the end-to-end
    win (docs/DESIGN.md "e2e host roofline")."""
    import ctypes
    from concurrent.futures import ThreadPoolExecutor

    from bwtpu_torch import sais

    lib = sais._load_native()
    data = _load_bytes(path)
    if data.size == 0:
        return None
    if lib is None or not hasattr(lib, "bwtpu_fastq_scan"):
        blk = read_fastq_block(path)
        if blk is None:
            return None

        def fallback():
            for lo in range(start * chunk, blk.n, chunk):
                yield blk.slice(lo, lo + chunk)

        return blk.n, blk.L, fallback()
    data = np.ascontiguousarray(data, dtype=np.uint8)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    i32 = ctypes.POINTER(ctypes.c_int32)
    i64 = ctypes.POINTER(ctypes.c_int64)
    n = ctypes.c_int64(0)
    L = ctypes.c_int32(0)
    idb = ctypes.c_int64(0)
    nsamp = ctypes.c_int64(0)
    cap = int(data.size // (8 * chunk)) + 2
    samples = np.zeros((cap, 3), dtype=np.int64)
    rc = lib.bwtpu_fastq_scan(
        data.ctypes.data_as(u8), ctypes.c_int64(data.size),
        ctypes.byref(n), ctypes.byref(L), ctypes.byref(idb),
        ctypes.c_int64(chunk), samples.ctypes.data_as(i64),
        ctypes.c_int64(cap), ctypes.byref(nsamp),
    )
    if rc != 0:
        return None
    n, L, idb, nsamp = n.value, L.value, idb.value, nsamp.value
    W = (L + 15) // 16
    bounds = [tuple(samples[k]) for k in range(nsamp)]
    bounds.append((n, data.size, idb))

    def parse_chunk(k):
        rec0, byte0, idb0 = bounds[k]
        n_k = int(bounds[k + 1][0] - rec0)
        idb_k = int(bounds[k + 1][2] - idb0)
        seq = np.empty((n_k, L), dtype=np.uint8)
        qual = np.empty((n_k, L), dtype=np.uint8)
        id_blob = np.empty(max(idb_k, 1), dtype=np.uint8)
        id_off = np.empty(n_k + 1, dtype=np.int64)
        id_off[0] = 0
        words = np.empty((n_k, W), dtype=np.int32)
        amb = np.empty((n_k, W), dtype=np.int32)
        # rec0=0 / idb0=0: outputs are chunk-local; only the byte
        # cursor resumes mid-file
        rc = lib.bwtpu_fastq_parse_range(
            data.ctypes.data_as(u8), ctypes.c_int64(data.size),
            ctypes.c_int64(0), ctypes.c_int64(int(byte0)),
            ctypes.c_int64(0), ctypes.c_int64(n_k), ctypes.c_int32(L),
            seq.ctypes.data_as(u8), qual.ctypes.data_as(u8),
            id_blob.ctypes.data_as(u8), id_off.ctypes.data_as(i64),
            words.ctypes.data_as(i32), amb.ctypes.data_as(i32),
        )
        if rc != 0:
            raise ValueError(f"fastq chunk {k} failed to parse (rc={rc})")
        return ReadBlock(n=n_k, L=L, id_blob=id_blob[:idb_k],
                         id_off=id_off, seq=seq, qual=qual,
                         words=words, amb=amb)

    def gen():
        if start >= len(bounds) - 1:
            return
        ex = ThreadPoolExecutor(max_workers=1)
        try:
            nxt = ex.submit(parse_chunk, start)
            for k in range(start, len(bounds) - 1):
                blk = nxt.result()
                if k + 1 < len(bounds) - 1:
                    nxt = ex.submit(parse_chunk, k + 1)
                yield blk
        finally:
            ex.shutdown(wait=False)

    return n, L, gen()


def encode_block(block: ReadBlock) -> tuple[np.ndarray, np.ndarray]:
    """ASCII seq matrix -> (codes int32[n, L], ambiguous int32[n, L])."""
    codes = dna._ENC[block.seq].astype(np.int32)
    amb = (~dna._IS_ACGT[block.seq]).astype(np.int32)
    return codes, amb


def pack_block(block: ReadBlock) -> tuple[np.ndarray, np.ndarray]:
    """ASCII seq matrix -> 2-bit packed (read_words, amb_bits), each
    int32[n, W] — the device batch payload (engine packed path)."""
    if block.words is not None and block.amb is not None:
        return block.words, block.amb
    codes, amb = encode_block(block)
    n, L = codes.shape
    W = (L + 15) // 16
    if L % 16:
        pad = np.zeros((n, W * 16 - L), dtype=np.int32)
        codes = np.concatenate([codes, pad], axis=1)
        amb = np.concatenate([amb, pad], axis=1)
    shifts = (2 * (np.arange(16) % 16)).astype(np.uint32)
    words = (codes.astype(np.uint32).reshape(n, W, 16) << shifts).reshape(n, W, 16)
    words = np.bitwise_or.reduce(words, axis=2)
    ab = (amb.astype(np.uint32).reshape(n, W, 16) << shifts).reshape(n, W, 16)
    ab = np.bitwise_or.reduce(ab, axis=2)
    return words.view(np.int32), ab.view(np.int32)
