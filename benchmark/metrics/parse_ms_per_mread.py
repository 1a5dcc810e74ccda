"""parse_ms_per_mread: the main thread's time in the FASTQ reader
(read_fastq_stream: load and scan; each next chunk: the wait on its
parse-ahead thread), in ms per million reads done (sam cells)."""


def read(w):
    s, _ = w.span_s("read_fastq_stream", "next_chunk")
    return s * 1e3 / (w.reads / 1e6) if w.entry == "sam" and w.reads else None
