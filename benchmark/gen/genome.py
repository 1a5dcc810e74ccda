"""A configuration's genome: uniform random bases with its repeat families
inserted, from the seed in its file (vectorised NumPy; seconds at chr21's
46.7 Mbp).

Each entry of the file's "repeats" is one group of families:

  name          a label
  families      how many families (each its own random consensus)
  length        [lo, hi]: a family's consensus length, drawn uniformly
  copies        a family's copy count, an int or [lo, hi] drawn uniformly;
  share         or else the share of the genome the group's copies fill
  divergence    [lo, hi]: each copy's substitution rate from its consensus
  truncated     optional {"share", "mean", "min"}: that share of copies keeps
                only the consensus's 3' end, exponential in length with that
                mean, at least "min" bases (5'-truncated, as L1 copies are)
  reverse_share the share of copies inserted reverse-complemented

Copies go at uniform points between background bases, so the genome has
exactly the configuration's length. Codes are A=0 C=1 G=2 T=3.
"""

from __future__ import annotations

import numpy as np

ASCII = np.frombuffer(b"ACGT", dtype=np.uint8)


def _draw(rng, spec, size=None):
    """An int spec, or [lo, hi] drawn uniformly (inclusive)."""
    if isinstance(spec, (list, tuple)):
        return rng.integers(spec[0], spec[1] + 1, size=size)
    return np.full(size, spec) if size is not None else spec


def _copy_lengths(rng, group, cons_len: int, n: int) -> np.ndarray:
    lens = np.full(n, cons_len, dtype=np.int64)
    tr = group.get("truncated")
    if tr:
        cut = rng.random(n) < tr["share"]
        short = np.maximum(tr["min"], rng.exponential(tr["mean"], n).astype(np.int64))
        lens = np.where(cut, np.minimum(short, cons_len), lens)
    return lens


def _group_copies(rng, group, genome_len: int):
    """(consensus list, family of each copy, copy lengths) of one group."""
    cons, fam_of, lens = [], [], []
    share = group.get("share")
    for f in range(group["families"]):
        c_len = int(_draw(rng, group["length"]))
        cons.append(rng.integers(0, 4, c_len, dtype=np.uint8))
        if share is None:
            n = int(_draw(rng, group["copies"]))
            ln = _copy_lengths(rng, group, c_len, n)
        else:
            # draw copies until the family's part of the share is filled
            target = share * genome_len / group["families"]
            ln = np.zeros(0, dtype=np.int64)
            while ln.sum() < target:
                ln = np.concatenate([ln, _copy_lengths(rng, group, c_len, 4096)])
            ln = ln[: int(np.searchsorted(np.cumsum(ln), target)) + 1]
        fam_of.append(np.full(len(ln), f))
        lens.append(ln)
    return cons, np.concatenate(fam_of), np.concatenate(lens)


def make_genome(cfg: dict) -> tuple[np.ndarray, dict]:
    """(uint8[cfg["length"]] codes, {group name: {"copies", "share"}}) of
    the configuration's genome."""
    rng = np.random.default_rng(cfg["genome_seed"])
    n = int(cfg["length"])
    pieces, info = [], {}
    for group in cfg.get("repeats", []):
        cons, fam, lens = _group_copies(rng, group, n)
        div = rng.uniform(*group["divergence"], size=len(lens))
        rev = rng.random(len(lens)) < group.get("reverse_share", 0.5)
        # each copy from its consensus (the 3' end when truncated), then
        # substitutions at the copy's own rate, to a different base
        cat = np.concatenate([cons[f][len(cons[f]) - ln:] for f, ln in zip(fam, lens)])
        hit = rng.random(len(cat)) < np.repeat(div, lens)
        cat[hit] = (cat[hit] + rng.integers(1, 4, int(hit.sum()), dtype=np.uint8)) % 4
        copies = np.split(cat, np.cumsum(lens)[:-1])
        pieces += [(3 - c[::-1]) if r else c for c, r in zip(copies, rev)]
        info[group["name"]] = {"copies": int(len(lens)), "share": float(lens.sum()) / n}
    rep_len = sum(len(p) for p in pieces)
    if rep_len >= n:
        raise ValueError(f"repeats fill {rep_len} of {n} bases")
    bg = rng.integers(0, 4, n - rep_len, dtype=np.uint8)
    order = rng.permutation(len(pieces))
    cuts = np.sort(rng.integers(0, len(bg) + 1, len(pieces)))
    out, prev = [], 0
    for cut, i in zip(cuts, order):
        out += [bg[prev:cut], pieces[i]]
        prev = cut
    out.append(bg[prev:])
    return np.concatenate(out), info


def write_fasta(path: str, name: str, codes: np.ndarray, width: int = 80) -> None:
    """One-record FASTA of the codes, `width` bases a line."""
    seq = ASCII[codes]
    n = len(seq)
    full = n // width
    with open(path, "wb") as f:
        f.write(b">" + name.encode() + b"\n")
        if full:
            lines = np.concatenate(
                [seq[: full * width].reshape(full, width),
                 np.full((full, 1), ord("\n"), np.uint8)], axis=1)
            f.write(lines.tobytes())
        if n % width:
            f.write(seq[full * width:].tobytes() + b"\n")
