"""Seed partition (copy of bwtpu/kernels/verify.py::seed_layout, which
lives in a jax-importing module; tests hold the copy equal)."""

from __future__ import annotations


def seed_layout(read_len: int, n_seeds: int) -> list[tuple[int, int]]:
    """Static (offset, length) split of a read into n_seeds seeds:
    near-equal, remainder to the leftmost seeds."""
    q, r = divmod(read_len, n_seeds)
    out = []
    off = 0
    for s in range(n_seeds):
        length = q + (1 if s < r else 0)
        out.append((off, length))
        off += length
    return out
