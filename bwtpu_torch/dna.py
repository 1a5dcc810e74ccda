# Copy of bwtpu/dna.py for the port; only its imports differ (tests/test_torch_hostcopy.py).
"""DNA encoding utilities shared by the golden model and the engine.

Pinned conventions (SURVEY.md §7.6 item 3 "convention parity"):

- Alphabet order: ``$ < A < C < G < T``. Bases are 2-bit codes
  A=0, C=1, G=2, T=3. The sentinel ``$`` is out-of-band (code 4 /
  "dollar" handled separately by index structures).
- Non-ACGT characters in the *genome* are replaced by ``A``
  deterministically at load time (`sanitize_genome`).
- Non-ACGT characters in *reads* never match any reference base: they
  are encoded as A plus an "ambiguous" mask bit, and every consumer
  (search, verify, golden brute force) treats masked positions as
  guaranteed mismatches.
- Reverse complement of a 2-bit code is ``3 - code``.
"""

from __future__ import annotations

import numpy as np

BASES = "ACGT"
A, C, G, T = 0, 1, 2, 3

_ENC = np.full(256, 0, dtype=np.uint8)
for _i, _b in enumerate(BASES):
    _ENC[ord(_b)] = _i
    _ENC[ord(_b.lower())] = _i

_IS_ACGT = np.zeros(256, dtype=bool)
for _b in BASES:
    _IS_ACGT[ord(_b)] = True
    _IS_ACGT[ord(_b.lower())] = True

_DEC = np.frombuffer(b"ACGT", dtype=np.uint8)


def encode(seq: str) -> np.ndarray:
    """Encode an ACGT string to uint8 codes. Non-ACGT become A (0)."""
    raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    return _ENC[raw]


def encode_with_mask(seq: str) -> tuple[np.ndarray, np.ndarray]:
    """Encode a read; return (codes uint8, ambiguous-mask bool).

    Mask is True where the character is not ACGT (e.g. N); such
    positions never match any reference base.
    """
    raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    return _ENC[raw], ~_IS_ACGT[raw]


def decode(codes: np.ndarray) -> str:
    """Decode uint8 codes back to an ACGT string."""
    return _DEC[np.asarray(codes, dtype=np.uint8)].tobytes().decode("ascii")


def sanitize_genome(seq: str) -> str:
    """Pinned convention: replace every non-ACGT genome char with 'A'.

    Uppercases as a side effect. The golden model and the engine index
    builder both call this, so parity holds by construction.
    """
    raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    return decode(_ENC[raw])


def revcomp_codes(
    codes: np.ndarray, mask: np.ndarray | None = None
) -> tuple[np.ndarray, np.ndarray | None]:
    """Reverse complement in code space (3 - code), mask reversed too."""
    rc = (3 - codes[::-1]).astype(codes.dtype)
    if mask is None:
        return rc, None
    return rc, mask[::-1]


def revcomp_str(seq: str) -> str:
    comp = {"A": "T", "C": "G", "G": "C", "T": "A", "N": "N"}
    return "".join(comp.get(ch, "N") for ch in reversed(seq.upper()))
