"""bwtpu_torch — the bwtpu FM-index aligner on PyTorch and CUDA.

The second package beside `bwtpu` (the JAX reference). It reads the
same index artifact and writes the same hit lists and SAM bytes; the
host layer (`bwtpu.config`, `dna`, `io`, `golden`, `index`, `sais`,
`readblock`, `results`, `sam`, `samfast`, `simulate`) is shared, never
copied. Module names mirror `bwtpu` so each counterpart is easy to find:

  engine.py          device pipelines + host orchestration (Engine)
  cli.py             python -m bwtpu_torch.cli build-index | align
  kernels/           plain-torch device code; locate.py, verify2.py and
                     search2.py also hold the hand-written CUDA kernels'
                     wrappers
  csrc/              the CUDA C++ kernels (sm_90a), built at first use

Importing this package imports torch only: no jax, no kernel build.
"""
