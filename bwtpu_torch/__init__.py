"""bwtpu_torch — the bwtpu FM-index aligner on PyTorch and CUDA.

The second package beside `bwtpu` (the JAX reference). It reads the
same index artifact and writes the same hit lists and SAM bytes. Module
names mirror `bwtpu` so each counterpart is easy to find:

  engine.py          device pipelines + host orchestration (Engine)
  cli.py             python -m bwtpu_torch.cli build-index | align
  kernels/           plain-torch device code; locate.py, verify2.py,
                     search2.py and gather.py also hold the hand-written
                     CUDA kernels' wrappers
  csrc/              the CUDA C++ kernels (sm_90a), built at first use
  config, dna, io, index, sais, results, readblock, sam, samfast,
  hosttune, simulate, golden (Hit, sort_hits, select_primary,
  suffix_array)      the host layer: copies of bwtpu's modules of the
                     same names, only their imports differ (sais.py
                     builds csrc/host/*.cc with g++ at first use); the
                     index artifact and SAM bytes are bwtpu's

Importing this package imports torch and numpy only: no jax, nothing of
bwtpu, no build.
"""
