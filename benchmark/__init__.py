"""The benchmark of bwtpu_torch: one command runs one cell once (run.py)."""
