"""setup_s: seconds from the start of the run's process until the window
opens (CUDA, kernel libraries, index load and upload, the pool, warm-up)."""


def read(w):
    return w.setup_s
