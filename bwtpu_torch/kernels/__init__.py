"""Device code of the port: plain-torch functions on tensors, plus the
wrappers of the hand-written CUDA kernels (locate.locate_walk,
verify2.verify_nm). Nothing is imported here, so importing one module
never builds a kernel or pulls in another."""
