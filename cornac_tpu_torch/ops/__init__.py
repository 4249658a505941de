"""Device operations: the hand-written CUDA kernels and their wrappers."""
