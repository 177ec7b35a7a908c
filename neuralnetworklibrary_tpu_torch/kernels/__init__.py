"""Build and load code for the hand-written CUDA kernels in ``csrc/``."""
