"""Hand-written CUDA kernels for Hopper (``csrc/``), the build step, their
wrappers and their plain PyTorch versions."""
