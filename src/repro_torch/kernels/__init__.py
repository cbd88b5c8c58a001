"""Kernels of the port: hand-written CUDA for Hopper, each beside its plain
PyTorch version (the CPU path and the reference the kernel is held to)."""
