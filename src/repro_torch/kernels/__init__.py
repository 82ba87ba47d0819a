"""Kernel backends: plain PyTorch versions and hand-written CUDA kernels."""
