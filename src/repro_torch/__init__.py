"""PyTorch/CUDA port of the Tsetlin Machine online-learning system.

A second package beside the JAX reference (``repro``), laid out module for
module like it. It imports torch and numpy only. The kernels on the main
path are hand-written CUDA for Hopper (``kernels/csrc``), built at first
use; their plain PyTorch versions run on CPU tensors.
"""
