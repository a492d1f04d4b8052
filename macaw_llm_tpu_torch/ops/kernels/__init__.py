"""Hand-written CUDA kernels (``csrc/``) and their PyTorch wrappers.

Each wrapper launches its kernel for CUDA tensors and counts the launch in
its ``launches`` attribute; for CPU tensors it computes the plain PyTorch
version that stands beside it. Nothing is compiled at import time.
"""
