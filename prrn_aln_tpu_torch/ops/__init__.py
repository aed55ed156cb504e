"""Compute kernels: banded wavefront DP (plain PyTorch versions and
the CUDA kernels that replace the Pallas ones) and profile ops."""
