"""Kernels of the port: each a hand-written Hopper kernel with its plain
PyTorch version beside it (used for tensors on the CPU)."""
