"""Kernel entry points of the port: each wraps a CUDA kernel (csrc/) and
its plain PyTorch version."""
