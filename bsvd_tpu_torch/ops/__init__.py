"""Kernel entry points of the port: each wraps a CUDA kernel (csrc/) and
its plain PyTorch version. ``stylegan_ops`` is the exception: StyleGAN2's
filters in plain PyTorch, as the JAX package has them in XLA."""
