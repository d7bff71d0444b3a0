"""The JAX repo's ``scripts/`` as ``python -m bsvd_tpu_torch.scripts.<folder>.<name>``."""
