"""bsvd_tpu_torch — the PyTorch/CUDA port of bsvd_tpu for NVIDIA Hopper.

The port mirrors ``bsvd_tpu``'s layout (``nn``, ``ops``, ``archs``,
``convert``, ``models``); the JAX package stays the reference it is tested
against. Every Pallas kernel on the ported path is a CUDA C++ kernel for
``sm_90a`` under ``csrc/``, built with ``nvcc`` at first CUDA use
(``ops/_build.py``). Importing any module needs neither ``nvcc`` nor a GPU.
"""

__version__ = '0.1.0'

from bsvd_tpu_torch.utils.registry import ARCH_REGISTRY  # noqa: F401
