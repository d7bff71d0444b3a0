"""Arch registry of the port: importing this package registers the WNet
wrappers (BSVD, TSN, BufferConv) in ARCH_REGISTRY."""

from bsvd_tpu_torch.archs import wnet_arch  # noqa: F401  registers archs
from bsvd_tpu_torch.utils.registry import ARCH_REGISTRY


def build_network(opt):
    """Instantiate a registered arch from an options dict
    ({'type': Name, ...}); no yaml involved."""
    opt = dict(opt)
    return ARCH_REGISTRY.get(opt.pop('type'))(**opt)
