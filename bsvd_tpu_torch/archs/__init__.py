"""Arch registry of the port: importing this package registers the WNet
wrappers (BSVD, TSN, BufferConv), the zoo's SR nets, VGG feature
extractor and discriminators, and its recurrent video SR (SpyNet,
BasicVSR) in ARCH_REGISTRY."""

import torch

from bsvd_tpu_torch.archs import (basicvsr_arch,  # noqa: F401
                                  discriminator_arch, spynet_arch, sr_archs,
                                  vgg_arch, wnet_arch)
from bsvd_tpu_torch.utils.registry import ARCH_REGISTRY


def build_network(opt, device='cuda'):
    """Instantiate a registered arch from an options dict
    ({'type': Name, ...}; no yaml involved) on ``device``: the card unless
    the caller asks for the CPU (``device='cpu'``). Raises where there is
    no CUDA device; it never falls back to the CPU."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError("build_network: no CUDA device; pass "
                           "device='cpu' to build the network on the CPU")
    opt = dict(opt)
    return ARCH_REGISTRY.get(opt.pop('type'))(**opt).to(device)
