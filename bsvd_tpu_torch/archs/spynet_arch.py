"""SpyNet optical flow as an ``nn.Module`` (counterpart of
bsvd_tpu/archs/spynet_arch.py, BasicSR's spynet_arch): a six-level
coarse-to-fine pyramid, each level a five-conv ``BasicModule`` that adds
its residual to the upsampled flow of the level below. BasicSR's names
(``basic_module.<level>.basic_module.<0, 2, 4, 6, 8>``, the ImageNet
``mean`` / ``std`` buffers), so a BasicSR ``.pth`` loads with
``load_state_dict``; the buffers are constants, not in the JAX package's
tree (``convert.torch_generic`` leaves them out).

Plain PyTorch (``F.conv2d``, ``F.avg_pool2d``, ``F.grid_sample``,
``F.interpolate``): the JAX package computes SpyNet in XLA.

As in the JAX package, the coarsest flow starts at no less than 1 x 1
(``max(h0 // 2, 1)``): BasicSR fails on inputs under 64 px, where its
``h0 // 2`` is 0; elsewhere the two are the same.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from bsvd_tpu_torch.archs.sr_archs import _Init
from bsvd_tpu_torch.nn.warp import flow_warp, interpolate_bilinear
from bsvd_tpu_torch.utils.registry import ARCH_REGISTRY

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
_CHANS = ((8, 32), (32, 64), (64, 32), (32, 16), (16, 2))
LEVELS = 6


class BasicModule(nn.Module):
    """Five 7x7 convs, ReLU between them: (ref, warped supp, flow), 8
    channels -> the flow's residual, 2."""

    def __init__(self):
        super().__init__()
        layers = []
        for i, (cin, cout) in enumerate(_CHANS):
            layers.append(nn.Conv2d(cin, cout, 7, 1, 3))
            if i < len(_CHANS) - 1:
                layers.append(nn.ReLU())
        self.basic_module = nn.Sequential(*layers)

    def forward(self, x):
        return self.basic_module(x)


@ARCH_REGISTRY.register()
class SpyNet(nn.Module):
    """(N, 3, H, W) reference and supporting frames in [0, 1] -> the flow
    (N, 2, H, W), (dx, dy) in pixels, that warps supp onto ref."""

    # buffers that are constants of the arch, not weights of a checkpoint
    CONSTANT_BUFFERS = ('mean', 'std')

    def __init__(self, load_path=None, seed=0):
        super().__init__()
        self.basic_module = nn.ModuleList(BasicModule()
                                          for _ in range(LEVELS))
        self.register_buffer('mean', torch.tensor(MEAN).view(1, 3, 1, 1))
        self.register_buffer('std', torch.tensor(STD).view(1, 3, 1, 1))
        _Init(seed).all_kaiming(self)
        if load_path:
            self.load(load_path)

    def load(self, path, param_key='params'):
        from bsvd_tpu_torch.convert.torch_generic import load_torch_generic
        load_torch_generic(path, self, param_key)
        return self

    def process(self, ref, supp):
        """The pyramid on inputs whose sides are multiples of 32."""
        refs = [(ref - self.mean) / self.std]
        supps = [(supp - self.mean) / self.std]
        for _ in range(LEVELS - 1):
            refs.insert(0, F.avg_pool2d(refs[0], 2, 2))
            supps.insert(0, F.avg_pool2d(supps[0], 2, 2))
        n, _, h0, w0 = refs[0].shape
        flow = refs[0].new_zeros(n, 2, max(h0 // 2, 1), max(w0 // 2, 1))
        for level in range(LEVELS):
            h, w = refs[level].shape[-2:]
            up = interpolate_bilinear(flow, h, w, align_corners=True) * 2.0
            warped = flow_warp(supps[level], up.permute(0, 2, 3, 1),
                               padding_mode='border')
            flow = self.basic_module[level](
                torch.cat([refs[level], warped, up], 1)) + up
        return flow

    def forward(self, ref, supp):
        h, w = ref.shape[-2:]
        h32 = int(math.ceil(h / 32.0) * 32)
        w32 = int(math.ceil(w / 32.0) * 32)
        flow = self.process(interpolate_bilinear(ref, h32, w32),
                            interpolate_bilinear(supp, h32, w32))
        flow = interpolate_bilinear(flow, h, w)
        return flow * flow.new_tensor([w / w32, h / h32]).view(1, 2, 1, 1)
