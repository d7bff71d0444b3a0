"""LPIPS perceptual distance on VGG16 (counterpart of
bsvd_tpu/metrics/lpips.py; the ``lpips`` package's ``LPIPS(net='vgg')``).

ScalingLayer -> VGG16 features at relu1_2, relu2_2, relu3_3, relu4_3 and
relu5_3 (the port's ``VGGFeatureExtractor``, no ImageNet normalisation)
-> unit-normalise each feature over its channels -> squared difference
-> a non-negative 1x1 head per layer -> spatial mean -> sum over layers.
The heads are clamped at 0 when applied (the package clamps them at load;
random heads stay non-negative this way too). NCHW RGB in [-1, 1].

The weights are not in the repository: ``BSVD_LPIPS_PRETRAIN_PATH`` names
the lpips package's ``vgg.pth`` (the heads, ``lin<i>.model.1.weight``) and
``BSVD_VGG16_PRETRAIN_PATH`` torchvision's ``vgg16-397923af.pth`` (both
read at import, as in the JAX package); ``load_lpips`` raises
FileNotFoundError naming the missing one. ``LPIPS(seed=...)`` has random
weights.
"""

import os

import torch
from torch import nn

from bsvd_tpu_torch.archs.vgg_arch import (VGGFeatureExtractor,
                                           convert_torchvision_vgg,
                                           read_torchvision_vgg)

LPIPS_PRETRAIN_PATH = os.environ.get(
    'BSVD_LPIPS_PRETRAIN_PATH', 'experiments/pretrained_models/lpips_vgg.pth')
VGG16_PRETRAIN_PATH = os.environ.get(
    'BSVD_VGG16_PRETRAIN_PATH',
    'experiments/pretrained_models/vgg16-397923af.pth')

LAYERS = ('relu1_2', 'relu2_2', 'relu3_3', 'relu4_3', 'relu5_3')
CHNS = (64, 128, 256, 512, 512)
# the lpips package's ScalingLayer constants ([-1, 1] input domain)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def _unit_normalize(x, eps=1e-10):
    return x / (torch.sqrt(torch.sum(x * x, dim=1, keepdim=True)) + eps)


class LPIPS(nn.Module):
    """(x0, x1) NCHW RGB in [-1, 1] -> the (N,) LPIPS distances. Random
    weights from ``seed``: the VGG16's (kaiming), heads uniform in
    [0, 0.1)."""

    def __init__(self, seed=0):
        super().__init__()
        self.vgg = VGGFeatureExtractor(list(LAYERS), 'vgg16',
                                       use_input_norm=False, seed=seed,
                                       pretrain_path=False)
        gen = torch.Generator().manual_seed(int(seed) + 1)
        self.lins = nn.ParameterList([
            nn.Parameter(torch.rand((1, c, 1, 1), generator=gen) * 0.1,
                         requires_grad=False) for c in CHNS])
        self.register_buffer('shift', torch.tensor(_SHIFT).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer('scale', torch.tensor(_SCALE).view(1, 3, 1, 1),
                             persistent=False)

    def forward(self, x0, x1):
        feats = [self.vgg((x - self.shift) / self.scale) for x in (x0, x1)]
        dists = None
        for layer, lin in zip(LAYERS, self.lins):
            d = (_unit_normalize(feats[0][layer])
                 - _unit_normalize(feats[1][layer])) ** 2
            val = (d * lin.clamp(min=0)).sum(dim=1).mean(dim=(1, 2))
            dists = val if dists is None else dists + val
        return dists


def load_lpips(pretrain_path=None, vgg_path=None, device='cuda'):
    """LPIPS with the external weights (see the module docstring) on
    ``device``, in eval mode; FileNotFoundError where a file is absent."""
    lin_path = pretrain_path or LPIPS_PRETRAIN_PATH
    backbone = vgg_path or VGG16_PRETRAIN_PATH
    for p, what in ((lin_path, 'lpips vgg.pth'), (backbone,
                                                  'vgg16-397923af.pth')):
        if not os.path.exists(p):
            raise FileNotFoundError(
                f'{what} not found at {p}; set BSVD_LPIPS_PRETRAIN_PATH / '
                'BSVD_VGG16_PRETRAIN_PATH (no bundled weights, no egress)')
    net = LPIPS()
    net.vgg.load_state_dict(convert_torchvision_vgg(
        read_torchvision_vgg(backbone), 'vgg16'), strict=False)
    lin_state = torch.load(lin_path, map_location='cpu', weights_only=True)
    with torch.no_grad():
        for i, lin in enumerate(net.lins):
            lin.copy_(torch.as_tensor(lin_state[f'lin{i}.model.1.weight']))
    return net.to(device).eval()
