"""Discriminators of GAN training (counterpart of bsvd_tpu/archs/
discriminator_arch.py): ``VGGStyleDiscriminator128`` / ``256`` with
BatchNorm and ``UNetDiscriminatorSN`` with spectral norm, under BasicSR's
parameter names (``conv0_0``, ``bn0_1``, ``linear1``; ``conv1.weight_orig``
/ ``weight_u`` / ``weight_v``).

Their state follows the JAX package, not torch's defaults:

- BatchNorm in train mode normalises by the batch's biased statistics and
  does not touch its running ones; the forward returns the (mean, var)
  pairs, and ``bn_update_running`` folds them in afterwards (momentum 0.1;
  the variance stays biased unless the count is given), as the JAX GAN
  step does after the D update. Eval mode uses the running statistics.
- Spectral norm is the port's own power iteration on a persistent ``u``
  (one step per forward, in every mode, as the JAX apply does);
  ``forward_stats`` returns the new vectors and ``update_state`` stores
  them. ``torch.nn.utils.spectral_norm`` keeps its state differently and
  runs its iteration only in train mode.

Each net's ``forward_stats(x, train)`` gives (output, state of this
forward); ``update_state`` folds that state in (the JAX GAN step's
``_d_aux_update``).
"""

import torch
import torch.nn.functional as F
from torch import nn

from bsvd_tpu_torch.archs.sr_archs import _Init
from bsvd_tpu_torch.utils.registry import ARCH_REGISTRY

BN_EPS = 1e-5


def lrelu2(x):
    return F.leaky_relu(x, 0.2)


def bn_apply(bn, x, train):
    """(y, (batch mean, biased batch var) or None) of a BatchNorm2d's
    affine normalisation; train mode uses the batch's statistics."""
    if train:
        mean = x.mean(dim=(0, 2, 3))
        var = x.var(dim=(0, 2, 3), unbiased=False)
        stats = (mean, var)
    else:
        mean, var, stats = bn.running_mean, bn.running_var, None
    y = (x - mean.view(1, -1, 1, 1)) * torch.rsqrt(var.view(1, -1, 1, 1)
                                                   + BN_EPS)
    return y * bn.weight.view(1, -1, 1, 1) + bn.bias.view(1, -1, 1, 1), stats


@torch.no_grad()
def bn_update_running(bn, stats, momentum=0.1, n=None):
    """running = (1 - momentum) * running + momentum * batch, in place;
    the variance made unbiased only when the count ``n`` is given (the JAX
    GAN step gives none)."""
    mean, var = (s.detach() for s in stats)
    if n is not None and n > 1:
        var = var * n / (n - 1)
    bn.running_mean.copy_((1 - momentum) * bn.running_mean + momentum * mean)
    bn.running_var.copy_((1 - momentum) * bn.running_var + momentum * var)


_VGG_D_LAYERS = [
    # (name, cin multiple or 'in', cout multiple, kernel, stride, bias, bn)
    ('conv0_0', 'in', 1, 3, 1, True, False),
    ('conv0_1', 1, 1, 4, 2, False, True),
    ('conv1_0', 1, 2, 3, 1, False, True),
    ('conv1_1', 2, 2, 4, 2, False, True),
    ('conv2_0', 2, 4, 3, 1, False, True),
    ('conv2_1', 4, 4, 4, 2, False, True),
    ('conv3_0', 4, 8, 3, 1, False, True),
    ('conv3_1', 8, 8, 4, 2, False, True),
    ('conv4_0', 8, 8, 3, 1, False, True),
    ('conv4_1', 8, 8, 4, 2, False, True),
]
_EXTRA_256 = [
    ('conv5_0', 8, 8, 3, 1, False, True),
    ('conv5_1', 8, 8, 4, 2, False, True),
]


@ARCH_REGISTRY.register()
class VGGStyleDiscriminator128(nn.Module):
    """VGG-style discriminator of 128 x 128 inputs -> (N, 1) logits."""

    input_size = 128

    def __init__(self, num_in_ch=3, num_feat=64, seed=0):
        super().__init__()
        self.layers = _VGG_D_LAYERS + (_EXTRA_256 if self.input_size == 256
                                       else [])
        for name, cin_m, cout_m, k, s, bias, bn in self.layers:
            cin = num_in_ch if cin_m == 'in' else num_feat * cin_m
            setattr(self, name, nn.Conv2d(cin, num_feat * cout_m, k, s, 1,
                                          bias=bias))
            if bn:
                setattr(self, 'bn' + name[4:],
                        nn.BatchNorm2d(num_feat * cout_m, affine=True))
        self.linear1 = nn.Linear(num_feat * 8 * 4 * 4, 100)
        self.linear2 = nn.Linear(100, 1)
        init = _Init(seed)
        for name, *_ in self.layers:
            init.kaiming(getattr(self, name))
        for lin in (self.linear1, self.linear2):
            bound = 1 / lin.in_features ** 0.5
            init.uniform(lin.weight, bound)
            init.uniform(lin.bias, bound)

    def forward_stats(self, x, train=False):
        """(logits, {bn name: (mean, var)}) with BN on the batch's
        statistics when ``train``, else on the running ones (``forward``,
        as the JAX wrapper's call)."""
        if x.shape[2] != self.input_size or x.shape[3] != self.input_size:
            raise ValueError(f'Input spatial size must be {self.input_size}x'
                             f'{self.input_size}, got {tuple(x.shape)}')
        stats, feat = {}, x
        for name, *_, bn in self.layers:
            feat = getattr(self, name)(feat)
            if bn:
                bn_name = 'bn' + name[4:]
                feat, st = bn_apply(getattr(self, bn_name), feat, train)
                if st is not None:
                    stats[bn_name] = st
            feat = lrelu2(feat)
        feat = lrelu2(self.linear1(feat.flatten(1)))   # (C, H, W) order
        return self.linear2(feat), stats

    def forward(self, x):
        return self.forward_stats(x)[0]

    def update_state(self, stats):
        """Fold a train-mode forward's batch statistics into the running
        ones (the JAX GAN step's ``_d_aux_update``)."""
        for name, st in stats.items():
            bn_update_running(getattr(self, name), st)


@ARCH_REGISTRY.register()
class VGGStyleDiscriminator256(VGGStyleDiscriminator128):
    input_size = 256


class SNConv2d(nn.Module):
    """A conv whose weight is divided by its largest singular value,
    estimated by one power-iteration step from the persistent ``weight_u``
    (``weight_orig`` is the raw weight, as torch's spectral_norm stores
    it; ``weight_v`` is kept for its state dict and never read)."""

    def __init__(self, cin, cout, k, stride=1, padding=1, bias=False):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight_orig = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.register_buffer('weight_u', torch.zeros(cout))
        self.register_buffer('weight_v', torch.zeros(cin * k * k))

    def forward_u(self, x):
        """(y, (u, v)): the conv by the normalised weight, and the power
        iteration's new vectors (not stored)."""
        w = self.weight_orig
        # the JAX layout's (cout, cin*k*k) matrix: HWIO reshaped, transposed
        mat = w.permute(0, 2, 3, 1).reshape(w.shape[0], -1)
        with torch.no_grad():
            v = mat.t() @ self.weight_u
            v = v / (torch.linalg.vector_norm(v) + 1e-12)
            u = mat @ v
            u = u / (torch.linalg.vector_norm(u) + 1e-12)
        y = F.conv2d(x, w / (u @ mat @ v), self.bias, self.stride,
                     self.padding)
        return y, (u, v)

    def forward(self, x):
        return self.forward_u(x)[0]

    @torch.no_grad()
    def store(self, uv):
        self.weight_u.copy_(uv[0])
        self.weight_v.copy_(uv[1])


@ARCH_REGISTRY.register()
class UNetDiscriminatorSN(nn.Module):
    """U-Net discriminator with spectral norm -> (N, 1, H, W) logits."""

    def __init__(self, num_in_ch=3, num_feat=64, skip_connection=True,
                 seed=0):
        super().__init__()
        self.skip_connection = skip_connection
        f = num_feat
        self.conv0 = nn.Conv2d(num_in_ch, f, 3, 1, 1)
        self.conv1 = SNConv2d(f, f * 2, 4, 2)
        self.conv2 = SNConv2d(f * 2, f * 4, 4, 2)
        self.conv3 = SNConv2d(f * 4, f * 8, 4, 2)
        self.conv4 = SNConv2d(f * 8, f * 4, 3)
        self.conv5 = SNConv2d(f * 4, f * 2, 3)
        self.conv6 = SNConv2d(f * 2, f, 3)
        self.conv7 = SNConv2d(f, f, 3)
        self.conv8 = SNConv2d(f, f, 3)
        self.conv9 = nn.Conv2d(f, 1, 3, 1, 1)
        init = _Init(seed)
        for m in self.children():
            init.kaiming(m)
            if isinstance(m, SNConv2d):
                with torch.no_grad():
                    m.weight_u.copy_(torch.randn(m.weight_u.shape,
                                                 generator=init.gen))

    def forward_stats(self, x, train=False):
        """(logits, {conv name: (u, v)}): the power iteration's vectors of
        this forward (in either mode), stored by ``update_state``."""
        del train
        us = {}

        def sn(name, h):
            y, us[name] = getattr(self, name).forward_u(h)
            return lrelu2(y)

        def up(h):
            return F.interpolate(h, scale_factor=2, mode='bilinear',
                                 align_corners=False)

        x0 = lrelu2(self.conv0(x))
        x1 = sn('conv1', x0)
        x2 = sn('conv2', x1)
        x3 = sn('conv3', x2)
        x4 = sn('conv4', up(x3))
        if self.skip_connection:
            x4 = x4 + x2
        x5 = sn('conv5', up(x4))
        if self.skip_connection:
            x5 = x5 + x1
        x6 = sn('conv6', up(x5))
        if self.skip_connection:
            x6 = x6 + x0
        out = sn('conv8', sn('conv7', x6))
        return self.conv9(out), us

    def forward(self, x):
        return self.forward_stats(x)[0]

    def update_state(self, us):
        """Store a forward's power-iteration vectors."""
        for name, uv in us.items():
            getattr(self, name).store(uv)
