"""DUF, video SR with dynamic upsampling filters, as an ``nn.Module``
(counterpart of bsvd_tpu/archs/duf_arch.py, BasicSR's duf_arch): 3D convs
with dense blocks over a 7-frame window, three temporal reductions to one
frame, then a residual and a 5 x 5 filter for each output sub-pixel,
softmaxed over its 25 taps and applied to the centre frame
(``dynamic_upsampling_filter``, torch's channel order: channel ``c *
scale^2 + u``), and a pixel shuffle.

BasicSR's names (``conv3d1``, ``dense_block1.dense_blocks.<i>.<0, 2, 3,
5>``, ``dense_block2.temporal_reduce1``, ``bn3d2``, ``conv3d_r1``,
``conv3d_f2``, ...), so a BasicSR ``.pth`` loads with ``load_state_dict``.
The JAX package's tree (``convert_duf_state``) is not the generic one:
conv weights DHWIO / HWIO under ``w``, BatchNorm leaves ``w``, ``b``,
``running_mean``, ``running_var``; ``tree_from_state`` /
``state_from_tree`` carry it (``convert.torch_generic`` uses them), for
TOFlow too. BatchNorm always normalises by its running statistics, as the
JAX package's does.

Plain PyTorch (``F.conv3d``, ``F.unfold``, ``torch.matmul``): the JAX
package computes DUF in XLA, outside any Pallas kernel.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from bsvd_tpu_torch.utils.registry import ARCH_REGISTRY

_LAYERS = {16: (3, 32), 28: (9, 16), 52: (21, 16)}


class EvalBN(nn.BatchNorm2d):
    """BatchNorm on its running statistics in every mode, on inputs of
    any rank (N, C, ...)."""

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)


def tree_from_state(state):
    """A BasicSR DUF / TOFlow state dict -> the JAX package's tree
    (``convert_duf_state``; 4D conv weights HWIO as TOFlow's load makes
    them); ``num_batches_tracked`` dropped."""
    tree = {}
    for key, val in state.items():
        key = key[len('module.'):] if key.startswith('module.') else key
        if key.endswith('num_batches_tracked'):
            continue
        v = (val.detach().cpu().numpy() if isinstance(val, torch.Tensor)
             else np.asarray(val))
        *path, leaf = key.split('.')
        if leaf == 'weight':
            leaf = 'w'
            if v.ndim == 5:
                v = np.transpose(v, (2, 3, 4, 1, 0))
            elif v.ndim == 4:
                v = np.transpose(v, (2, 3, 1, 0))
        elif leaf == 'bias':
            leaf = 'b'
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v.astype(np.float32)
    return tree


def state_from_tree(tree, prefix=''):
    """The inverse of ``tree_from_state``, a BatchNorm's
    ``num_batches_tracked`` put back as 0."""
    state = {}
    leaves = {k: np.asarray(v) for k, v in tree.items()
              if not isinstance(v, dict)}
    for k, v in leaves.items():
        if k == 'w':
            if v.ndim == 5:
                v = np.transpose(v, (4, 3, 0, 1, 2))
            elif v.ndim == 4:
                v = np.transpose(v, (3, 2, 0, 1))
            k = 'weight'
        elif k == 'b':
            k = 'bias'
        state[prefix + k] = v
    if 'running_mean' in leaves:
        state[prefix + 'num_batches_tracked'] = np.zeros((), np.float32)
    for k, v in tree.items():
        if isinstance(v, dict):
            state.update(state_from_tree(v, f'{prefix}{k}.'))
    return state


def _conv3d(cin, cout, ksize, padding):
    return nn.Conv3d(cin, cout, ksize, 1, padding, bias=True)


def _dense_unit(cin, cout, pad_t, eps):
    """BN, ReLU, 1x1x1 conv, BN, ReLU, 3x3x3 conv (indices 0, 2, 3, 5)."""
    return nn.Sequential(EvalBN(cin, eps), nn.ReLU(),
                         _conv3d(cin, cin, 1, 0), EvalBN(cin, eps),
                         nn.ReLU(), _conv3d(cin, cout, 3, (pad_t, 1, 1)))


class DenseBlocks(nn.Module):
    """``num_block`` dense units, each output concatenated to its input."""

    def __init__(self, num_block, num_feat=64, num_grow_ch=16, eps=1e-5):
        super().__init__()
        self.dense_blocks = nn.ModuleList(
            _dense_unit(num_feat + i * num_grow_ch, num_grow_ch, 1, eps)
            for i in range(num_block))

    def forward(self, x):
        for block in self.dense_blocks:
            x = torch.cat([x, block(x)], 1)
        return x


class DenseBlocksTemporalReduce(nn.Module):
    """Three units without temporal padding, each dropping the first and
    last frame of its input before the concatenation."""

    def __init__(self, num_feat=64, num_grow_ch=32, eps=1e-5):
        super().__init__()
        for i in range(3):
            setattr(self, f'temporal_reduce{i + 1}', _dense_unit(
                num_feat + i * num_grow_ch, num_grow_ch, 0, eps))

    def forward(self, x):
        for i in range(3):
            z = getattr(self, f'temporal_reduce{i + 1}')(x)
            x = torch.cat([x[:, :, 1:-1], z], 1)
        return x


def dynamic_upsampling_filter(x, filters, filter_size=(5, 5)):
    """``x`` (N, C, H, W) filtered per pixel by ``filters`` (N, kh*kw,
    up^2, H, W), softmaxed over the taps -> (N, C*up^2, H, W), channel
    ``c * up^2 + u`` (BasicSR's expansion-filter order: tap (i, j) of
    channel c is column c*kh*kw + i*kw + j)."""
    kh, kw = filter_size
    n, c, h, w = x.shape
    cols = F.unfold(x, (kh, kw), padding=(kh // 2, kw // 2))
    cols = cols.view(n, c, kh * kw, h, w).permute(0, 3, 4, 1, 2)
    out = torch.matmul(cols, filters.permute(0, 3, 4, 1, 2))  # (N,H,W,C,U)
    return out.permute(0, 3, 4, 1, 2).reshape(n, -1, h, w)


@ARCH_REGISTRY.register()
class DUF(nn.Module):
    """(N, 7, 3, H, W) frames -> (N, 3, H*scale, W*scale), the centre
    frame; ``num_layer`` 16, 28 or 52; ``adapt_official_weights`` sets
    BatchNorm's eps to the official weights' 1e-3."""

    def __init__(self, scale=4, num_layer=52, adapt_official_weights=False,
                 seed=0):
        super().__init__()
        if num_layer not in _LAYERS:
            raise ValueError(f'Only (16, 28, 52) layers supported, got '
                             f'{num_layer}.')
        self.scale = scale
        eps = 1e-3 if adapt_official_weights else 1e-5
        num_block, num_grow_ch = _LAYERS[num_layer]
        nf = 64 + num_grow_ch * num_block
        self.conv3d1 = _conv3d(3, 64, (1, 3, 3), (0, 1, 1))
        self.dense_block1 = DenseBlocks(num_block, 64, num_grow_ch, eps)
        self.dense_block2 = DenseBlocksTemporalReduce(nf, num_grow_ch, eps)
        nf += 3 * num_grow_ch
        self.bn3d2 = EvalBN(nf, eps)
        self.conv3d2 = _conv3d(nf, 256, (1, 3, 3), (0, 1, 1))
        self.conv3d_r1 = _conv3d(256, 256, 1, 0)
        self.conv3d_r2 = _conv3d(256, 3 * scale ** 2, 1, 0)
        self.conv3d_f1 = _conv3d(256, 512, 1, 0)
        self.conv3d_f2 = _conv3d(512, 25 * scale ** 2, 1, 0)
        gen = torch.Generator().manual_seed(int(seed))
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Conv3d):
                    bound = 1 / math.sqrt(m.weight[0].numel())
                    for t in (m.weight, m.bias):
                        t.copy_((torch.rand(t.shape, generator=gen) * 2 - 1)
                                * bound)

    tree_from_state = staticmethod(tree_from_state)
    state_from_tree = staticmethod(state_from_tree)

    def load(self, path, param_key='params'):
        from bsvd_tpu_torch.convert.torch_generic import load_torch_generic
        return load_torch_generic(path, self, param_key)

    def forward(self, x):
        n, t, _, h, w = x.shape
        x = x.permute(0, 2, 1, 3, 4)                  # (N, C, T, H, W)
        x_center = x[:, :, t // 2]
        x = self.dense_block2(self.dense_block1(self.conv3d1(x)))
        x = F.relu(self.conv3d2(F.relu(self.bn3d2(x))))
        res = self.conv3d_r2(F.relu(self.conv3d_r1(x)))
        filt = self.conv3d_f2(F.relu(self.conv3d_f1(x)))
        filt = F.softmax(filt.view(n, 25, self.scale ** 2, h, w), dim=1)
        out = dynamic_upsampling_filter(x_center, filt) + res[:, :, 0]
        return F.pixel_shuffle(out, self.scale)
