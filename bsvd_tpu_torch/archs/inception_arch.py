"""The TF-FID InceptionV3 feature extractor (counterpart of
bsvd_tpu/archs/inception_arch.py): torchvision's InceptionV3 with the
TF-FID patches, average pooling that leaves the padding out of its count
in the A / C / E blocks and max pooling in Mixed_7c's pool branch.

The module is NCHW and keeps torchvision's names (``Conv2d_1a_3x3.conv``,
``Mixed_5b.branch5x5_1.bn``, ...), built from the JAX package's layer
tables (``_STEM``, ``_a_table`` ... ``_e_table``, ``_MIXED``). Each conv is
a BasicConv2d: a bias-free conv, BN on its running statistics with eps
1e-3 (explicit, as JAX computes it), ReLU. Every op is plain PyTorch on
the caller's device (XLA convs in the JAX package, no Pallas kernel).

Pretrained TF-FID weights are not in the repository:
``BSVD_INCEPTION_PRETRAIN_PATH`` (read at import, as the JAX package reads
it) or ``pretrain_path`` names ``pt_inception-2015-12-05-6726825d.pth``,
which ``load_torch_inception`` reads (FileNotFoundError where it is
absent). Random weights (``seed``) keep the whole path testable.

``resize_bilinear`` is the bilinear resize the port shares (DFDNet's
too): two interpolation matmuls with torch's align_corners=False rule,
the matrices cached per (size in, size out, device).
"""

import functools
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from bsvd_tpu_torch.archs.hifacegan_arch import avg_pool_excl
from bsvd_tpu_torch.utils.registry import ARCH_REGISTRY

INCEPTION_PRETRAIN_PATH = os.environ.get(
    'BSVD_INCEPTION_PRETRAIN_PATH',
    'experiments/pretrained_models/pt_inception-2015-12-05-6726825d.pth')

_BN_EPS = 1e-3  # torchvision BasicConv2d uses BatchNorm2d(eps=0.001)

# (name, in_ch, out_ch, (kh, kw), stride, (ph, pw)) for the stem convs
_STEM = [
    ('Conv2d_1a_3x3', 3, 32, (3, 3), 2, (0, 0)),
    ('Conv2d_2a_3x3', 32, 32, (3, 3), 1, (0, 0)),
    ('Conv2d_2b_3x3', 32, 64, (3, 3), 1, (1, 1)),
    ('Conv2d_3b_1x1', 64, 80, (1, 1), 1, (0, 0)),
    ('Conv2d_4a_3x3', 80, 192, (3, 3), 1, (0, 0)),
]


# branch conv tables per mixed block: name -> (in, out, (kh,kw), stride, pad)
def _a_table(cin, pool_features):
    return {
        'branch1x1': (cin, 64, (1, 1), 1, (0, 0)),
        'branch5x5_1': (cin, 48, (1, 1), 1, (0, 0)),
        'branch5x5_2': (48, 64, (5, 5), 1, (2, 2)),
        'branch3x3dbl_1': (cin, 64, (1, 1), 1, (0, 0)),
        'branch3x3dbl_2': (64, 96, (3, 3), 1, (1, 1)),
        'branch3x3dbl_3': (96, 96, (3, 3), 1, (1, 1)),
        'branch_pool': (cin, pool_features, (1, 1), 1, (0, 0)),
    }


def _b_table(cin):
    return {
        'branch3x3': (cin, 384, (3, 3), 2, (0, 0)),
        'branch3x3dbl_1': (cin, 64, (1, 1), 1, (0, 0)),
        'branch3x3dbl_2': (64, 96, (3, 3), 1, (1, 1)),
        'branch3x3dbl_3': (96, 96, (3, 3), 2, (0, 0)),
    }


def _c_table(cin, c7):
    return {
        'branch1x1': (cin, 192, (1, 1), 1, (0, 0)),
        'branch7x7_1': (cin, c7, (1, 1), 1, (0, 0)),
        'branch7x7_2': (c7, c7, (1, 7), 1, (0, 3)),
        'branch7x7_3': (c7, 192, (7, 1), 1, (3, 0)),
        'branch7x7dbl_1': (cin, c7, (1, 1), 1, (0, 0)),
        'branch7x7dbl_2': (c7, c7, (7, 1), 1, (3, 0)),
        'branch7x7dbl_3': (c7, c7, (1, 7), 1, (0, 3)),
        'branch7x7dbl_4': (c7, c7, (7, 1), 1, (3, 0)),
        'branch7x7dbl_5': (c7, 192, (1, 7), 1, (0, 3)),
        'branch_pool': (cin, 192, (1, 1), 1, (0, 0)),
    }


def _d_table(cin):
    return {
        'branch3x3_1': (cin, 192, (1, 1), 1, (0, 0)),
        'branch3x3_2': (192, 320, (3, 3), 2, (0, 0)),
        'branch7x7x3_1': (cin, 192, (1, 1), 1, (0, 0)),
        'branch7x7x3_2': (192, 192, (1, 7), 1, (0, 3)),
        'branch7x7x3_3': (192, 192, (7, 1), 1, (3, 0)),
        'branch7x7x3_4': (192, 192, (3, 3), 2, (0, 0)),
    }


def _e_table(cin):
    return {
        'branch1x1': (cin, 320, (1, 1), 1, (0, 0)),
        'branch3x3_1': (cin, 384, (1, 1), 1, (0, 0)),
        'branch3x3_2a': (384, 384, (1, 3), 1, (0, 1)),
        'branch3x3_2b': (384, 384, (3, 1), 1, (1, 0)),
        'branch3x3dbl_1': (cin, 448, (1, 1), 1, (0, 0)),
        'branch3x3dbl_2': (448, 384, (3, 3), 1, (1, 1)),
        'branch3x3dbl_3a': (384, 384, (1, 3), 1, (0, 1)),
        'branch3x3dbl_3b': (384, 384, (3, 1), 1, (1, 0)),
        'branch_pool': (cin, 192, (1, 1), 1, (0, 0)),
    }


# Mixed block registry: name -> (kind, conv table)
_MIXED = [
    ('Mixed_5b', 'A', _a_table(192, 32)),
    ('Mixed_5c', 'A', _a_table(256, 64)),
    ('Mixed_5d', 'A', _a_table(288, 64)),
    ('Mixed_6a', 'B', _b_table(288)),
    ('Mixed_6b', 'C', _c_table(768, 128)),
    ('Mixed_6c', 'C', _c_table(768, 160)),
    ('Mixed_6d', 'C', _c_table(768, 160)),
    ('Mixed_6e', 'C', _c_table(768, 192)),
    ('Mixed_7a', 'D', _d_table(768)),
    ('Mixed_7b', 'E', _e_table(1280)),
    ('Mixed_7c', 'E2', _e_table(2048)),
]


# ---------------------------------------------------------------- resize
@functools.lru_cache(maxsize=64)
def _resize_matrix(n_in, n_out, device):
    """(n_out, n_in) bilinear interpolation matrix, torch's
    align_corners=False convention with edge clamping."""
    dst = np.arange(n_out, dtype=np.float64)
    src = np.clip((dst + 0.5) * (n_in / n_out) - 0.5, 0, n_in - 1)
    i0 = np.floor(src).astype(np.int64)
    i1 = np.minimum(i0 + 1, n_in - 1)
    frac = src - i0
    m = np.zeros((n_out, n_in), np.float32)
    m[dst.astype(np.int64), i0] += (1 - frac).astype(np.float32)
    m[dst.astype(np.int64), i1] += frac.astype(np.float32)
    return torch.from_numpy(m).to(device)


def resize_bilinear(x, out_h, out_w):
    """NCHW bilinear resize as two matmuls (align_corners=False)."""
    mh = _resize_matrix(x.shape[2], out_h, x.device).to(x.dtype)
    mw = _resize_matrix(x.shape[3], out_w, x.device).to(x.dtype)
    x = torch.einsum('oh,nchw->ncow', mh, x)
    return torch.einsum('pw,ncow->ncop', mw, x)


# ---------------------------------------------------------------- layers
class BasicConv2d(nn.Module):
    """conv (no bias) + BN (eps 1e-3, running statistics) + ReLU:
    torchvision's BasicConv2d in eval mode."""

    def __init__(self, cin, cout, kernel, stride=1, padding=(0, 0)):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=_BN_EPS)

    def forward(self, x):
        bn = self.bn
        y = self.conv(x)
        inv = torch.rsqrt(bn.running_var + _BN_EPS) * bn.weight
        y = ((y - bn.running_mean[:, None, None]) * inv[:, None, None]
             + bn.bias[:, None, None])
        return F.relu(y)


def _max_pool(x, k=3, s=2, p=0):
    return F.max_pool2d(x, k, s, p)


class Mixed(nn.Module):
    """One mixed block of ``kind`` A-E (E2: Mixed_7c's max-pool branch)
    from its conv table; a conv ``<prefix>_<n>...`` reads the output of
    ``<prefix>_<n-1>``, the other convs the block's input."""

    def __init__(self, kind, table):
        super().__init__()
        self.kind = kind
        self.table = table
        for name, (cin, cout, k, stride, pad) in table.items():
            self.add_module(name, BasicConv2d(cin, cout, k, stride, pad))

    def _branches(self, x):
        outs = {}
        for name in sorted(self.table):
            if name == 'branch_pool':
                continue
            prefix, _, suffix = name.rpartition('_')
            src = None
            if suffix.isdigit() or (suffix and suffix[0].isdigit()):
                prev_idx = int(suffix[0]) - 1
                if prev_idx >= 1:
                    src = outs[f'{prefix}_{prev_idx}']
            outs[name] = getattr(self, name)(x if src is None else src)
        return outs

    def forward(self, x):
        o = self._branches(x)
        if self.kind == 'A':
            pool = self.branch_pool(avg_pool_excl(x, 3, 1, 1))
            parts = [o['branch1x1'], o['branch5x5_2'], o['branch3x3dbl_3'],
                     pool]
        elif self.kind == 'B':
            parts = [o['branch3x3'], o['branch3x3dbl_3'], _max_pool(x)]
        elif self.kind == 'C':
            pool = self.branch_pool(avg_pool_excl(x, 3, 1, 1))
            parts = [o['branch1x1'], o['branch7x7_3'], o['branch7x7dbl_5'],
                     pool]
        elif self.kind == 'D':
            parts = [o['branch3x3_2'], o['branch7x7x3_4'], _max_pool(x)]
        else:
            # Mixed_7c pools by max: the quirk the TF-FID weights bake in
            pooled = (_max_pool(x, 3, 1, 1) if self.kind == 'E2'
                      else avg_pool_excl(x, 3, 1, 1))
            parts = [o['branch1x1'], o['branch3x3_2a'], o['branch3x3_2b'],
                     o['branch3x3dbl_3a'], o['branch3x3dbl_3b'],
                     self.branch_pool(pooled)]
        return torch.cat(parts, 1)


# ---------------------------------------------------------------- the net
@ARCH_REGISTRY.register()
class InceptionV3(nn.Module):
    """Feature maps at ``output_blocks`` (0: pool1, 1: pool2, 2: Mixed_6e,
    3: Mixed_7c averaged to (N, 2048, 1, 1)) of NCHW input in [0, 1]
    (``normalize_input``) or [-1, 1], resized to 299 x 299 first with
    ``resize_input``. Random weights from ``seed``: convs 0.05 x normal,
    BN the identity (the JAX package's ``inception_v3_init`` families)."""

    def __init__(self, output_blocks=(3,), resize_input=True,
                 normalize_input=True, seed=0):
        super().__init__()
        self.output_blocks = sorted(output_blocks)
        self.resize_input = resize_input
        self.normalize_input = normalize_input
        for name, cin, cout, k, stride, pad in _STEM:
            self.add_module(name, BasicConv2d(cin, cout, k, stride, pad))
        for name, kind, table in _MIXED:
            self.add_module(name, Mixed(kind, table))
        gen = torch.Generator().manual_seed(int(seed))
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Conv2d):
                    m.weight.copy_(0.05 * torch.randn(m.weight.shape,
                                                      generator=gen))
        self.eval()

    def forward(self, x):
        blocks = self.output_blocks
        last = max(blocks)
        if self.resize_input:
            x = resize_bilinear(x, 299, 299)
        if self.normalize_input:
            x = 2 * x - 1
        out = []
        for name in ('Conv2d_1a_3x3', 'Conv2d_2a_3x3', 'Conv2d_2b_3x3'):
            x = getattr(self, name)(x)
        x = _max_pool(x)
        if 0 in blocks:
            out.append(x)
        if last >= 1:
            x = _max_pool(self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x)))
            if 1 in blocks:
                out.append(x)
        if last >= 2:
            for name, _, _ in _MIXED[:8]:
                x = getattr(self, name)(x)
            if 2 in blocks:
                out.append(x)
        if last >= 3:
            for name, _, _ in _MIXED[8:]:
                x = getattr(self, name)(x)
            out.append(x.mean(dim=(2, 3), keepdim=True))
        return out


def _module_names():
    yield from (name for name, *_ in _STEM)
    for name, _, table in _MIXED:
        yield from (f'{name}.{b}' for b in table)


def convert_torch_state_dict(state):
    """A ``pt_inception-2015-12-05-6726825d.pth`` (or any fid_inception_v3)
    state dict, tensors or arrays -> this module's state dict of fp32
    tensors: the conv weights and BN vectors by name; ``fc.*`` and
    ``num_batches_tracked`` are dropped (FID never uses them)."""
    out = {}
    for prefix in _module_names():
        for key in ('conv.weight', 'bn.weight', 'bn.bias', 'bn.running_mean',
                    'bn.running_var'):
            out[f'{prefix}.{key}'] = torch.as_tensor(
                np.asarray(state[f'{prefix}.{key}']), dtype=torch.float32)
    return out


def load_torch_inception(pretrain_path=None):
    """The TF-FID torch weights read and converted (a state dict for
    ``InceptionV3.load_state_dict(..., strict=False)``). Raises
    FileNotFoundError where the file is absent."""
    path = pretrain_path or INCEPTION_PRETRAIN_PATH
    if not os.path.exists(path):
        raise FileNotFoundError(
            f'FID Inception weights not found at {path}; download '
            f'pt_inception-2015-12-05-6726825d.pth (see reference '
            f'inception.py:13) and set BSVD_INCEPTION_PRETRAIN_PATH')
    state = torch.load(path, map_location='cpu', weights_only=True)
    return convert_torch_state_dict(state)
