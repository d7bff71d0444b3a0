"""Plain NHWC layers (counterpart of bsvd_tpu/nn/layers.py:26-216).

Activations are channels-last ``(..., H, W, C)`` as in the JAX package;
conv weights are torch OIHW. These are the plain PyTorch versions the
kernels' references are built from, and the norms, which run as plain
torch ops on every path (the JAX package computes them in XLA, outside
its Pallas kernels).
"""

import math

import torch
import torch.nn.functional as F

from bsvd_tpu_torch.ops import _flops
from bsvd_tpu_torch.parallel.mesh import all_reduce_sum, axes_index

ACTS = ('relu', 'relu6', 'none')
NORMS = ('none', 'in', 'bn')
BN_EPS = 1e-5
BN_MOMENTUM = 0.1


def conv2d(x, w, b=None, stride=1):
    """3x3 conv over ``(..., H, W, C)`` with torch symmetric padding; the
    leading dims merge into the batch. ``w``: (Cout, Cin, kh, kw)."""
    lead = x.shape[:-3]
    xm = x.reshape((-1,) + tuple(x.shape[-3:])).permute(0, 3, 1, 2)
    y = F.conv2d(xm, w.to(x.dtype), None if b is None else b.to(x.dtype),
                 stride=stride, padding=1)
    y = y.permute(0, 2, 3, 1)
    return y.reshape(tuple(lead) + tuple(y.shape[1:]))


def _nchw(x):
    """NCHW view of an NHWC tensor (channels-last strides, no copy)."""
    return x.permute(0, 3, 1, 2)


def conv2d_input_grad(dz, w, x, stride=1):
    """Input gradient of the 3x3 conv (pad 1) over NHWC: ``dz`` the output
    cotangent, ``x`` the conv's input (its shape and layout only). Runs
    aten's convolution_backward, as the JAX package leaves this transpose
    to XLA."""
    _flops.conv3x3(x.shape[0], x.shape[1], x.shape[2], x.shape[3],
                   dz.shape[-1], stride)
    dx = torch.ops.aten.convolution_backward(
        _nchw(dz), _nchw(x), w, None, [stride, stride], [1, 1], [1, 1],
        False, [0, 0], 1, [True, False, False])[0]
    return dx.permute(0, 2, 3, 1).contiguous()


def conv2d_weight_grad(x, dz, w_shape, stride=1):
    """Weight gradient (OIHW) of the 3x3 conv (pad 1) over NHWC, through
    aten's convolution_backward."""
    _flops.conv3x3(x.shape[0], x.shape[1], x.shape[2], x.shape[3],
                   w_shape[0], stride)
    w = torch.empty(w_shape, dtype=dz.dtype, device=dz.device)
    return torch.ops.aten.convolution_backward(
        _nchw(dz), _nchw(x), w, None, [stride, stride], [1, 1], [1, 1],
        False, [0, 0], 1, [False, True, False])[1]


def pixel_shuffle(x, r=2):
    """torch.nn.PixelShuffle on ``(..., H, W, C*r*r)``: input channel
    ``c*r*r + i*r + j`` goes to pixel offset (i, j) of channel c."""
    *lead, h, w, c4 = x.shape
    c = c4 // (r * r)
    x = x.reshape(*lead, h, w, c, r, r)
    nl = len(lead)
    perm = tuple(range(nl)) + (nl, nl + 3, nl + 1, nl + 4, nl + 2)
    return x.permute(perm).reshape(*lead, h * r, w * r, c)


def pixel_unshuffle(x, r=2):
    """Inverse of ``pixel_shuffle`` on ``(..., H*r, W*r, C)``, as
    torch.nn.PixelUnshuffle orders channels: pixel offset (i, j) of
    channel c goes to channel ``c*r*r + i*r + j``."""
    *lead, hr, wr, c = x.shape
    x = x.reshape(*lead, hr // r, r, wr // r, r, c)
    nl = len(lead)
    perm = tuple(range(nl)) + (nl, nl + 2, nl + 4, nl + 1, nl + 3)
    return x.permute(perm).reshape(*lead, hr // r, wr // r, c * r * r)


def get_act(act):
    """Activation by name (bsvd_tpu/nn/layers.py get_act)."""
    if act == 'relu':
        return torch.relu
    if act == 'relu6':
        return lambda v: torch.clamp(v, 0, 6)
    if act == 'none':
        return lambda v: v
    raise ValueError(f'unknown act {act!r}')


def conv_init(in_ch, out_ch, kernel_size=3, bias=True, generator=None):
    """Kaiming-normal (fan-in, relu gain) weight + torch's default uniform
    bias, as bsvd_tpu/nn/layers.py conv_init. Returns {'w': OIHW, 'b'}."""
    fan_in = in_ch * kernel_size * kernel_size
    std = math.sqrt(2.0 / fan_in)
    w = torch.randn((out_ch, in_ch, kernel_size, kernel_size),
                    generator=generator) * std
    p = {'w': w}
    if bias:
        bound = 1.0 / math.sqrt(fan_in)
        p['b'] = (torch.rand((out_ch,), generator=generator) * 2 - 1) * bound
    return p


# ---------------------------------------------------------------------------
# norms (bsvd_tpu/nn/layers.py get_norm / norm_init / norm_apply /
# bn_fold_running_stats)
# ---------------------------------------------------------------------------

def norm_init(norm, ch):
    """Parameters of a norm site: None for 'none' and 'in' (InstanceNorm2d
    without affine or running statistics); for 'bn' the trained ``scale``
    and ``bias`` and the running ``mean`` and ``var``, all fp32."""
    if norm not in NORMS:
        raise ValueError(f'unknown norm {norm!r}')
    if norm != 'bn':
        return None
    return {'scale': torch.ones(ch), 'bias': torch.zeros(ch),
            'mean': torch.zeros(ch), 'var': torch.ones(ch)}


def is_bn_leaf(node):
    return isinstance(node, dict) and 'mean' in node


def _stat_dtype(dtype):
    """Statistics of half-precision activations are taken in fp32, as
    autocast runs norms."""
    return torch.float32 if dtype in (torch.bfloat16, torch.float16) \
        else dtype


def _moments(v, dims, axes, rows):
    """(mean, biased variance, count) of ``v`` over ``dims`` (kept as size
    1) on rows ``rows`` of H (axis -3; None: all) of this rank, pooled over
    the ranks of ``axes``. Each rank takes its rows' mean and sum of
    squared deviations (M2), writes them into its slot of a (ranks, 2, ...)
    buffer that one all-reduce fills, and every rank pools the slots in
    the same order (Chan et al.: M2 = sum M2_i + sum n_i (mean_i - mean)^2),
    so the statistics are the same bits everywhere and no cancellation of
    sums of squares enters. Differentiable (``mesh.AllReduce``). The
    ranks' counts are equal (equal shards, equal owned rows)."""
    own = v if rows is None else v.narrow(-3, rows[0], rows[1] - rows[0])
    n = math.prod(own.shape[d] for d in dims)
    mean = own.mean(dim=dims, keepdim=True)
    m2 = (own - mean).square().sum(dim=dims, keepdim=True)
    index, size = axes_index(axes)
    if size == 1:
        return mean, m2 / n, n
    shape = (2,) + tuple(mean.shape)
    slots = torch.cat([own.new_zeros((index,) + shape),
                       torch.stack([mean, m2])[None],
                       own.new_zeros((size - 1 - index,) + shape)])
    means, m2s = all_reduce_sum(slots, axes).unbind(1)
    mean = means.mean(0)
    m2 = m2s.sum(0) + n * (means - mean).square().sum(0)
    return mean, m2 / (n * size), n * size


def norm_apply(norm, p, x, stats, eps=BN_EPS, axes=(), rows=None):
    """The norm of a split site (conv, then norm, then act) over NHWC
    ``x``, computed in fp32 for half precision and returned in x's dtype.

    'in': per frame and channel over H and W. 'bn' (train mode): the
    statistics of the batch (every axis but C, variance biased), appended
    to ``stats`` as ``(p, mean, var, count)`` for ``bn_update``. Eval-mode
    BN never runs here: it is folded into the conv (``fold_bn_conv``).

    On a mesh the statistics are those of the global batch: ``axes`` (the
    ``parallel.mesh.Axis``es whose ranks hold the rest of the population,
    ``mesh.norm_axes``) and ``rows`` ((lo, hi): the rows of H this rank
    owns in a halo-extended block, ``parallel.spatial``) select them
    (``_moments``: one all-reduce a site); every row of ``x``, halo
    included, is normalised with them, and ``count`` is the global one.
    Without either, the statistics of ``x`` alone."""
    v = x.to(_stat_dtype(x.dtype))
    if norm not in ('in', 'bn'):
        raise ValueError(f'norm {norm!r} does not split its site')
    dims = (-3, -2) if norm == 'in' else tuple(range(v.dim() - 1))
    if axes or rows is not None:
        mean, var, n = _moments(v, dims, axes, rows)
    else:
        mean = v.mean(dim=dims, keepdim=True)
        var = v.var(dim=dims, keepdim=True, unbiased=False)
        n = v.numel() // v.shape[-1] if norm == 'bn' else None
    y = (v - mean) * torch.rsqrt(var + eps)
    if norm == 'bn':
        ch = v.shape[-1]
        stats.append((p, mean.detach().reshape(ch), var.detach().reshape(ch),
                      n))
        y = y * p['scale'].to(v.dtype) + p['bias'].to(v.dtype)
    return y.to(x.dtype)


@torch.no_grad()
def bn_update(stats, momentum=BN_MOMENTUM):
    """Fold the batch statistics ``norm_apply`` recorded into their BN
    leaves' running statistics, in place: ``r = (1 - momentum) r +
    momentum s``, the variance made unbiased (n / (n - 1)) first, as
    torch's BatchNorm and bsvd_tpu's bn_fold_running_stats."""
    for p, mean, var, n in stats:
        if n > 1:
            var = var * n / (n - 1)
        p['mean'].copy_((1 - momentum) * p['mean'] + momentum * mean)
        p['var'].copy_((1 - momentum) * p['var'] + momentum * var)


def fold_bn_conv(w, b, bn, eps=BN_EPS):
    """A conv (OIHW ``w``, ``b``) followed by eval-mode BN as one conv,
    computed in fp32 (or wider): ``w * s`` per output channel and ``(b -
    mean) * s + bias``, with ``s = scale / sqrt(var + eps)``. Returns
    {'w', 'b'}."""
    dt = torch.promote_types(w.dtype, torch.float32)
    s = bn['scale'].to(dt) * torch.rsqrt(bn['var'].to(dt) + eps)
    return {'w': w.to(dt) * s[:, None, None, None],
            'b': (b.to(dt) - bn['mean'].to(dt)) * s + bn['bias'].to(dt)}
