"""K2 ``conv_chain``: two chained 3x3 convs in one kernel, the intermediate
kept in shared memory (counterpart of bsvd_tpu/ops/conv_chain.py
``conv_chain_pallas``; the CUDA kernel is ``csrc/conv_chain.cu``).

Variants: ``conv_chain`` (inc), ``conv_chain_add2`` (conv1 reads x + x2)
and ``conv_chain_add2_res`` (also out[..., c] = x_res[..., c] - y[..., c]
for c < res_ch, the natural-layout per-stage residual; x_res keeps its own
channel count). CPU tensors run ``conv_chain_reference``; CUDA tensors
launch the kernel or raise. ``conv_chain.launches`` counts launches of all
three variants.
"""

import torch

from bsvd_tpu_torch.nn.layers import conv2d
from bsvd_tpu_torch.ops import _build
from bsvd_tpu_torch.ops._pack import (act_code, apply_act, as_weights,
                                      check_cuda, check_same_shape, is_cpu,
                                      ptr, vec_ok)


def conv_chain_reference(x, w1, b1, w2, b2, act1='relu6', act2='none',
                         x2=None, x_res=None, res_ch=0):
    """Plain version: act2(conv2(act1(conv1(x [+ x2])))), the intermediate
    rounded to x's dtype, then the residual on the first res_ch channels."""
    c1, c2 = as_weights(w1, b1), as_weights(w2, b2)
    v = x if x2 is None else x + x2
    h = apply_act(conv2d(v, c1.w, c1.b), act1).to(x.dtype)
    y = apply_act(conv2d(h, c2.w, c2.b), act2)
    if res_ch:
        y = torch.cat([x_res[..., :res_ch] - y[..., :res_ch],
                       y[..., res_ch:]], dim=-1)
    return y


def _chain(x, x2, x_res, w1, b1, w2, b2, act1, act2, res_ch):
    c1w, c2w = as_weights(w1, b1), as_weights(w2, b2)
    nt, h, w_, c = x.shape
    if c1w.cin != c or c2w.cin != c1w.cout:
        raise ValueError(f'chain channels do not match: x {c}, w1 '
                         f'{c1w.cin}->{c1w.cout}, w2 {c2w.cin}->{c2w.cout}')
    check_same_shape('conv_chain', x, x2)
    if res_ch:
        if x_res is None or tuple(x_res.shape[:3]) != (nt, h, w_):
            raise ValueError('res_ch needs x_res of the same frames and size')
        if res_ch > min(x_res.shape[-1], c2w.cout):
            raise ValueError(f'res_ch {res_ch} exceeds x_res / output '
                             'channels')
    if is_cpu(x):
        return conv_chain_reference(x, c1w, None, c2w, None, act1, act2,
                                    x2=x2, x_res=x_res, res_ch=res_ch)
    x, x2, x_res = check_cuda('conv_chain', x, x2,
                              x_res if res_ch else None)
    w1p, b1p = c1w.packed(x.device, x.dtype)          # (C1P, 3, 3, CinP)
    w2p, b2p = c2w.packed(x.device, x.dtype, 64)      # (CoutP, 3, 3, C1P)
    y = torch.empty((nt, h, w_, c2w.cout), dtype=x.dtype, device=x.device)
    err = _build.lib().bsvd_conv_chain(
        int(x.dtype == torch.bfloat16), ptr(x), ptr(x2), ptr(x_res),
        ptr(w1p), ptr(b1p), ptr(w2p), ptr(b2p), ptr(y), nt, h, w_, c,
        w1p.shape[-1], c1w.cout, w1p.shape[0], c2w.cout, w2p.shape[0],
        0 if x_res is None else x_res.shape[-1], res_ch, act_code(act1), act_code(act2), vec_ok(c, x, x2),
        _build.stream_ptr(x))
    _build.check(err, 'conv_chain')
    conv_chain.launches += 1
    return y


def conv_chain(x, w1, b1, w2, b2, act1='relu6', act2='none'):
    """act2(conv2(act1(conv1(x)))): (NT, H, W, C) -> (NT, H, W, Cout)."""
    return _chain(x, None, None, w1, b1, w2, b2, act1, act2, 0)


conv_chain.launches = 0


def conv_chain_add2(x, x2, w1, b1, w2, b2, act1='relu6', act2='none'):
    """conv_chain of (x + x2)."""
    return _chain(x, x2, None, w1, b1, w2, b2, act1, act2, 0)


def conv_chain_add2_res(x, x2, x_res, w1, b1, w2, b2, act1='relu6',
                        act2='none', res_ch=3):
    """conv_chain of (x + x2), then out[..., c] = x_res[..., c] - out[..., c]
    for c < res_ch."""
    return _chain(x, x2, x_res, w1, b1, w2, b2, act1, act2, res_ch)
