"""K2 ``conv_chain``: two chained 3x3 convs in one kernel, the intermediate
kept in shared memory (counterpart of bsvd_tpu/ops/conv_chain.py
``conv_chain_pallas``; the CUDA kernel is ``csrc/conv_chain.cu``).

Variants: ``conv_chain`` (inc), ``conv_chain_add2`` (conv1 reads x + x2)
and ``conv_chain_add2_res`` (also out[..., c] = x_res[..., c] - y[..., c]
for c < res_ch, the natural-layout per-stage residual; x_res keeps its own
channel count). CPU tensors run ``conv_chain_reference``; CUDA tensors
launch the kernel or raise (both kernels keep the whole intermediate in
shared memory: bf16 takes up to 256 channels, 192 with x2, fp32 192; a
wider one is refused at launch with CUDA's error; every WNet chain has
64). ``conv_chain.launches`` counts launches of all three variants.

All three are differentiable, with conv_chain.py _chain_direct_bwd's
backward: the act2 mask from the saved output and only the intermediate h
recomputed, through K1 (``conv3x3`` with shift 'none', act1 and x2), then
two K7 weight gradients; ``_ccr_bwd``'s residual un-combine runs on the
first ``res_ch`` channels in the natural layout.
"""

import torch

from bsvd_tpu_torch.nn.layers import conv2d, conv2d_input_grad
from bsvd_tpu_torch.ops import _build, _flops
from bsvd_tpu_torch.ops._pack import (ConvWeights, act_code, apply_act,
                                      as_weights, check_cuda,
                                      check_same_shape, grad_needed, is_cpu,
                                      masked, ptr, vec_ok)
from bsvd_tpu_torch.ops.conv3x3 import conv3x3, conv3x3_dw


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


def packed_w2(c2w, device, dtype):
    """conv2's weights as K2 takes them: (CoutP, 3, 3, C1P), K over the
    intermediate's channels padded to 64. bf16 packs CoutP to 16 where Cout
    <= 16 (the 3-channel head: conv2's N block is 16 channels, not 64),
    else to 64; the fp32 kernel's blocks are 64 channels."""
    narrow = dtype == torch.bfloat16 and c2w.cout <= 16
    return c2w.packed(device, dtype, 64, cout_mult=16 if narrow else 64)


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
    if grad_needed(x, x2, x_res, c1w, c2w):
        return _ChainFn.apply(x, x2, x_res if res_ch else None, c1w.w, c1w.b,
                              c2w.w, c2w.b, act1, act2, res_ch)
    _flops.conv3x3(nt, h, w_, c, c1w.cout)
    _flops.conv3x3(nt, h, w_, c1w.cout, c2w.cout)
    if is_cpu(x):
        with _flops.hidden():
            return conv_chain_reference(x, c1w, None, c2w, None, act1, act2,
                                        x2=x2, x_res=x_res, res_ch=res_ch)
    x, x2, x_res = check_cuda('conv_chain', x, x2,
                              x_res if res_ch else None)
    w1p, b1p = c1w.packed(x.device, x.dtype)          # (C1P, 3, 3, CinP)
    w2p, b2p = packed_w2(c2w, x.device, x.dtype)      # (CoutP, 3, 3, C1P)
    y = torch.empty((nt, h, w_, c2w.cout), dtype=x.dtype, device=x.device)
    err = _build.lib().bsvd_conv_chain(
        int(x.dtype == torch.bfloat16), ptr(x), ptr(x2), ptr(x_res),
        ptr(w1p), ptr(b1p), ptr(w2p), ptr(b2p), ptr(y), nt, h, w_, c,
        w1p.shape[-1], c1w.cout, w1p.shape[0], c2w.cout, w2p.shape[0],
        0 if x_res is None else x_res.shape[-1], res_ch, act_code(act1),
        act_code(act2), vec_ok(c, x, x2),
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


class _ChainFn(torch.autograd.Function):
    """K2 forward; direct backward from the saved endpoints (the
    intermediate recomputed by K1, never stored)."""

    @staticmethod
    def forward(ctx, x, x2, x_res, w1, b1, w2, b2, act1, act2, res_ch):
        y = _chain(x, x2, x_res, ConvWeights(w1, b1), None,
                   ConvWeights(w2, b2), None, act1, act2, res_ch)
        ctx.save_for_backward(x, x2, x_res, w1, b1, w2, y)
        ctx.conf = (act1, act2, res_ch)
        return y

    @staticmethod
    def backward(ctx, g):
        x, x2, x_res, w1, b1, w2, y = ctx.saved_tensors
        act1, act2, rc = ctx.conf
        need = ctx.needs_input_grad
        dxres = None
        if rc:
            # saved y = [x_res - y2 | y2] on the first rc channels: y2 (the
            # act2 mask's source) and the cotangents of (y2, x_res) are
            # channel selects of y and g
            if act2 != 'none':
                y = torch.cat([x_res[..., :rc] - y[..., :rc], y[..., rc:]],
                              dim=-1)
            if need[2]:
                dxres = torch.zeros_like(x_res)
                dxres[..., :rc] = g[..., :rc]
            g = torch.cat([-g[..., :rc], g[..., rc:]], dim=-1)
        h = conv3x3(x, ConvWeights(w1, b1), x2=x2, act=act1)
        dz2 = masked(g, y, act2).contiguous()
        db2 = dz2.sum((0, 1, 2)).to(w2.dtype) if need[6] else None
        dw2 = conv3x3_dw(h, dz2).to(w2.dtype) if need[5] else None
        dz1 = masked(conv2d_input_grad(dz2, w2, h), h, act1)
        db1 = dz1.sum((0, 1, 2)).to(w1.dtype) if need[4] else None
        dw1 = conv3x3_dw(x, dz1, x2).to(w1.dtype) if need[3] else None
        dx = conv2d_input_grad(dz1, w1, x) if need[0] or need[1] else None
        return (dx if need[0] else None, dx if need[1] else None, dxres,
                dw1, db1, dw2, db2, None, None, None)
