"""K3 ``conv_s2``: stride-2 3x3 conv (torch padding 1) + bias + act, NHWC.

Counterpart of bsvd_tpu/ops/conv_s2.py ``conv_s2_pallas``, in natural
layout (the TPU kernel's width-folded weights are not ported); the CUDA
kernel is ``csrc/conv_s2.cu``. CPU tensors run ``conv_s2_reference``;
CUDA tensors launch the kernel or raise. ``conv_s2.launches`` counts.

Differentiable as an autograd Function with conv_s2.py _s2_bwd's backward:
the activation mask from the saved output, and dx and dw as the stride-2
transposed convs, which the JAX package leaves to XLA and the port to
aten's convolution_backward.
"""

import torch

from bsvd_tpu_torch.nn.layers import (conv2d, conv2d_input_grad,
                                      conv2d_weight_grad)
from bsvd_tpu_torch.ops import _build
from bsvd_tpu_torch.ops._pack import (ConvWeights, act_code, apply_act,
                                      as_weights, check_cuda, grad_needed,
                                      is_cpu, masked, ptr, vec_ok)


def conv_s2_reference(x, w, b=None, act='relu6'):
    cw = as_weights(w, b)
    return apply_act(conv2d(x, cw.w, cw.b, stride=2), act)


def conv_s2(x, w, b=None, act='relu6'):
    """(NT, H, W, C) -> (NT, (H+1)//2, (W+1)//2, Cout)."""
    cw = as_weights(w, b)
    nt, h, w_, c = x.shape
    if cw.cin != c:
        raise ValueError(f'weights take {cw.cin} channels, input has {c}')
    if grad_needed(x, cw):
        return _ConvS2Fn.apply(x, cw.w, cw.b, act)
    if is_cpu(x):
        return conv_s2_reference(x, cw, act=act)
    (x,) = check_cuda('conv_s2', x)
    wp, bp = cw.packed(x.device, x.dtype)
    y = torch.empty((nt, (h - 1) // 2 + 1, (w_ - 1) // 2 + 1, cw.cout),
                    dtype=x.dtype, device=x.device)
    err = _build.lib().bsvd_conv_s2(
        int(x.dtype == torch.bfloat16), ptr(x), ptr(wp), ptr(bp), ptr(y),
        nt, h, w_, c, wp.shape[-1], cw.cout, wp.shape[0], act_code(act),
        vec_ok(c, x), _build.stream_ptr(x))
    _build.check(err, 'conv_s2')
    conv_s2.launches += 1
    return y


conv_s2.launches = 0


class _ConvS2Fn(torch.autograd.Function):
    """K3 forward; backward from the saved (x, w, y)."""

    @staticmethod
    def forward(ctx, x, w, b, act):
        y = conv_s2(x, ConvWeights(w, b), act=act)
        ctx.save_for_backward(x, w, y)
        ctx.act = act
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, y = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        dz = masked(g, y, ctx.act).contiguous()
        db = dz.sum((0, 1, 2)).to(w.dtype) if need_b else None
        dw = conv2d_weight_grad(x, dz, w.shape, 2).to(w.dtype) \
            if need_w else None
        dx = conv2d_input_grad(dz, w, x, 2) if need_x else None
        return dx, dw, db, None
