"""K1 ``conv3x3`` (temporal shift + 3x3 conv + bias + act, optional second
input), K4 ``conv_ps`` (3x3 conv + bias + r=2 pixel shuffle) and K7
``conv3x3_dw`` (the weight gradient of a 3x3 conv), NHWC.

Counterparts of bsvd_tpu/ops/conv3x3.py ``conv3x3_pallas``,
``conv_ps_natural_pallas`` / ``conv_ps_fold_pallas`` and
``conv3x3_dw_pallas``; the CUDA kernels are ``csrc/conv3x3.cu`` and
``csrc/conv3x3_dw.cu``. On a CPU tensor a wrapper runs its plain version
(``*_reference``); on a CUDA tensor it launches the kernel or raises.
``conv3x3.launches`` / ``conv_ps.launches`` / ``conv3x3_dw.launches``
count kernel launches.

``conv3x3`` and ``conv_ps`` are differentiable: with grad mode on and an
input that requires grad they run as ``torch.autograd.Function``s whose
backwards are the JAX custom_vjps' direct backwards (conv3x3.py _c3_bwd /
_c3a_bwd, shift_conv.py _sc_bwd / _sca_bwd, conv3x3.py _ps_direct_bwd):
the activation mask comes from the saved output, db is the sum of dz, dx
is the transposed conv (aten's convolution_backward, as the JAX package
leaves it to XLA) followed by the reverse temporal shift and fans out to
both addends, and dw is K7 on the (shifted, summed) input.
"""

import torch

from bsvd_tpu_torch.nn.layers import (conv2d, conv2d_input_grad,
                                      conv2d_weight_grad, pixel_shuffle,
                                      pixel_unshuffle)
from bsvd_tpu_torch.nn.shift import temporal_shift, temporal_shift_transpose
from bsvd_tpu_torch.ops import _build
from bsvd_tpu_torch.ops._pack import (ConvWeights, act_code, apply_act,
                                      as_weights, check_cuda,
                                      check_same_shape, grad_needed, is_cpu,
                                      masked, ptr, round_up, vec_ok)

SHIFT_CODES = {'none': 0, 'tsm': 1, 'causal': 2}
_SHIFT_MODES = {'tsm': 'TSM', 'causal': 'TSM_toFutureOnly'}
# K7: blocks to aim for across its pixel splits (four per SM of an H100)
DW_BLOCKS = 528


def _shift_code(shift):
    if shift not in SHIFT_CODES:
        raise ValueError(f'shift must be one of {tuple(SHIFT_CODES)}, '
                         f'got {shift!r}')
    return SHIFT_CODES[shift]


def _shifted(v, t_len, shift, fold_div):
    """temporal_shift of (N*T, H, W, C) frames over clips of t_len."""
    if shift == 'none':
        return v
    nt, h, w_, c = v.shape
    return temporal_shift(v.reshape(nt // t_len, t_len, h, w_, c), fold_div,
                          _SHIFT_MODES[shift]).reshape(nt, h, w_, c)


def _unshifted(g, t_len, shift, fold_div):
    """The transpose of ``_shifted``."""
    if shift == 'none':
        return g
    nt, h, w_, c = g.shape
    return temporal_shift_transpose(
        g.reshape(nt // t_len, t_len, h, w_, c), fold_div,
        _SHIFT_MODES[shift]).reshape(nt, h, w_, c)


def conv3x3_reference(x, w, b=None, x2=None, *, t_len=None, shift='none',
                      fold_div=8, act='relu6'):
    """Plain version: (x [+ x2]) -> temporal shift over clips of ``t_len``
    frames -> F.conv2d (pad 1) + bias -> act, in x's dtype."""
    cw = as_weights(w, b)
    _shift_code(shift)
    v = x if x2 is None else x + x2
    return apply_act(conv2d(_shifted(v, t_len, shift, fold_div), cw.w, cw.b),
                     act)


def conv3x3(x, w, b=None, x2=None, *, t_len=None, shift='none', fold_div=8,
            act='relu6'):
    """Fused (temporal shift +) 3x3 conv (stride 1, pad 1) + bias + act.

    Args:
        x: (N*T, H, W, C) NHWC; for shift modes, clips of ``t_len`` frames
            concatenated on axis 0.
        w: (Cout, C, 3, 3) or a ConvWeights; b: (Cout,) or None.
        x2: optional second input summed before the shift.
        shift: 'none' | 'tsm' | 'causal'; fold = C // fold_div.
    Returns:
        (N*T, H, W, Cout) in x's dtype.
    """
    cw = as_weights(w, b)
    code = _shift_code(shift)
    nt, h, w_, c = x.shape
    if shift != 'none' and (t_len is None or nt % t_len):
        raise ValueError(f'{nt} frames do not split into clips of {t_len}')
    if cw.cin != c:
        raise ValueError(f'weights take {cw.cin} channels, input has {c}')
    check_same_shape('conv3x3', x, x2)
    if grad_needed(x, x2, cw):
        return _Conv3x3Fn.apply(x, x2, cw.w, cw.b, t_len, shift, fold_div,
                                act)
    if is_cpu(x):
        return conv3x3_reference(x, cw, x2=x2, t_len=t_len, shift=shift,
                                 fold_div=fold_div, act=act)
    x, x2 = check_cuda('conv3x3', x, x2)
    wp, bp = cw.packed(x.device, x.dtype)
    y = torch.empty((nt, h, w_, cw.cout), dtype=x.dtype, device=x.device)
    err = _build.lib().bsvd_conv3x3(
        int(x.dtype == torch.bfloat16), ptr(x), ptr(x2), ptr(wp), ptr(bp),
        ptr(y), nt, h, w_, c, wp.shape[-1], cw.cout, wp.shape[0],
        t_len or 1, c // fold_div, code, act_code(act), vec_ok(c, x, x2),
        _build.stream_ptr(x))
    _build.check(err, 'conv3x3')
    conv3x3.launches += 1
    return y


conv3x3.launches = 0


class _Conv3x3Fn(torch.autograd.Function):
    """K1 forward; backward from the saved (x, x2, w, y) without recomputing
    the forward conv."""

    @staticmethod
    def forward(ctx, x, x2, w, b, t_len, shift, fold_div, act):
        y = conv3x3(x, ConvWeights(w, b), x2=x2, t_len=t_len, shift=shift,
                    fold_div=fold_div, act=act)
        ctx.save_for_backward(x, x2, w, y)
        ctx.conf = (t_len, shift, fold_div, act)
        return y

    @staticmethod
    def backward(ctx, g):
        x, x2, w, y = ctx.saved_tensors
        t_len, shift, fold_div, act = ctx.conf
        need_x, need_x2, need_w, need_b = ctx.needs_input_grad[:4]
        dz = masked(g, y, act).contiguous()
        db = dz.sum((0, 1, 2)).to(w.dtype) if need_b else None
        dw = conv3x3_dw(x, dz, x2, t_len=t_len, shift=shift,
                        fold_div=fold_div).to(w.dtype) if need_w else None
        dx = None
        if need_x or need_x2:
            dx = _unshifted(conv2d_input_grad(dz, w, x), t_len, shift,
                            fold_div)
        return (dx if need_x else None, dx if need_x2 else None, dw, db,
                None, None, None, None)


def conv_ps_reference(x, w, b=None):
    """Plain version: F.conv2d (pad 1) + bias, then torch PixelShuffle(2)
    order on NHWC (channel k*4 + di*2 + dj -> pixel (2i+di, 2j+dj), k)."""
    cw = as_weights(w, b)
    return pixel_shuffle(conv2d(x, cw.w, cw.b), 2)


def conv_ps(x, w, b=None):
    """Fused 3x3 conv + bias + r=2 pixel shuffle: (NT, H, W, C) with
    weights (4c, C, 3, 3) -> (NT, 2H, 2W, c)."""
    cw = as_weights(w, b)
    nt, h, w_, c = x.shape
    if cw.cout % 4:
        raise ValueError(f'pixel shuffle needs Cout % 4 == 0, got {cw.cout}')
    if cw.cin != c:
        raise ValueError(f'weights take {cw.cin} channels, input has {c}')
    if grad_needed(x, cw):
        return _ConvPsFn.apply(x, cw.w, cw.b)
    if is_cpu(x):
        return conv_ps_reference(x, cw)
    (x,) = check_cuda('conv_ps', x)
    wp, bp = cw.packed(x.device, x.dtype)
    y = torch.empty((nt, 2 * h, 2 * w_, cw.cout // 4), dtype=x.dtype,
                    device=x.device)
    err = _build.lib().bsvd_conv_ps(
        int(x.dtype == torch.bfloat16), ptr(x), ptr(wp), ptr(bp), ptr(y),
        nt, h, w_, c, wp.shape[-1], cw.cout, wp.shape[0], vec_ok(c, x),
        _build.stream_ptr(x))
    _build.check(err, 'conv_ps')
    conv_ps.launches += 1
    return y


conv_ps.launches = 0


class _ConvPsFn(torch.autograd.Function):
    """K4 forward; backward: one unshuffle of the cotangent, then dx and a
    K7 dw (conv3x3.py _ps_direct_bwd)."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        return conv_ps(x, ConvWeights(w, b))

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad
        dz = pixel_unshuffle(g, 2).contiguous()
        db = dz.sum((0, 1, 2)).to(w.dtype) if need_b else None
        dw = conv3x3_dw(x, dz).to(w.dtype) if need_w else None
        dx = conv2d_input_grad(dz, w, x) if need_x else None
        return dx, dw, db


# ---------------------------------------------------------------------------
# K7: weight gradient
# ---------------------------------------------------------------------------

def conv3x3_dw_reference(x, dz, x2=None, *, t_len=None, shift='none',
                         fold_div=8):
    """Plain version: aten's weight gradient in fp32 of the conv whose input
    is shift(x [+ x2]) (the sum in x's dtype) and whose output cotangent is
    dz. Returns (Cout, Cin, 3, 3) fp32."""
    v = _shifted(x if x2 is None else x + x2, t_len, shift, fold_div)
    return conv2d_weight_grad(v.float(), dz.float(),
                              (dz.shape[-1], x.shape[-1], 3, 3))


def conv3x3_dw(x, dz, x2=None, *, t_len=None, shift='none', fold_div=8):
    """Weight gradient of a stride-1 pad-1 3x3 NHWC conv:
    dw[co, ci, ky, kx] = sum_{n,y,x} pad(v)[n, y+ky, x+kx, ci] dz[n, y, x, co]
    with v = shift(x [+ x2]) (the shift over clips of ``t_len`` frames).

    Args:
        x, x2: (NT, H, W, Ci); dz: (NT, H, W, Co), one dtype (fp32 / bf16).
    Returns:
        (Co, Ci, 3, 3) fp32, OIHW (conv3x3_dw_pallas's HWIO transposed).
    """
    code = _shift_code(shift)
    nt, h, w_, c = x.shape
    if tuple(dz.shape[:3]) != (nt, h, w_):
        raise ValueError(f'dz {tuple(dz.shape)} does not match x '
                         f'{tuple(x.shape)}')
    if shift != 'none' and (t_len is None or nt % t_len):
        raise ValueError(f'{nt} frames do not split into clips of {t_len}')
    check_same_shape('conv3x3_dw', x, x2)
    if is_cpu(x):
        return conv3x3_dw_reference(x, dz, x2, t_len=t_len, shift=shift,
                                    fold_div=fold_div)
    x, x2, dz = check_cuda('conv3x3_dw', x, x2, dz)
    co = dz.shape[-1]
    cinp, coutp = round_up(c, 32), round_up(co, 64)
    ntiles = nt * -(-h // 8) * -(-w_ // 16)
    splits = max(1, min(ntiles, -(-DW_BLOCKS // ((coutp // 64) *
                                                  (cinp // 32)))))
    part = torch.empty((splits, coutp, cinp, 9), dtype=torch.float32,
                       device=x.device)
    dw = torch.empty((co, c, 3, 3), dtype=torch.float32, device=x.device)
    err = _build.lib().bsvd_conv3x3_dw(
        int(x.dtype == torch.bfloat16), ptr(x), ptr(x2), ptr(dz), ptr(part),
        ptr(dw), nt, h, w_, c, co, cinp, coutp, t_len or 1, c // fold_div,
        code, vec_ok(c, x, x2), vec_ok(co, dz), splits,
        _build.stream_ptr(x))
    _build.check(err, 'conv3x3_dw')
    conv3x3_dw.launches += 1
    return dw


conv3x3_dw.launches = 0
