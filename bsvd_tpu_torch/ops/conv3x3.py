"""K1 ``conv3x3`` (temporal shift + 3x3 conv + bias + act, optional second
input) and K4 ``conv_ps`` (3x3 conv + bias + r=2 pixel shuffle), NHWC.

Counterparts of bsvd_tpu/ops/conv3x3.py ``conv3x3_pallas`` and
``conv_ps_natural_pallas`` / ``conv_ps_fold_pallas``; the CUDA kernels are
``csrc/conv3x3.cu``. On a CPU tensor a wrapper runs its plain version
(``*_reference``); on a CUDA tensor it launches the kernel or raises.
``conv3x3.launches`` / ``conv_ps.launches`` count kernel launches.
"""

import torch

from bsvd_tpu_torch.nn.layers import conv2d, pixel_shuffle
from bsvd_tpu_torch.nn.shift import temporal_shift
from bsvd_tpu_torch.ops import _build
from bsvd_tpu_torch.ops._pack import (act_code, apply_act, as_weights,
                                      check_cuda, check_same_shape, is_cpu,
                                      ptr, vec_ok)

SHIFT_CODES = {'none': 0, 'tsm': 1, 'causal': 2}


def _shift_code(shift):
    if shift not in SHIFT_CODES:
        raise ValueError(f'shift must be one of {tuple(SHIFT_CODES)}, '
                         f'got {shift!r}')
    return SHIFT_CODES[shift]


def conv3x3_reference(x, w, b=None, x2=None, *, t_len=None, shift='none',
                      fold_div=8, act='relu6'):
    """Plain version: (x [+ x2]) -> temporal shift over clips of ``t_len``
    frames -> F.conv2d (pad 1) + bias -> act, in x's dtype."""
    cw = as_weights(w, b)
    _shift_code(shift)
    v = x if x2 is None else x + x2
    if shift != 'none':
        nt, h, w_, c = v.shape
        mode = 'TSM_toFutureOnly' if shift == 'causal' else 'TSM'
        v = temporal_shift(v.reshape(nt // t_len, t_len, h, w_, c), fold_div,
                           mode).reshape(nt, h, w_, c)
    return apply_act(conv2d(v, cw.w, cw.b), act)


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
