"""Plain NHWC layers (counterpart of bsvd_tpu/nn/layers.py:26-110).

Activations are channels-last ``(..., H, W, C)`` as in the JAX package;
conv weights are torch OIHW. These are the plain PyTorch versions the
kernels' references are built from.
"""

import math

import torch
import torch.nn.functional as F

ACTS = ('relu', 'relu6', 'none')


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
    dx = torch.ops.aten.convolution_backward(
        _nchw(dz), _nchw(x), w, None, [stride, stride], [1, 1], [1, 1],
        False, [0, 0], 1, [True, False, False])[0]
    return dx.permute(0, 2, 3, 1).contiguous()


def conv2d_weight_grad(x, dz, w_shape, stride=1):
    """Weight gradient (OIHW) of the 3x3 conv (pad 1) over NHWC, through
    aten's convolution_backward."""
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
