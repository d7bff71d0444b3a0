"""Weights packed for the kernels, and the checks every wrapper shares.

A ``ConvWeights`` keeps a conv's torch OIHW weight and bias (what the plain
versions use) and packs them for the CUDA kernels once, at first CUDA use:
``(CoutP, 3, 3, CinP)`` contiguous in the activation dtype, CinP rounded up
to 16 and CoutP to 64 with zeros, and an fp32 bias of CoutP, on the
activations' device. K4 takes its own order (``order='ps'``): output rows
sub-pixel-major and CoutP rounded up to 128; K3 takes CoutP rounded up to
128 in torch's order (``cout_mult=128``), K2's bf16 3-channel head 16
(``conv_chain.packed_w2``). Modules keep their
ConvWeights per (device, dtype), so packing happens once, not per call; a
packed copy is made anew when its weight or bias has changed in place since
(an optimizer step). A wrapper also takes a bare weight tensor and packs it
for that call.
"""

import torch

from bsvd_tpu_torch.nn.layers import get_act

ACT_CODES = {'none': 0, 'relu': 1, 'relu6': 2}
KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def round_up(v, m):
    return -(-v // m) * m


class ConvWeights:
    """One 3x3 conv's weights: ``w`` (Cout, Cin, 3, 3), ``b`` (Cout,) or
    None (a zero bias)."""

    def __init__(self, w, b=None):
        if w.dim() != 4 or tuple(w.shape[2:]) != (3, 3):
            raise ValueError(f'expected OIHW 3x3 weights, got {tuple(w.shape)}')
        self.w = w
        self.b = b if b is not None else torch.zeros(
            w.shape[0], dtype=w.dtype, device=w.device)
        self._packed = {}

    @property
    def cout(self):
        return self.w.shape[0]

    @property
    def cin(self):
        return self.w.shape[1]

    def packed(self, device, dtype, cin_mult=16, order='oc', cout_mult=None):
        """(w_packed, b_packed) on ``device`` (the activations'); ``cin_mult``
        64 for a chain's second conv, whose K runs over the padded
        intermediate. ``order`` 'oc' keeps torch's output channel order,
        CoutP a multiple of ``cout_mult`` (64 unless given: 128 for K3,
        16 for K2's bf16 head);
        'ps' (K4) puts packed row ``s * c4 + k`` = torch channel
        ``k * 4 + s`` (``ps_order``), CoutP a multiple of 128 and of
        nothing else."""
        if order not in ('oc', 'ps'):
            raise ValueError(f'pack order must be oc or ps, got {order!r}')
        if order == 'ps' and cout_mult not in (None, 128):
            raise ValueError(f"pack order 'ps' pads CoutP to a multiple of "
                             f"128, not {cout_mult}")
        cout_mult = cout_mult or (128 if order == 'ps' else 64)
        key = (torch.device(device), dtype, cin_mult, order, cout_mult)
        stamp = (self.w._version, self.b._version)
        hit = self._packed.get(key)
        if hit is None or hit[0] != stamp:
            cinp = round_up(self.cin, cin_mult)
            coutp = round_up(self.cout, cout_mult)
            rows = (ps_order(self.cout, self.w.device) if order == 'ps'
                    else slice(None))
            with torch.no_grad():
                wp = torch.zeros((coutp, 3, 3, cinp), dtype=dtype,
                                 device=key[0])
                wp[:self.cout, :, :, :self.cin] = \
                    self.w[rows].permute(0, 2, 3, 1)
                bp = torch.zeros(coutp, dtype=torch.float32, device=key[0])
                bp[:self.cout] = self.b[rows].float()
            hit = self._packed[key] = (stamp, (wp, bp))
        return hit[1]


def ps_order(cout, device=None):
    """Torch output channel of each sub-pixel-major row: row ``s * c4 + k``
    holds channel ``k * 4 + s`` (s = di * 2 + dj, c4 = cout // 4), so a run
    of rows is a run of channels k of one sub-pixel of the r=2 shuffle."""
    c4 = cout // 4
    return torch.arange(cout, device=device).reshape(c4, 4).t().reshape(-1)


def as_weights(w, b=None):
    return w if isinstance(w, ConvWeights) else ConvWeights(w, b)


def grad_needed(*inputs):
    """Whether a call must record autograd: grad mode on and some input (a
    tensor, or a ConvWeights' weight or bias) requires grad."""
    if not torch.is_grad_enabled():
        return False
    for t in inputs:
        ts = (t.w, t.b) if isinstance(t, ConvWeights) else (t,)
        if any(isinstance(v, torch.Tensor) and v.requires_grad for v in ts):
            return True
    return False


def is_cpu(x):
    return x.device.type == 'cpu'


def check_same_shape(name, x, x2):
    if x2 is not None and x2.shape != x.shape:
        raise ValueError(f'{name}: second input {tuple(x2.shape)} does not '
                         f'match {tuple(x.shape)}')


def check_cuda(name, *tensors):
    """Inputs of a kernel launch: CUDA, one kernel dtype, contiguous."""
    x = tensors[0]
    if x.device.type != 'cuda':
        raise RuntimeError(f'{name}: no kernel for device {x.device}')
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f'{name}: the CUDA kernel takes float32 or bfloat16, '
                        f'got {x.dtype}')
    for t in tensors[1:]:
        if t is None:
            continue
        if t.device != x.device or t.dtype != x.dtype:
            raise TypeError(f'{name}: inputs must share device and dtype '
                            f'({t.device}/{t.dtype} vs {x.device}/{x.dtype})')
    return tuple(None if t is None else t.contiguous() for t in tensors)


def vec_ok(c, *tensors):
    """Whether the loader may read 8 channels per 16-byte access."""
    return int(c % 8 == 0 and all(t.data_ptr() % 16 == 0
                                  for t in tensors if t is not None))


def act_code(act):
    if act not in ACT_CODES:
        raise ValueError(f'the conv kernels implement acts {tuple(ACT_CODES)}'
                         f', got {act!r}')
    return ACT_CODES[act]


def ptr(t):
    return None if t is None else t.data_ptr()


def apply_act(y, act):
    act_code(act)
    return get_act(act)(y)


def act_mask(y, act):
    """Derivative of the activation recovered from its saved OUTPUT, so no
    backward recomputes a forward conv (bsvd_tpu/ops/shift_conv.py
    act_mask). At exactly 0 and 6 it is 0, where autodiff of a clip gives
    0.5. None for 'none'."""
    if act == 'relu':
        return (y > 0).to(y.dtype)
    if act == 'relu6':
        return ((y > 0) & (y < 6)).to(y.dtype)
    act_code(act)
    return None


def masked(g, y, act):
    """The cotangent before the activation: g * act_mask(y)."""
    m = act_mask(y, act)
    return g if m is None else g * m
