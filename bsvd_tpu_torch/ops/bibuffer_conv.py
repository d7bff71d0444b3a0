"""K5 ``bibuffer_conv`` / ``bibuffer_multi`` and K6 ``bibuffer_chain``: the
streaming BiBufferConv steps on packed buffer state, NHWC.

Counterparts of bsvd_tpu/ops/bibuffer_conv.py ``bibuffer_conv_pallas``,
``bibuffer_multi_pallas`` and ``bibuffer_chain_pallas``; the CUDA kernels
are ``csrc/bibuffer_conv.cu``. Every temporal conv of the streaming net
carries one packed frame per stream. Bidirectional: ``B = [left,
center[f:]]`` with f = C // fold_div; the conv input is ``[x[:f], B[:f],
B[2f:]]`` and the next state ``[B[f:2f], x[f:]]``. Causal: B is the
previous frame; the input is ``[B[:2f], x[2f:]]`` and the next state x.

On a CPU tensor a wrapper runs its plain version (``*_reference``); on a
CUDA tensor it launches the kernel or raises. The kernels never write the
state they read: the next state is a new tensor. ``bibuffer_conv`` and
``bibuffer_multi`` launch the same kernel (K5) and count separately;
``bibuffer_chain.launches`` counts K6.
"""

import torch

from bsvd_tpu_torch.nn.layers import conv2d
from bsvd_tpu_torch.ops import _build, _flops
from bsvd_tpu_torch.ops._pack import (act_code, apply_act, as_weights,
                                      check_cuda, is_cpu, ptr, vec_ok)


def bibuffer_conv_reference(x, state, w, b=None, fold_div=8, act='relu6',
                            causal=False):
    """Plain version of one step: (y, next state), in x's dtype."""
    cw = as_weights(w, b)
    f = x.shape[-1] // fold_div
    if causal:
        inp = torch.cat([state[..., :2 * f], x[..., 2 * f:]], dim=-1)
        new_state = x
    else:
        inp = torch.cat([x[..., :f], state[..., :f], state[..., 2 * f:]],
                        dim=-1)
        new_state = torch.cat([state[..., f:2 * f], x[..., f:]], dim=-1)
    return apply_act(conv2d(inp, cw.w, cw.b), act), new_state


def _frames(x, state):
    """x as (F, N, H, W, C) frames of the streams in ``state`` (N, H, W,
    C): (F, H, W, C) with a (1, H, W, C) state, or already 5-d."""
    xs = x[:, None] if x.dim() == state.dim() else x
    if xs.dim() != 5 or tuple(xs.shape[1:]) != tuple(state.shape):
        raise ValueError(f'frames {tuple(x.shape)} do not match state '
                         f'{tuple(state.shape)}')
    return xs


def bibuffer_multi_reference(x, state, w, b=None, fold_div=8, act='relu6',
                             causal=False):
    """Plain version of F sequential steps: (y like x, final state)."""
    xs = _frames(x, state)
    ys = []
    for xi in xs:
        y, state = bibuffer_conv_reference(xi, state, w, b, fold_div, act,
                                           causal)
        ys.append(y)
    y = torch.stack(ys)
    return (y[:, 0] if x.dim() == state.dim() else y), state


def bibuffer_chain_reference(x, s1, s2, w1, b1, w2, b2, fold_div=8,
                             act='relu6', act2='relu6', causal=False):
    """Plain version of a MemCvBlock step: two buffered convs, the first's
    output (in x's dtype) the second's live frame. Returns (y, s1', s2')."""
    y1, s1n = bibuffer_conv_reference(x, s1, w1, b1, fold_div, act, causal)
    y2, s2n = bibuffer_conv_reference(y1, s2, w2, b2, fold_div, act2, causal)
    return y2, s1n, s2n


def _check_fold(c, fold_div, min_fold=1):
    """fold = c // fold_div. K5 takes fold 0 (shift_input's stems: 3-5
    channels at fold_div 8), where the step moves no lanes and only delays
    the frame; K6's lane rule needs fold >= 1."""
    if fold_div < 1 or c // fold_div < min_fold:
        raise ValueError(f'fold_div {fold_div} for {c} channels')
    return c // fold_div


def _launch_bibuffer(name, xs, state, cw, fold_div, act, causal):
    """K5 on frames xs (F, N, H, W, C) and state (N, H, W, C)."""
    nf, n, h, w_, c = xs.shape
    fold = _check_fold(c, fold_div, min_fold=0)
    if cw.cin != c:
        raise ValueError(f'weights take {cw.cin} channels, input has {c}')
    xs, state = check_cuda(name, xs, state)
    wp, bp = cw.packed(xs.device, xs.dtype)
    y = torch.empty((nf, n, h, w_, cw.cout), dtype=xs.dtype, device=xs.device)
    new_state = torch.empty_like(state)
    vec = vec_ok(c, xs, state, new_state) and fold % 8 == 0
    err = _build.lib().bsvd_bibuffer(
        int(xs.dtype == torch.bfloat16), ptr(xs), ptr(state), ptr(wp),
        ptr(bp), ptr(y), ptr(new_state), nf, n, h, w_, c, wp.shape[-1],
        cw.cout, wp.shape[0], fold, int(causal), act_code(act), int(vec),
        _build.stream_ptr(xs))
    _build.check(err, name)
    return y, new_state


def bibuffer_conv(x, state, w, b=None, *, fold_div=8, act='relu6',
                  causal=False):
    """One streaming step of a buffered shift conv (+ bias + act).

    Args:
        x: (N, H, W, C) live frame of N streams; state: (N, H, W, C) packed
            buffer.
        w: (Cout, C, 3, 3) or a ConvWeights; b: (Cout,) or None.
    Returns:
        (y (N, H, W, Cout), next state (N, H, W, C)), in x's dtype.
    """
    cw = as_weights(w, b)
    if tuple(x.shape) != tuple(state.shape):
        raise ValueError(f'frame {tuple(x.shape)} and state '
                         f'{tuple(state.shape)} differ')
    _flops.conv3x3(*x.shape, cw.cout)
    if is_cpu(x):
        with _flops.hidden():
            return bibuffer_conv_reference(x, state, cw, fold_div=fold_div,
                                           act=act, causal=causal)
    y, new_state = _launch_bibuffer('bibuffer_conv', x[None], state, cw,
                                    fold_div, act, causal)
    bibuffer_conv.launches += 1
    return y[0], new_state


bibuffer_conv.launches = 0


def bibuffer_multi(x, state, w, b=None, *, fold_div=8, act='relu6',
                   causal=False):
    """F streaming steps of one buffered shift conv in one launch, the
    weights loaded once per block (StreamDenoiser.push_block).

    Args:
        x: (F, H, W, C) frames with state (1, H, W, C), or (F, N, H, W, C)
            frames of N streams with state (N, H, W, C).
    Returns:
        (y, like x with Cout channels, state after the F frames).
    """
    cw = as_weights(w, b)
    xs = _frames(x, state)
    nf, n, h, w_, c = xs.shape
    _flops.conv3x3(nf * n, h, w_, c, cw.cout)
    if is_cpu(x):
        with _flops.hidden():
            return bibuffer_multi_reference(x, state, cw, fold_div=fold_div,
                                            act=act, causal=causal)
    y, new_state = _launch_bibuffer('bibuffer_multi', xs, state, cw,
                                    fold_div, act, causal)
    bibuffer_multi.launches += 1
    return (y[:, 0] if x.dim() == state.dim() else y), new_state


bibuffer_multi.launches = 0


def bibuffer_chain(x, s1, s2, w1, b1, w2, b2, *, fold_div=8, act='relu6',
                   act2='relu6', causal=False):
    """Both buffered convs of a MemCvBlock in one launch, the lanes of the
    intermediate that conv2 reads kept in shared memory.

    Args:
        x, s1: (N, H, W, C) live frame and conv1's packed buffer; s2:
            (N, H, W, C1) conv2's packed buffer.
        w1: (C1, C, 3, 3), w2: (Cout, C1, 3, 3) or ConvWeights.
    Returns:
        (y (N, H, W, Cout), s1', s2'), two ``bibuffer_conv`` steps: in bf16
        on the card their very bits (the kernel sums and rounds as K5
        does); in fp32 within summation order.
    """
    c1w, c2w = as_weights(w1, b1), as_weights(w2, b2)
    n, h, w_, c = x.shape
    if (c1w.cin != c or c2w.cin != c1w.cout or tuple(s1.shape) != tuple(x.shape)
            or tuple(s2.shape) != (n, h, w_, c1w.cout)):
        raise ValueError(f'chain shapes do not match: x {tuple(x.shape)}, s1 '
                         f'{tuple(s1.shape)}, s2 {tuple(s2.shape)}, w1 '
                         f'{c1w.cin}->{c1w.cout}, w2 {c2w.cin}->{c2w.cout}')
    fold1 = _check_fold(c, fold_div)
    fold2 = _check_fold(c1w.cout, fold_div)
    _flops.conv3x3(n, h, w_, c, c1w.cout)
    _flops.conv3x3(n, h, w_, c1w.cout, c2w.cout)
    if is_cpu(x):
        with _flops.hidden():
            return bibuffer_chain_reference(x, s1, s2, c1w, None, c2w, None,
                                            fold_div, act, act2, causal)
    x, s1, s2 = check_cuda('bibuffer_chain', x, s1, s2)
    w1p, b1p = c1w.packed(x.device, x.dtype)          # (C1P, 3, 3, CinP)
    w2p, b2p = c2w.packed(x.device, x.dtype, 64)      # (CoutP, 3, 3, C1P)
    y = torch.empty((n, h, w_, c2w.cout), dtype=x.dtype, device=x.device)
    s1n, s2n = torch.empty_like(s1), torch.empty_like(s2)
    vec = vec_ok(c, x, s1, s1n) and fold1 % 8 == 0
    vec2 = vec_ok(c1w.cout, s2, s2n) and fold2 % 8 == 0
    err = _build.lib().bsvd_bibuffer_chain(
        int(x.dtype == torch.bfloat16), ptr(x), ptr(s1), ptr(s2), ptr(w1p),
        ptr(b1p), ptr(w2p), ptr(b2p), ptr(y), ptr(s1n), ptr(s2n), n, h, w_,
        c, w1p.shape[-1], c1w.cout, w1p.shape[0], c2w.cout, w2p.shape[0],
        fold1, fold2, int(causal), act_code(act), act_code(act2), int(vec),
        int(vec2), _build.stream_ptr(x))
    _build.check(err, 'bibuffer_chain')
    bibuffer_chain.launches += 1
    return y, s1n, s2n


bibuffer_chain.launches = 0
