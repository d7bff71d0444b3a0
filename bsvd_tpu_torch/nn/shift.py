"""Temporal channel shift on ``(N, T, H, W, C)`` with zero boundaries
(counterpart of bsvd_tpu/nn/shift.py temporal_shift).

TSM: channels ``[:fold]`` come from frame t+1, ``[fold:2*fold]`` from
t-1, the rest stay; ``'toFutureOnly'`` (causal): ``[:2*fold]`` from t-1.
Neighbours outside the segment are zeros. ``temporal_shift_chunk`` is the
chunked-MIMO form: frame 0's past lanes come from the previous chunk
(``chunk_frame0`` and ``chunk_carry``, shared with the chunked forward).
"""

import torch


def temporal_shift(x, fold_div=8, shift_type='TSM'):
    c = x.shape[-1]
    fold = c // fold_div
    if 'toFutureOnly' in shift_type:
        head = torch.zeros_like(x[..., :2 * fold])
        head[:, 1:] = x[:, :-1, ..., :2 * fold]
        return torch.cat([head, x[..., 2 * fold:]], dim=-1)
    fut = torch.zeros_like(x[..., :fold])
    fut[:, :-1] = x[:, 1:, ..., :fold]
    past = torch.zeros_like(x[..., fold:2 * fold])
    past[:, 1:] = x[:, :-1, ..., fold:2 * fold]
    return torch.cat([fut, past, x[..., 2 * fold:]], dim=-1)


def temporal_shift_transpose(g, fold_div=8, shift_type='TSM'):
    """The transpose (adjoint) of ``temporal_shift``: each shifted slice
    moves back the other way, zeros at the clip edges. This is what
    ``jax.linear_transpose`` of the shift gives in the shift-conv backward
    (bsvd_tpu/ops/shift_conv.py _sc_bwd)."""
    fold = g.shape[-1] // fold_div
    if 'toFutureOnly' in shift_type:
        head = torch.zeros_like(g[..., :2 * fold])
        head[:, :-1] = g[:, 1:, ..., :2 * fold]
        return torch.cat([head, g[..., 2 * fold:]], dim=-1)
    fut = torch.zeros_like(g[..., :fold])
    fut[:, 1:] = g[:, :-1, ..., :fold]
    past = torch.zeros_like(g[..., fold:2 * fold])
    past[:, :-1] = g[:, 1:, ..., fold:2 * fold]
    return torch.cat([fut, past, g[..., 2 * fold:]], dim=-1)


def carry_lanes(c, fold_div, shift_type):
    """(lo, hi) of the lanes a chunk carries into the next: the past slice
    (TSM ``[fold, 2*fold)``, causal ``[0, 2*fold)``)."""
    fold = c // fold_div
    return (0, 2 * fold) if 'toFutureOnly' in shift_type else (fold, 2 * fold)


def chunk_carry(lanes, c, t_len, future_buffer_len=0, fold_div=8,
                shift_type='TSM'):
    """The carry a chunk leaves at a shift site, (N, 1, H, W, width): the
    pre-shift input's past lanes at frame ``T-1-future_buffer_len``, the
    slice the next chunk's frame 0 reads. ``lanes(j, lo, hi)`` gives frame
    j's lanes ``[lo, hi)`` of the site's input, (N, H, W, hi-lo)."""
    lo, hi = carry_lanes(c, fold_div, shift_type)
    return lanes(t_len - 1 - future_buffer_len, lo, hi)[:, None].clone()


def chunk_frame0(lanes, c, t_len, carry, fold_div=8, shift_type='TSM'):
    """Frame 0's shifted input at a chunk boundary, (N, H, W, C)
    contiguous: the carried past lanes (zeros when ``carry`` is None, the
    first chunk), TSM's future lanes from frame 1 (zeros when the chunk has
    one frame), the rest from frame 0. ``lanes`` as in ``chunk_carry``;
    frames 1..T-1 shift as in ``temporal_shift``."""
    lo, hi = carry_lanes(c, fold_div, shift_type)
    rest = lanes(0, hi, c)

    def zeros(k):
        return rest.new_zeros(rest.shape[:-1] + (k,))
    head = lanes(1, 0, lo) if t_len > 1 else zeros(lo)
    past = zeros(hi - lo) if carry is None else carry[:, 0].to(rest.dtype)
    return torch.cat([head, past, rest], dim=-1)


def temporal_shift_chunk(x, carry, fold_div=8, shift_type='TSM',
                         future_buffer_len=0):
    """Chunked-MIMO shift of a (N, T, H, W, C) chunk (counterpart of
    bsvd_tpu/nn/shift.py temporal_shift_chunk at stride 1): as
    ``temporal_shift``, but frame 0's past lanes come from ``carry`` (the
    previous chunk's slice; None on the first chunk, which means zeros).
    Built from the helpers the chunked forward's sites use
    (archs/wnet_arch._ChunkShiftSite).

    Returns (shifted, new_carry), new_carry as ``chunk_carry`` gives it.
    """
    n, t, h, w, c = x.shape

    def lanes(j, lo, hi):
        return x[:, j, ..., lo:hi]
    shifted = temporal_shift(x, fold_div, shift_type)
    shifted[:, 0] = chunk_frame0(lanes, c, t, carry, fold_div, shift_type)
    return shifted, chunk_carry(lanes, c, t, future_buffer_len, fold_div,
                                shift_type)
