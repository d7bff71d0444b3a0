"""Temporal channel shift on ``(N, T, H, W, C)`` with zero boundaries
(counterpart of bsvd_tpu/nn/shift.py temporal_shift).

TSM: channels ``[:fold]`` come from frame t+1, ``[fold:2*fold]`` from
t-1, the rest stay; ``'toFutureOnly'`` (causal): ``[:2*fold]`` from t-1.
Neighbours outside the segment are zeros.
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
