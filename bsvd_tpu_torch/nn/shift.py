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
