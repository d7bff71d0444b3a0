"""Pixel losses (counterpart of bsvd_tpu/losses/losses.py L1Loss, MSELoss
and CharbonnierLoss): elementwise weighting, then 'none' / 'mean' / 'sum'
reduction, times ``loss_weight``."""

import torch

from bsvd_tpu_torch.utils.registry import LOSS_REGISTRY

_REDUCTIONS = ('none', 'mean', 'sum')


def _reduce(x, weight, reduction):
    if weight is not None:
        x = x * weight
    if reduction == 'mean':
        return x.mean()
    if reduction == 'sum':
        return x.sum()
    return x


class _PixelLoss:
    def __init__(self, loss_weight=1.0, reduction='mean'):
        if reduction not in _REDUCTIONS:
            raise ValueError(f'reduction {reduction!r} not in {_REDUCTIONS}')
        self.loss_weight = loss_weight
        self.reduction = reduction

    def __call__(self, pred, target, weight=None):
        return self.loss_weight * _reduce(self.elementwise(pred - target),
                                          weight, self.reduction)


@LOSS_REGISTRY.register()
class L1Loss(_PixelLoss):
    def elementwise(self, d):
        return d.abs()


@LOSS_REGISTRY.register()
class MSELoss(_PixelLoss):
    def elementwise(self, d):
        return d.square()


@LOSS_REGISTRY.register()
class CharbonnierLoss(_PixelLoss):
    """sqrt((x - y)^2 + eps), eps added as the JAX package adds it."""

    def __init__(self, loss_weight=1.0, reduction='mean', eps=1e-12):
        super().__init__(loss_weight, reduction)
        self.eps = eps

    def elementwise(self, d):
        return torch.sqrt(d.square() + self.eps)
