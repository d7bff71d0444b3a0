"""Losses (counterpart of bsvd_tpu/losses/losses.py): the pixel losses
L1Loss, MSELoss and CharbonnierLoss (elementwise weighting, then 'none' /
'mean' / 'sum' reduction, times ``loss_weight``), WeightedTVLoss,
PSNRLoss and the VGG PerceptualLoss. The GAN losses are in
``gan_loss.py``."""

import math

import torch

from bsvd_tpu_torch.parallel.mesh import all_reduce_sum
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


@LOSS_REGISTRY.register()
class WeightedTVLoss(L1Loss):
    """Total variation: the L1 loss of each image against itself shifted
    by one row and by one column ('mean' or 'sum' reduction), on NCHW or
    NHWC (``data_format``)."""

    def __init__(self, loss_weight=1.0, reduction='mean', data_format='NCHW'):
        if reduction not in ('mean', 'sum'):
            raise ValueError(f'reduction {reduction!r} not supported for TV '
                             f'loss')
        super().__init__(loss_weight=loss_weight, reduction=reduction)
        self.data_format = data_format

    def __call__(self, pred, weight=None):
        # the H and W axes counted from the end
        hy, wx = (-2, -1) if self.data_format == 'NCHW' else (-3, -2)

        def cut(t, axis, start):
            return t.narrow(axis, start, t.shape[axis] - 1)
        y_w = x_w = None
        if weight is not None:
            y_w, x_w = cut(weight, hy, 0), cut(weight, wx, 0)
        y_diff = super().__call__(cut(pred, hy, 0), cut(pred, hy, 1),
                                  weight=y_w)
        x_diff = super().__call__(cut(pred, wx, 0), cut(pred, wx, 1),
                                  weight=x_w)
        return x_diff + y_diff


@LOSS_REGISTRY.register()
class PSNRLoss:
    """loss_weight * 10 / ln(10) * mean over images of log(per-image MSE
    + 1e-8) (the per-image log before the batch mean), optionally on the
    BT.601 Y channel of [0, 1] RGB (channel axis: last for channels-last,
    1 for NCHW, 2 for (N, T, C, H, W))."""

    def __init__(self, loss_weight=1.0, reduction='mean', to_y=False):
        if reduction != 'mean':
            raise ValueError('PSNRLoss only implements mean reduction')
        self.loss_weight = loss_weight
        self.to_y = to_y
        self.scale = 10.0 / math.log(10.0)

    @staticmethod
    def _rgb_to_y(x):
        if x.shape[-1] == 3:
            ch_axis = x.ndim - 1
        elif x.ndim == 4 and x.shape[1] == 3:
            ch_axis = 1
        elif x.ndim == 5 and x.shape[2] == 3:
            ch_axis = 2
        else:
            raise ValueError('to_y needs a 3-channel axis at its canonical '
                             f'position (-1, NCHW:1, NTCHW:2), got '
                             f'{tuple(x.shape)}')
        shape = [1] * x.ndim
        shape[ch_axis] = 3
        coef = torch.tensor([65.481, 128.553, 24.966], dtype=x.dtype,
                            device=x.device).view(shape)
        return ((x * coef).sum(ch_axis, keepdim=True) + 16.0) / 255.0

    def __call__(self, pred, target, weight=None):
        del weight
        if self.to_y:
            pred, target = self._rgb_to_y(pred), self._rgb_to_y(target)
        mse = (pred - target).square().mean(dim=tuple(range(1, pred.ndim)))
        return self.loss_weight * self.scale * torch.log(mse + 1e-8).mean()


def _criterion(name, axes=()):
    """The perceptual criterion ``name`` as a function of two tensors.
    ``axes``: the mesh axes whose ranks hold the rest of the batch; 'fro'
    then all-reduces its squared sum over them before the square root (the
    global batch's Frobenius norm, on every rank), while 'l1' / 'l2' stay
    this rank's means (the ranks' average is the global mean)."""
    if name == 'l1':
        return lambda a, b: (a - b).abs().mean()
    if name == 'l2':
        return lambda a, b: (a - b).square().mean()
    if name == 'fro':
        return lambda a, b: torch.sqrt(all_reduce_sum(
            (a - b).square().sum(), axes))
    raise NotImplementedError(f'{name} criterion has not been supported.')


@LOSS_REGISTRY.register()
class PerceptualLoss:
    """VGG perceptual and style (Gram matrix) loss: returns
    ``(percep or None, style or None)``, each the criterion (l1 / l2 /
    fro) of the features (or their Gram matrices) of each layer times its
    weight, summed, times ``perceptual_weight`` / ``style_weight``; 0
    switches a term off. ``gt`` takes no gradient.

    The VGG (``archs.vgg_arch.VGGFeatureExtractor``, built on the CPU)
    runs in its own dtype (fp32 unless a test casts it) outside autocast;
    the model that owns the loss moves ``vgg`` to its device. Without
    pretrained weights (``pretrain_path`` or BSVD_VGG_PRETRAIN_PATH) it is
    initialised at random and a warning is logged, as in the JAX
    package."""

    def __init__(self, layer_weights, vgg_type='vgg19', use_input_norm=True,
                 range_norm=False, perceptual_weight=1.0, style_weight=0.,
                 criterion='l1', pretrain_path=None):
        from bsvd_tpu_torch.archs.vgg_arch import VGGFeatureExtractor
        self.layer_weights = dict(layer_weights)
        self.perceptual_weight = perceptual_weight
        self.style_weight = style_weight
        self.vgg = VGGFeatureExtractor(
            layer_name_list=list(layer_weights), vgg_type=vgg_type,
            use_input_norm=use_input_norm, range_norm=range_norm,
            pretrain_path=pretrain_path)
        if not self.vgg.pretrained:
            from bsvd_tpu_torch.utils.logger import get_root_logger
            get_root_logger().warning(
                'PerceptualLoss: no pretrained VGG weights found — using '
                'random init (set BSVD_VGG_PRETRAIN_PATH for parity).')
        self.criterion_type = criterion
        self.criterion = _criterion(criterion)

    def reduce_over(self, axes):
        """Take the criterion over the global batch whose rows the ranks of
        ``axes`` hold (``_criterion``): what a data-sharded engine sets."""
        self.criterion = _criterion(self.criterion_type, axes)

    @staticmethod
    def _gram_mat(x):
        n, c, h, w = x.shape
        f = x.reshape(n, c, h * w)
        return (f @ f.transpose(1, 2)) / (c * h * w)

    def __call__(self, x, gt):
        dtype = next(self.vgg.parameters()).dtype
        with torch.autocast(x.device.type, enabled=False):
            xf = self.vgg(x.to(dtype))
            with torch.no_grad():
                gf = self.vgg(gt.detach().to(dtype))
            percep = style = None
            if self.perceptual_weight > 0:
                percep = sum(self.criterion(xf[k], gf[k])
                             * self.layer_weights[k] for k in xf)
                percep = percep * self.perceptual_weight
            if self.style_weight > 0:
                style = sum(self.criterion(self._gram_mat(xf[k]),
                                           self._gram_mat(gf[k]))
                            * self.layer_weights[k] for k in xf)
                style = style * self.style_weight
        return percep, style
