"""GAN losses and regularisers (counterpart of bsvd_tpu/losses/
gan_loss.py): GANLoss (vanilla, lsgan, wgan, wgan_softplus, hinge),
MultiScaleGANLoss, GANFeatLoss, r1_penalty, gradient_penalty_loss and
StyleGAN2's g_path_regularize. The penalties differentiate through the
discriminator with ``torch.autograd.grad`` (``create_graph``, so their
own gradient reaches its parameters)."""

import math

import torch
import torch.nn.functional as F

from bsvd_tpu_torch.losses.losses import CharbonnierLoss, L1Loss, MSELoss
from bsvd_tpu_torch.parallel.mesh import all_reduce_sum
from bsvd_tpu_torch.utils.registry import LOSS_REGISTRY

GAN_TYPES = ('vanilla', 'lsgan', 'wgan', 'wgan_softplus', 'hinge')


def _bce_with_logits(logits, target):
    """Binary cross-entropy with logits, in the JAX package's stable form."""
    return (logits.clamp(min=0) - logits * target
            + torch.log1p(torch.exp(-logits.abs()))).mean()


@LOSS_REGISTRY.register()
class GANLoss:
    """vanilla | lsgan | wgan | wgan_softplus | hinge; the generator's loss
    (``is_disc`` False) is multiplied by ``loss_weight``, the
    discriminator's is not."""

    def __init__(self, gan_type, real_label_val=1.0, fake_label_val=0.0,
                 loss_weight=1.0):
        if gan_type not in GAN_TYPES:
            raise NotImplementedError(f'GAN type {gan_type} is not '
                                      f'implemented.')
        self.gan_type = gan_type
        self.real_label_val = real_label_val
        self.fake_label_val = fake_label_val
        self.loss_weight = loss_weight

    def _target(self, x, target_is_real):
        return torch.full_like(x, self.real_label_val if target_is_real
                               else self.fake_label_val)

    def __call__(self, x, target_is_real, is_disc=False):
        t = self.gan_type
        if t == 'vanilla':
            loss = _bce_with_logits(x, self._target(x, target_is_real))
        elif t == 'lsgan':
            loss = (x - self._target(x, target_is_real)).square().mean()
        elif t == 'wgan':
            loss = -x.mean() if target_is_real else x.mean()
        elif t == 'wgan_softplus':
            loss = F.softplus(-x if target_is_real else x).mean()
        elif is_disc:                                   # hinge
            loss = F.relu(1 + (-x if target_is_real else x)).mean()
        else:
            loss = -x.mean()
        return loss if is_disc else loss * self.loss_weight


@LOSS_REGISTRY.register()
class MultiScaleGANLoss(GANLoss):
    """GANLoss averaged over a list of predictions (of a list, its
    last)."""

    def __call__(self, x, target_is_real, is_disc=False):
        if isinstance(x, (list, tuple)):
            total = 0.0
            for pred in x:
                if isinstance(pred, (list, tuple)):
                    pred = pred[-1]
                total = total + super().__call__(pred, target_is_real,
                                                 is_disc)
            return total / len(x)
        return super().__call__(x, target_is_real, is_disc)


def _input_grad(fn, x):
    x = x.detach().requires_grad_(True)
    out = fn(x)
    return torch.autograd.grad(out.sum(), x, create_graph=True)[0]


def r1_penalty(disc_fn, real_img):
    """R1: mean over images of |grad of sum(D(x)) w.r.t. x|^2 on real
    images."""
    grad = _input_grad(disc_fn, real_img)
    return grad.square().sum(dim=tuple(range(1, grad.ndim))).mean()


def gradient_penalty_loss(disc_fn, real_data, fake_data, generator=None,
                          weight=None):
    """WGAN-GP: mean of (|grad D(interp)| - 1)^2 on interpolates by alpha
    ~ U(0, 1) per image, drawn from ``generator`` (the JAX package takes a
    key); ``weight`` weights the gradient and divides by its mean."""
    shape = (real_data.shape[0],) + (1,) * (real_data.ndim - 1)
    alpha = torch.rand(shape, generator=generator, dtype=real_data.dtype,
                       device='cpu' if generator is None
                       else generator.device).to(real_data.device)
    interp = alpha * real_data + (1 - alpha) * fake_data
    grad = _input_grad(disc_fn, interp)
    if weight is not None:
        grad = grad * weight
    norm = torch.sqrt(grad.square().sum(dim=tuple(range(1, grad.ndim)))
                      + 1e-12)
    loss = (norm - 1).square().mean()
    if weight is not None:
        loss = loss / weight.mean()
    return loss


def g_path_regularize(gen_fn, latents, mean_path_length, generator=None,
                      decay=0.01, noise=None, axes=()):
    """StyleGAN2's path-length regulariser: (penalty, path lengths, the
    new running mean). The probe noise is ``noise`` (a normal draw of the
    image's shape) where given, else drawn from ``generator``. Latents
    that carry a graph (the mapping net's output) keep it: the penalty's
    gradient then reaches what made them, as in the JAX package's step.
    ``axes``: mesh axes whose ranks hold the rest of the path batch (equal
    shares). Each mean over the batch is then the global batch's, through
    one all-reduce of its sum (the same bits on every rank): with 2-D
    latents (the mapping net's codes) the one path length's mean of
    squares, so every rank computes the global penalty; with a path length
    a sample, their mean, and the penalty is this rank's mean, which the
    ranks' average makes the global one."""
    if not latents.requires_grad:
        latents = latents.detach().requires_grad_(True)
    img = gen_fn(latents)
    if noise is None:
        noise = torch.randn(img.shape, generator=generator, dtype=img.dtype,
                            device='cpu' if generator is None
                            else generator.device).to(img.device)
    noise = noise / (img.shape[-2] * img.shape[-1]) ** 0.5
    grad = torch.autograd.grad((img * noise).sum(), latents,
                               create_graph=True)[0]
    sq = grad.square().sum(-1)
    ranks = math.prod(a.size for a in axes)

    def global_mean(v):         # over dim 0, the batch
        return all_reduce_sum(v.sum(0), axes) / (v.shape[0] * ranks)
    if ranks > 1 and sq.dim() == 1:
        path_lengths = torch.sqrt(global_mean(sq) + 1e-12)
    else:
        path_lengths = torch.sqrt(sq.mean(-1) + 1e-12)
    mean = global_mean(path_lengths) if ranks > 1 and path_lengths.dim() \
        else path_lengths.mean()
    path_mean = mean_path_length + decay * (mean - mean_path_length)
    penalty = (path_lengths - path_mean).square().mean()
    return penalty, path_lengths, path_mean


@LOSS_REGISTRY.register()
class GANFeatLoss:
    """Feature matching over multi-scale discriminator intermediates: for
    each discriminator, the criterion (l1 / l2 / charbonnier) between fake
    and detached real features of every layer but the last, over the
    number of discriminators, times ``loss_weight``."""

    def __init__(self, criterion='l1', loss_weight=1.0, reduction='mean'):
        ops = {'l1': L1Loss, 'l2': MSELoss, 'charbonnier': CharbonnierLoss}
        if criterion not in ops:
            raise ValueError(f'Unsupported loss mode: {criterion}. '
                             'Supported ones are: l1|l2|charbonnier')
        self.loss_op = ops[criterion](loss_weight, reduction)
        self.loss_weight = loss_weight

    def __call__(self, pred_fake, pred_real):
        num_d = len(pred_fake)
        loss = 0.0
        for i in range(num_d):
            for j in range(len(pred_fake[i]) - 1):
                loss = loss + self.loss_op(pred_fake[i][j],
                                           pred_real[i][j].detach()) / num_d
        return loss * self.loss_weight
