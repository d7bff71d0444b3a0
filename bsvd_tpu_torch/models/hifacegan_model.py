"""HiFaceGANModel, face renovation training (counterpart of
bsvd_tpu/models/hifacegan_model.py): the SPADE generator against the
conditional multiscale discriminator, with pixel, perceptual, multiscale
GAN and feature-matching losses. An SRModel through SRGANModel, whose
optimizers, learning rates, checkpoints and resume it keeps.

One step, as the JAX package's jitted step:

- G: fake = G(lq); the discriminator sees (lq, fake) and (lq, gt),
  concatenated along channels, as ONE batch (fake rows first), split by
  ``divide_pred``; its spectral-norm vectors of that pass are dropped.
  G steps only when ``it % net_d_iters == 0 and it > net_d_init_iters``:
  a gated iteration leaves G's parameters and Adam's moments and count as
  they were (the losses are still computed and logged).
- D: the same fake, made by the G before its update and detached; D's
  loss is (real + fake) / 2; after D's optimizer step the power-iteration
  vectors of this pass are stored (``update_state``).

D's learning rate is G's schedule at D's own count times ``optim_d.lr /
optim_g.lr``. ``train.ema_decay > 0`` raises NotImplementedError, as in
the JAX package. On a mesh each rank steps on its own rows: every loss is
a mean over equal shards and the discriminator normalises per sample, so
the mean of the ranks' gradients is the global batch's.
"""

from collections import OrderedDict

import torch

from bsvd_tpu_torch.losses import build_loss
from bsvd_tpu_torch.models.srgan_model import SRGANModel
from bsvd_tpu_torch.parallel.mesh import mean_over_ranks
from bsvd_tpu_torch.utils.logger import get_root_logger
from bsvd_tpu_torch.utils.registry import MODEL_REGISTRY


def divide_pred(pred):
    """Split a (fake; real) batched prediction (a tensor, or a list of
    per-discriminator feature lists) into its fake and real halves."""
    if isinstance(pred, (list, tuple)):
        return ([[t[:t.shape[0] // 2] for t in p] for p in pred],
                [[t[t.shape[0] // 2:] for t in p] for p in pred])
    return pred[:pred.shape[0] // 2], pred[pred.shape[0] // 2:]


@MODEL_REGISTRY.register()
class HiFaceGANModel(SRGANModel):
    """Face renovation: SPADE generator vs conditional multiscale D."""

    def init_training_settings(self):
        train_opt = self.opt['train']
        if train_opt.get('ema_decay', 0) > 0:
            raise NotImplementedError('HiFaceGAN does not support EMA now.')
        super().init_training_settings()
        self.cri_feat = (build_loss(train_opt['feature_matching_opt'])
                         if train_opt.get('feature_matching_opt') else None)
        if self.cri_pix is None and self.cri_perceptual is None:
            raise ValueError('Both pixel and perceptual losses are None.')
        get_root_logger().info(
            'HiFaceGAN: conditional multiscale D, '
            f'feat-matching={"on" if self.cri_feat else "off"}')

    def discriminate(self, lq, output, gt):
        """(fake prediction, real prediction, spectral-norm vectors) of one
        pass over the (lq, output); (lq, gt) batch."""
        both = torch.cat([torch.cat([lq, output], 1),
                          torch.cat([lq, gt], 1)], 0)
        pred, us = self.net_d.forward_stats(both, train=True)
        return divide_pred(pred) + (us,)

    def optimize_parameters(self, current_iter):
        self.current_iter = current_iter
        lq, gt = self.lq, self.gt
        g_on = (current_iter % self.net_d_iters == 0
                and current_iter > self.net_d_init_iters)
        # ---- G ----
        self.net_d.requires_grad_(False)
        self.optimizer.zero_grad()
        with torch.set_grad_enabled(g_on):
            fake = self.net(lq)
            losses = self._pixel_losses(fake, gt, 'g_')
            pred_fake, pred_real, _ = self.discriminate(lq, fake, gt)
            losses['l_g_gan'] = self.cri_gan(pred_fake, True, is_disc=False)
            if self.cri_feat is not None:
                losses['l_g_feat'] = self.cri_feat(pred_fake, pred_real)
            if g_on:
                sum(losses.values()).backward()
        g_log = (self._finish(self.optimizer, losses) if g_on
                 else OrderedDict(zip(losses, mean_over_ranks(
                     [], list(losses.values())))))
        # ---- D: the same fake ----
        self.net_d.requires_grad_(True)
        self.optimizer_d.zero_grad()
        pred_fake, pred_real, us = self.discriminate(lq, fake.detach(), gt)
        d_losses = OrderedDict(
            l_d_real=self.cri_gan(pred_real, True, is_disc=True),
            l_d_fake=self.cri_gan(pred_fake, False, is_disc=True))
        ((d_losses['l_d_real'] + d_losses['l_d_fake']) / 2).backward()
        d_log = self._finish(self.optimizer_d, d_losses)
        self.net_d.update_state(us)
        self.log_dict = OrderedDict(**g_log, **d_log)
