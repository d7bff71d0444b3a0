"""SRGANModel and ESRGANModel, adversarial SR training (counterpart of
bsvd_tpu/models/srgan_model.py).

One step updates G, then D, as the JAX package's jitted step does:

- G: the pixel / perceptual losses and the GAN loss of D's train-mode
  forward on the fake (ESRGAN: relativistic average, against D's detached
  output on the GT); D's parameters take no gradient here. The G update
  is gated: only on iterations with ``it % net_d_iters == 0`` and ``it >
  net_d_init_iters`` does its optimizer step, so a gated iteration leaves
  G's parameters and its optimizer state (Adam's count, hence the
  schedule) as they were. The EMA moves every iteration.
- D: the GAN loss of D's train-mode forwards on the GT and the detached
  fake (``is_disc``); its optimizer steps, then the GT forward's state
  (BN batch statistics, spectral-norm vectors) is folded into D
  (``update_state``).

D's learning rate is G's schedule at D's own count times
``optim_d.lr / optim_g.lr``. On a mesh, G steps on this rank's rows and
the fakes (``parallel.mesh.gather_rows``, differentiable) and the GT rows
are gathered so that D sees the global batch on every rank, as the JAX
package's D does (its BN statistics are the global batch's); gradients and losses are
averaged over the ranks. ``save`` writes ``net_d_<iter>.npz`` beside G's,
and D's optimizer state rides the training state's ``extra``.
"""

from collections import OrderedDict

import numpy as np
import torch

from bsvd_tpu_torch.archs import build_network
from bsvd_tpu_torch.losses import build_loss
from bsvd_tpu_torch.models.lr_scheduler import build_schedule
from bsvd_tpu_torch.models.sr_model import SRModel, load_pretrained
from bsvd_tpu_torch.parallel.mesh import (all_gather, gather_rows,
                                          mean_over_ranks)
from bsvd_tpu_torch.utils.registry import MODEL_REGISTRY


@MODEL_REGISTRY.register()
class SRGANModel(SRModel):
    """Pixel + perceptual + GAN loss SR training."""

    relativistic = False

    def init_training_settings(self):
        train_opt = self.opt['train']
        self._init_ema()
        self.net_d = build_network(self.opt['network_d'], self.device)
        self.print_network(self.net_d)
        load_pretrained(self.opt, self.net_d, 'd')
        self._build_losses(train_opt)
        self.cri_gan = build_loss(train_opt['gan_opt'])
        self.net_d_iters = train_opt.get('net_d_iters', 1)
        self.net_d_init_iters = train_opt.get('net_d_init_iters', 0)
        self.lr_schedule = schedule_g = build_schedule(train_opt)
        og = train_opt['optim_g']
        od = train_opt.get('optim_d', og)
        ratio = np.float32(float(od.get('lr', og['lr'])) / float(og['lr']))

        def schedule_d(step):
            return np.float32(schedule_g(step) * ratio)
        self.optimizer = self._adam(self.net.named_parameters(),
                                    self.lr_schedule, og)
        self.optimizer_d = self._adam(self.net_d.named_parameters(),
                                      schedule_d, od)

    def _gan_g(self, fake, gt):
        """G's adversarial loss on the (global) fake batch."""
        fake_pred, _ = self.net_d.forward_stats(fake, train=True)
        if not self.relativistic:
            return self.cri_gan(fake_pred, True, is_disc=False)
        real_pred, _ = self.net_d.forward_stats(gt, train=True)
        real_pred = real_pred.detach()
        l_real = self.cri_gan(real_pred - fake_pred.mean(), False,
                              is_disc=False)
        l_fake = self.cri_gan(fake_pred - real_pred.mean(), True,
                              is_disc=False)
        return (l_real + l_fake) / 2

    def _gan_d(self, fake, gt):
        """D's losses and the state of its GT forward."""
        real_pred, state = self.net_d.forward_stats(gt, train=True)
        fake_pred, _ = self.net_d.forward_stats(fake, train=True)
        if self.relativistic:
            l_real = self.cri_gan(real_pred - fake_pred.detach().mean(), True,
                                  is_disc=True) * 0.5
            l_fake = self.cri_gan(fake_pred - real_pred.detach().mean(),
                                  False, is_disc=True) * 0.5
        else:
            l_real = self.cri_gan(real_pred, True, is_disc=True)
            l_fake = self.cri_gan(fake_pred, False, is_disc=True)
        losses = OrderedDict(l_d_real=l_real, l_d_fake=l_fake,
                             out_d_real=real_pred.detach().mean(),
                             out_d_fake=fake_pred.detach().mean())
        return losses, state

    def optimize_parameters(self, current_iter):
        self.current_iter = current_iter
        lq, gt_local = self.lq, self.gt
        gt = (all_gather(gt_local, self.mesh.axis('data'), 0)
              if self.mesh.size > 1 else gt_local)
        g_on = (current_iter % self.net_d_iters == 0
                and current_iter > self.net_d_init_iters)
        # ---- G ----
        self.net_d.requires_grad_(False)
        self.optimizer.zero_grad()
        with torch.set_grad_enabled(g_on):
            fake_local = self.net(lq)
            losses = self._pixel_losses(fake_local, gt_local, 'g_')
            fake = (gather_rows(fake_local, self.mesh.axis('data'), 0)
                    if self.mesh.size > 1 else fake_local)
            losses['l_g_gan'] = self._gan_g(fake, gt)
            if g_on:
                sum(losses.values()).backward()
        if g_on:
            g_log = self._finish(self.optimizer, losses)
        else:
            g_log = OrderedDict(zip(losses, mean_over_ranks(
                [], list(losses.values()))))
        self._ema_step()
        # ---- D ----
        self.net_d.requires_grad_(True)
        self.optimizer_d.zero_grad()
        d_losses, state = self._gan_d(fake.detach(), gt)
        (d_losses['l_d_real'] + d_losses['l_d_fake']).backward()
        d_log = self._finish(self.optimizer_d, d_losses)
        self.net_d.update_state(state)
        self.log_dict = OrderedDict(**g_log, **d_log)

    def save(self, epoch, current_iter):
        super().save(epoch, current_iter)
        self.save_network(self.net_d, 'd', current_iter)

    def _training_state_extra(self):
        return {'opt_state_d': self.optimizer_d.state_dict()}

    def resume_training(self, resume_state):
        super().resume_training(resume_state)
        d_state = (resume_state.get('extra') or {}).get('opt_state_d')
        if d_state is not None:
            self.optimizer_d.load_state_dict(d_state)


@MODEL_REGISTRY.register()
class ESRGANModel(SRGANModel):
    """The relativistic average GAN variant."""

    relativistic = True
