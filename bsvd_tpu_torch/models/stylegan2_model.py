"""StyleGAN2Model (counterpart of bsvd_tpu/models/stylegan2_model.py): the
non-saturating GAN with lazy regularisation, style mixing and an EMA
generator.

Each iteration a D step, then a G step, as the JAX package runs them:

- D: fakes of the current G (no gradient) and the real batch; with
  ``iter % net_d_reg_every == 0`` also R1 on the real batch, added as
  ``r1_reg_weight / 2 * l_r1 * net_d_reg_every``.
- G: the GAN loss of D on new fakes; with ``iter % net_g_reg_every == 0``
  also the path-length penalty on ``max(1, batch // 2)`` new latents
  (through the mapping net), added as ``path_reg_weight *
  net_g_reg_every * l_path``; the running mean path length is carried
  state. Then the EMA copy (``net_g_ema``) moves, by ``train.ema_decay``
  (default ``0.5 ** (32 / 10000)``).
- Adam at ``lr * ratio`` with betas ``(0 ** ratio, 0.99 ** ratio)``,
  ratio = every / (every + 1) of each net.

Every random draw comes from one ``torch.Generator`` on the device, seeded
by ``manual_seed``, in ``draws_d`` / ``draws_g``: two styles per batch
(the second replaced by the first unless ``rand < mixing_prob``, a device
select), per-layer noise, and for the path penalty its latents' codes, its
images' noise and its probe noise. Save writes ``net_g`` (``params``,
``params_ema``), ``net_d`` and the two optimizers, with
``mean_path_length`` as extra state. Out of training (``is_train``
false) the model samples from the loaded weights (``path.param_key_g``,
e.g. ``params_ema``). On more than one rank it raises
NotImplementedError.
"""

import copy
from collections import OrderedDict

import numpy as np
import torch

from bsvd_tpu_torch.archs import build_network
from bsvd_tpu_torch.losses import build_loss
from bsvd_tpu_torch.losses.gan_loss import g_path_regularize, r1_penalty
from bsvd_tpu_torch.models.base_model import BaseModel
from bsvd_tpu_torch.models.optim import Adam
from bsvd_tpu_torch.models.sr_model import load_pretrained
from bsvd_tpu_torch.parallel.mesh import make_mesh
from bsvd_tpu_torch.utils.registry import MODEL_REGISTRY


@MODEL_REGISTRY.register()
class StyleGAN2Model(BaseModel):

    def __init__(self, opt, device=None):
        super().__init__(opt)
        self.device = torch.device(device or opt.get('device', 'cuda'))
        self.mesh = make_mesh(opt.get('num_gpu', 'auto'))
        if self.mesh.size > 1:
            raise NotImplementedError(
                f'StyleGAN2Model on {self.mesh.size} ranks: the port trains '
                f'it on one device')
        self.net = build_network(opt['network_g'], self.device)
        self.print_network(self.net)
        load_pretrained(opt, self.net, 'g')
        # out of training: sample from the loaded weights
        self.net_g_ema = self.net
        self.num_style_feat = opt['network_g'].get('num_style_feat', 512)
        self.rng = torch.Generator(self.device).manual_seed(
            int(opt.get('manual_seed', 0)))
        if self.is_train:
            self.init_training_settings()

    def init_training_settings(self):
        train_opt = self.opt['train']
        self.net_d = build_network(self.opt['network_d'], self.device)
        self.print_network(self.net_d)
        load_pretrained(self.opt, self.net_d, 'd')
        self.net_g_ema = copy.deepcopy(self.net).requires_grad_(False)
        self.cri_gan = build_loss(train_opt['gan_opt'])
        self.r1_reg_weight = train_opt['r1_reg_weight']
        self.path_reg_weight = train_opt['path_reg_weight']
        self.net_g_reg_every = train_opt['net_g_reg_every']
        self.net_d_reg_every = train_opt['net_d_reg_every']
        self.mixing_prob = train_opt['mixing_prob']
        self.mean_path_length = torch.zeros((), device=self.device)
        self.ema_decay = train_opt.get('ema_decay', 0.5 ** (32 / (10 * 1000)))
        self.optimizer = self._adam(self.net, train_opt['optim_g'],
                                    self.net_g_reg_every)
        self.lr_schedule = self.optimizer.schedule
        self.optimizer_d = self._adam(self.net_d, train_opt['optim_d'],
                                      self.net_d_reg_every)

    @staticmethod
    def _adam(net, optim_opt, every):
        if optim_opt.get('type', 'Adam') != 'Adam':
            raise NotImplementedError(f'optimizer {optim_opt} is not '
                                      f'supported yet (Adam only)')
        ratio = every / (every + 1)
        lr = np.float32(float(optim_opt['lr']) * ratio)
        return Adam(list(net.named_parameters()), lambda step: lr,
                    betas=(0 ** ratio, 0.99 ** ratio))

    # ---- random draws ---------------------------------------------------
    def _normal(self, *shape):
        return torch.randn(shape, generator=self.rng, device=self.device)

    def sample_styles(self, batch):
        """Two style codes; the second is the first unless the draw mixes
        (chosen on the device, no read back)."""
        mix = torch.rand((), generator=self.rng,
                         device=self.device) < self.mixing_prob
        n1 = self._normal(batch, self.num_style_feat)
        n2 = self._normal(batch, self.num_style_feat)
        return [n1, torch.where(mix, n2, n1)]

    def draws_d(self, batch):
        """The D step's draws: styles and noise of its fakes."""
        return {'styles': self.sample_styles(batch),
                'noise': self.net.make_noise(batch, self.rng)}

    def draws_g(self, batch, do_path):
        """The G step's draws; with ``do_path`` also the path penalty's
        codes (``path_z``), its images' noise and its probe noise."""
        d = {'styles': self.sample_styles(batch),
             'noise': self.net.make_noise(batch, self.rng)}
        if do_path:
            n = max(1, batch // 2)
            size = self.net.out_size
            d.update(path_z=self._normal(n, self.num_style_feat),
                     path_noise=self.net.make_noise(n, self.rng),
                     path_probe=self._normal(n, 3, size, size))
        return d

    # ---- training -------------------------------------------------------
    def feed_data(self, data):
        gt = data['gt']
        gt = torch.as_tensor(gt if isinstance(gt, torch.Tensor)
                             else np.asarray(gt))
        self.real_img = gt.to(self.device, torch.float32)

    def _d_step(self, real, do_r1, draws):
        with torch.no_grad():
            fake, _ = self.net(draws['styles'], noise=draws['noise'])
        self.net_d.requires_grad_(True)
        self.optimizer_d.zero_grad()
        fake_pred = self.net_d(fake)
        real_pred = self.net_d(real)
        l_d = (self.cri_gan(real_pred, True, is_disc=True)
               + self.cri_gan(fake_pred, False, is_disc=True))
        if do_r1:
            l_r1 = r1_penalty(self.net_d, real)
            l_d = l_d + self.r1_reg_weight / 2 * l_r1 * self.net_d_reg_every
        else:
            l_r1 = torch.zeros((), device=self.device)
        l_d.backward()
        self.optimizer_d.step()
        return OrderedDict(l_d=l_d.detach(), l_d_r1=l_r1.detach(),
                           real_score=real_pred.detach().mean(),
                           fake_score=fake_pred.detach().mean())

    def _g_step(self, do_path, draws):
        self.net_d.requires_grad_(False)
        self.optimizer.zero_grad()
        fake, _ = self.net(draws['styles'], noise=draws['noise'])
        l_g = self.cri_gan(self.net_d(fake), True, is_disc=False)
        logs = OrderedDict(l_g=l_g)            # the GAN term, as JAX logs
        if do_path:
            latents = self.net.get_latent(draws['path_z'])
            l_path, _, new_mean = g_path_regularize(
                lambda lat: self.net([lat], input_is_latent=True,
                                     noise=draws['path_noise'])[0],
                latents, self.mean_path_length, noise=draws['path_probe'])
            l_g = l_g + self.path_reg_weight * self.net_g_reg_every * l_path
            self.mean_path_length = new_mean.detach()
            logs['l_g_path'] = l_path
        else:
            logs['l_g_path'] = torch.zeros((), device=self.device)
        l_g.backward()
        self.optimizer.step()
        BaseModel.ema_update(dict(self.net_g_ema.named_parameters()),
                             dict(self.net.named_parameters()),
                             self.ema_decay)
        return OrderedDict((k, v.detach()) for k, v in logs.items())

    def optimize_parameters(self, current_iter):
        self.current_iter = current_iter
        batch = self.real_img.shape[0]
        do_r1 = current_iter % self.net_d_reg_every == 0
        d_logs = self._d_step(self.real_img, do_r1, self.draws_d(batch))
        do_path = current_iter % self.net_g_reg_every == 0
        g_logs = self._g_step(do_path, self.draws_g(batch, do_path))
        self.log_dict = OrderedDict(**d_logs, **g_logs)

    # ---- sampling -------------------------------------------------------
    def test(self, num_samples=16, generator=None):
        """``self.output``: num_samples images of the EMA generator (the
        loaded one out of training), noise drawn too, numpy fp32 NCHW in
        [-1, 1]; draws from ``generator`` (default: seeded 0)."""
        gen = generator or torch.Generator(self.device).manual_seed(0)
        z = torch.randn(num_samples, self.num_style_feat, generator=gen,
                        device=self.device)
        with torch.no_grad():
            img, _ = self.net_g_ema([z], generator=gen)
        self.output = img.float().cpu().numpy()
        return self.output

    def validation(self, dataloader, current_iter, tb_logger, save_img=False):
        del dataloader, current_iter, tb_logger, save_img
        self.test()
        return {}

    # ---- checkpoints ----------------------------------------------------
    def save(self, epoch, current_iter):
        self.save_network([self.net, self.net_g_ema], 'g', current_iter,
                          param_key=['params', 'params_ema'])
        self.save_network(self.net_d, 'd', current_iter)
        # the path-length mean is kept across resumes (BasicSR drops it)
        self.save_training_state(
            epoch, current_iter,
            opt_state=(self.optimizer.state_dict(),
                       self.optimizer_d.state_dict()),
            extra={'mean_path_length': self.mean_path_length})

    def resume_training(self, resume_state):
        opt_state = resume_state.get('opt_state')
        if opt_state is not None:
            g_state, d_state = opt_state
            self.optimizer.load_state_dict(g_state)
            self.optimizer_d.load_state_dict(d_state)
        mpl = (resume_state.get('extra') or {}).get('mean_path_length')
        if mpl is not None:
            self.mean_path_length = torch.as_tensor(
                mpl, dtype=torch.float32).to(self.device)
