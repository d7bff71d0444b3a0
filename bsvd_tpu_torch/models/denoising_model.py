"""DenoisingModel, the training half (counterpart of bsvd_tpu/models/
denoising_model.py: init_training_settings, _build_optimizer, feed_data,
optimize_parameters, save, make_train_step).

It takes an options dict (what ``bsvd_tpu.utils.options.parse_options``
returns for a train YAML; the card's machine has no PyYAML) and a device.
One step: the TSN forward with autograd through the kernels' Functions,
the pixel loss in fp32, the backward (K7 weight gradients), the optax-exact
Adam update, then the EMA. With ``train.fp16`` the forward and backward
run in bf16 while the master parameters, the loss, the optimizer state and
the EMA stay fp32 (the JAX package's AMP).

Not ported here: norm='bn' (the network raises), the perceptual loss (the
zoo), validation and test (the eval protocol), data / spatial meshes.
"""

import torch

from bsvd_tpu_torch.archs import build_network
from bsvd_tpu_torch.archs.wnet_arch import _map_tree
from bsvd_tpu_torch.losses import build_loss
from bsvd_tpu_torch.models.base_model import BaseModel
from bsvd_tpu_torch.models.lr_scheduler import build_schedule
from bsvd_tpu_torch.models.optim import Adam
from bsvd_tpu_torch.utils.registry import MODEL_REGISTRY


def make_train_step(net, optimizer, cri_pix, amp=False):
    """The step ``(batch, ema_params, ema_decay) -> {'l_pix': loss}`` over
    ``net``'s parameters, updated in place by ``optimizer``; ``batch``
    holds 'lq' and 'gt' (N, T, H, W, C) on the parameters' device."""
    def step(batch, ema_params=None, ema_decay=0.0):
        optimizer.zero_grad()
        out = net.train_forward(batch['lq'], amp=amp)
        l_pix = cri_pix(out, batch['gt'].float())
        l_pix.backward()
        optimizer.step()
        if ema_params is not None:
            BaseModel.ema_update(ema_params, net.param_tree(), ema_decay)
        return {'l_pix': l_pix.detach()}

    return step


@MODEL_REGISTRY.register()
class DenoisingModel(BaseModel):
    """Video denoising train engine: MIMO training of the TSN with the
    temporal shift, on ``device`` (default: the options' ``device``, else
    'cuda')."""

    def __init__(self, opt, device=None):
        super().__init__(opt)
        self.device = torch.device(device or opt.get('device', 'cuda'))
        net = build_network(opt['network_g'])
        self.cfg = net.cfg
        path = opt.get('path') or {}
        load_path = path.get('pretrain_network_g')
        if load_path is not None:
            key = path.get('param_key_g', 'params')
            net.load_params(self.load_network(
                load_path, None if key == 'None' else key,
                path.get('strict_load_g', True)))
        self.net = net.to(self.device)
        self.ema_params = None
        if self.is_train:
            self.init_training_settings()

    def init_training_settings(self):
        train_opt = self.opt['train']
        self.ema_decay = train_opt.get('ema_decay', 0)
        if self.ema_decay > 0:
            load_path = (self.opt.get('path') or {}).get('pretrain_network_g')
            if load_path is not None:
                ema = self.load_network(load_path, 'params_ema',
                                        self.opt['path'].get('strict_load_g',
                                                             True))
                self.ema_params = _map_tree(
                    ema, lambda t: t.to(self.device, torch.float32))
            else:
                self.ema_params = _map_tree(self.net.param_tree(),
                                            torch.clone)
        if train_opt.get('perceptual_opt'):
            raise NotImplementedError('perceptual_opt: the VGG loss comes '
                                      'with the zoo (ROADMAP.md Queue 1)')
        if not train_opt.get('pixel_opt'):
            raise ValueError('Both pixel and perceptual losses are None.')
        self.cri_pix = build_loss(train_opt['pixel_opt'])
        self.lr_schedule = build_schedule(train_opt)
        self.optimizer = self._build_optimizer(train_opt)
        self.amp = bool(train_opt.get('fp16', False))
        self._train_step = make_train_step(self.net, self.optimizer,
                                           self.cri_pix, amp=self.amp)

    def _build_optimizer(self, train_opt):
        optim_opt = dict(train_opt['optim_g'])
        if optim_opt.pop('type') != 'Adam':
            raise NotImplementedError('only Adam / AdamW are ported')
        clip = (float(train_opt.get('gradient_clipping', 5))
                if train_opt.get('use_grad_clip', False) else None)
        return Adam(self.net.named_parameters(), self.lr_schedule,
                    betas=optim_opt.get('betas', (0.9, 0.999)),
                    weight_decay=optim_opt.get('weight_decay', 0),
                    max_grad_norm=clip)

    def feed_data(self, data):
        """Host or device arrays: lq / gt (N, F, C, H, W), noise_map
        (N, F, 1, H, W) or absent (blind)."""
        def dev(a):
            return torch.as_tensor(a).to(self.device, non_blocking=True)
        self.lq = dev(data['lq'])
        self.noise_map = dev(data['noise_map']) if 'noise_map' in data \
            else None
        self.gt = dev(data['gt']) if 'gt' in data else None

    def optimize_parameters(self, current_iter):
        self.current_iter = current_iter
        lq = self.lq if self.noise_map is None else torch.cat(
            [self.lq, self.noise_map.to(self.lq.dtype)], dim=2)
        batch = {'lq': lq.permute(0, 1, 3, 4, 2).contiguous(),
                 'gt': self.gt.permute(0, 1, 3, 4, 2).contiguous()}
        self.log_dict = self._train_step(batch, self.ema_params,
                                         self.ema_decay)

    def test(self):
        raise NotImplementedError('test / validation wait for the eval '
                                  'protocol (ROADMAP.md Queue 1 item 4)')

    def validation(self, *args, **kwargs):
        self.test()

    def save(self, epoch, current_iter):
        params = self.net.param_tree()
        if self.ema_params is not None:
            self.save_network([params, self.ema_params], 'g', current_iter,
                              param_key=['params', 'params_ema'])
        else:
            self.save_network(params, 'g', current_iter)
        self.save_training_state(epoch, current_iter,
                                 opt_state=self.optimizer.state_dict())


def build_model(opt, device=None):
    """A registered model from the options dict ({'model_type': ...})."""
    return MODEL_REGISTRY.get(opt['model_type'])(opt, device=device)
