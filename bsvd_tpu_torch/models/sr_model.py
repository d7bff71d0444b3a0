"""SRModel, the single-image SR train and eval engine (counterpart of
bsvd_tpu/models/sr_model.py): ``network_g`` on ``device`` (the options'
``device``, else the card), the pixel and perceptual losses, the
optax-exact Adam of ``models/optim`` on the schedule of
``models/lr_scheduler`` (Adam only, as in the JAX package), an EMA copy
of the network (``net_g_ema``) with ``train.ema_decay``.

On a mesh (``num_gpu`` ranks under torchrun, ``parallel.mesh.make_mesh``)
every rank is fed its own rows of the global batch (the loader of
``data.build_dataloader`` decodes those rows only), steps on them, and
the gradients and losses are averaged over the ranks in one
``all_reduce`` of one buffer, so the parameters stay the same bits on
every rank: the JAX package's data-sharded jitted step. A perceptual
criterion 'fro' is the global batch's norm (its squared sums all-reduced
before the square root, ``losses.PerceptualLoss.reduce_over``).
Validation runs on rank 0.

Network files are ``.npz`` in the JAX package's tree layout
(``convert.torch_generic``), ``params`` and, with an EMA, ``params_ema``;
a BasicSR ``.pth`` loads as a pretrained network too.
"""

import copy
from collections import OrderedDict
from os import path as osp

import numpy as np
import torch

from bsvd_tpu_torch.archs import build_network
from bsvd_tpu_torch.convert.torch_generic import load_torch_generic
from bsvd_tpu_torch.losses import build_loss
from bsvd_tpu_torch.metrics import calculate_metric
from bsvd_tpu_torch.models.base_model import BaseModel
from bsvd_tpu_torch.models.lr_scheduler import build_schedule
from bsvd_tpu_torch.models.optim import Adam
from bsvd_tpu_torch.parallel.mesh import (is_main_process, make_mesh,
                                          mean_over_ranks)
from bsvd_tpu_torch.utils.img_util import imwrite, tensor2img
from bsvd_tpu_torch.utils.logger import get_root_logger
from bsvd_tpu_torch.utils.registry import MODEL_REGISTRY


def load_pretrained(opt, net, label):
    """Load ``path.pretrain_network_<label>`` (``param_key_<label>``,
    ``strict_load_<label>``) into ``net`` where the options name one."""
    path = opt.get('path') or {}
    load_path = path.get(f'pretrain_network_{label}')
    if load_path is not None:
        key = path.get(f'param_key_{label}', 'params')
        load_torch_generic(load_path, net, None if key == 'None' else key,
                           path.get(f'strict_load_{label}', True))


@MODEL_REGISTRY.register()
class SRModel(BaseModel):

    def __init__(self, opt, device=None):
        super().__init__(opt)
        self.device = torch.device(device or opt.get('device', 'cuda'))
        self.net = build_network(opt['network_g'], self.device)
        self.print_network(self.net)
        load_pretrained(opt, self.net, 'g')
        self.net_g_ema = None
        self.ema_decay = 0
        self.mesh = make_mesh(opt.get('num_gpu', 'auto'))
        self.lq = self.gt = self.output = None
        if self.is_train:
            self.init_training_settings()

    # ---- training ------------------------------------------------------
    def _init_ema(self):
        """net_g_ema: a copy of the network, or the pretrained file's
        ``params_ema`` where it has them (as BasicSR loads it)."""
        self.ema_decay = self.opt['train'].get('ema_decay', 0)
        if self.ema_decay > 0:
            get_root_logger().info(f'Use EMA with decay: {self.ema_decay}')
            self.net_g_ema = copy.deepcopy(self.net)
            load_path = (self.opt.get('path') or {}).get('pretrain_network_g')
            if load_path is not None and str(load_path).endswith('.npz'):
                with np.load(load_path) as z:
                    has_ema = any(k.startswith('params_ema/')
                                  for k in z.files)
                if has_ema:
                    load_torch_generic(load_path, self.net_g_ema,
                                       'params_ema')
            self.net_g_ema.requires_grad_(False)

    def _build_losses(self, train_opt):
        self.cri_pix = (build_loss(train_opt['pixel_opt'])
                        if train_opt.get('pixel_opt') else None)
        self.cri_perceptual = (build_loss(train_opt['perceptual_opt'])
                               if train_opt.get('perceptual_opt') else None)
        if self.cri_perceptual is not None:
            self.cri_perceptual.vgg.to(self.device)
            # 'fro': the global batch's norm, its squared sums all-reduced
            self.cri_perceptual.reduce_over((self.mesh.axis('data'),))

    @staticmethod
    def _adam(named_params, schedule, optim_opt):
        optim_opt = dict(optim_opt)
        if optim_opt.pop('type') != 'Adam':
            raise NotImplementedError(f'optimizer {optim_opt} is not '
                                      f'supported yet (Adam only)')
        return Adam([(n, p) for n, p in named_params if p.requires_grad],
                    schedule, betas=optim_opt.get('betas', (0.9, 0.999)))

    def init_training_settings(self):
        train_opt = self.opt['train']
        self._init_ema()
        self._build_losses(train_opt)
        if self.cri_pix is None and self.cri_perceptual is None:
            raise ValueError('Both pixel and perceptual losses are None.')
        self.lr_schedule = build_schedule(train_opt)
        self.optimizer = self._adam(self.net.named_parameters(),
                                    self.lr_schedule,
                                    train_opt['optim_g'])

    def feed_data(self, data):
        """lq / gt as (N, C, H, W) (or one (C, H, W) image) numpy or
        tensors, moved to the model's device as fp32; on a mesh, this
        rank's rows of the global batch."""
        def dev(a):
            t = torch.as_tensor(np.asarray(a) if not isinstance(
                a, torch.Tensor) else a).to(self.device, torch.float32)
            return t[None] if t.ndim == 3 else t
        self.lq = dev(data['lq'])
        self.gt = dev(data['gt']) if 'gt' in data else None

    def _pixel_losses(self, out, gt, prefix):
        """{name: loss} of the pixel and perceptual criteria."""
        losses = OrderedDict()
        if self.cri_pix is not None:
            losses[f'l_{prefix}pix'] = self.cri_pix(out, gt)
        if self.cri_perceptual is not None:
            percep, style = self.cri_perceptual(out, gt)
            if percep is not None:
                losses[f'l_{prefix}percep'] = percep
            if style is not None:
                losses[f'l_{prefix}style'] = style
        return losses

    def _finish(self, optimizer, losses):
        """Average gradients and losses over the ranks, step; returns the
        averaged losses."""
        means = mean_over_ranks(optimizer.params, list(losses.values()))
        optimizer.step()
        return OrderedDict(zip(losses, means))

    def optimize_parameters(self, current_iter):
        self.current_iter = current_iter
        self.optimizer.zero_grad()
        losses = self._pixel_losses(self.net(self.lq), self.gt, '')
        sum(losses.values()).backward()
        self.log_dict = self._finish(self.optimizer, losses)
        self._ema_step()

    def _ema_step(self):
        if self.net_g_ema is not None:
            BaseModel.ema_update(dict(self.net_g_ema.named_parameters()),
                                 dict(self.net.named_parameters()),
                                 self.ema_decay)

    # ---- evaluation ----------------------------------------------------
    def test(self):
        """``self.output``: the EMA network's (else the network's) output
        of the fed lq, numpy fp32."""
        net = self.net_g_ema if self.net_g_ema is not None else self.net
        with torch.no_grad():
            self.output = net(self.lq).float().cpu().numpy()

    def validation(self, dataloader, current_iter, tb_logger, save_img=False):
        return self.nondist_validation(dataloader, current_iter, tb_logger,
                                       save_img)

    def nondist_validation(self, dataloader, current_iter, tb_logger,
                           save_img):
        """Each image of the loader: test, uint8 images, the metrics'
        averages (logged, to ``tb_logger`` and returned; None without
        ``val.metrics``), saved results with ``save_img``. Rank 0 runs it;
        the others return None."""
        if not is_main_process():
            return None
        dataset_name = dataloader.dataset.opt['name']
        metrics = (self.opt.get('val') or {}).get('metrics')
        results = {m: 0.0 for m in metrics} if metrics is not None else None
        cnt = 0
        for val_data in dataloader:
            lq_path = val_data['lq_path']
            img_name = osp.splitext(osp.basename(
                lq_path[0] if isinstance(lq_path, list) else lq_path))[0]
            self.feed_data(val_data)
            self.test()
            sr_img = tensor2img(self.output[0])
            gt_img = (tensor2img(self.gt[0].cpu().numpy())
                      if self.gt is not None else None)
            if save_img:
                imwrite(sr_img, osp.join(self.opt['path']['visualization'],
                                         dataset_name,
                                         f"{img_name}_{self.opt['name']}.png"))
            if results is not None and gt_img is not None:
                for name, opt_ in metrics.items():
                    results[name] += calculate_metric(
                        {'img': sr_img, 'img2': gt_img}, opt_)
            cnt += 1
        if results is None or not cnt:
            return None
        for m in results:
            results[m] /= cnt
        get_root_logger().info(f'Validation {dataset_name}\n' + ''.join(
            f'\t # {m}: {v:.4f}\n' for m, v in results.items()))
        if tb_logger:
            for m, v in results.items():
                tb_logger.add_scalar(f'metrics/{m}', v, current_iter)
        return results

    def get_current_visuals(self):
        out = OrderedDict(lq=self.lq.cpu().numpy(), result=self.output)
        if self.gt is not None:
            out['gt'] = self.gt.cpu().numpy()
        return out

    # ---- checkpoints ---------------------------------------------------
    def _training_state_extra(self):
        return None

    def save(self, epoch, current_iter):
        if self.net_g_ema is not None:
            self.save_network([self.net, self.net_g_ema], 'g', current_iter,
                              param_key=['params', 'params_ema'])
        else:
            self.save_network(self.net, 'g', current_iter)
        self.save_training_state(epoch, current_iter,
                                 opt_state=self.optimizer.state_dict(),
                                 extra=self._training_state_extra())


@MODEL_REGISTRY.register()
class SwinIRModel(SRModel):
    """SwinIR's engine: SRModel's (counterpart of bsvd_tpu/models/
    sr_model.py:184). BasicSR's swinir_model only pads the test input to
    window multiples, which the port's SwinIR does in its forward."""
