"""VideoRecurrentModel, the train and eval engine of recurrent video SR
(counterpart of bsvd_tpu/models/video_recurrent_model.py, BasicSR's
video_recurrent_model with video_base_model's per-folder validation):
SRModel's network, EMA, pixel loss and checkpoints on (N, T, C, H, W)
clips, with the flow network's schedule.

The flow network (``network_g``'s ``spynet``) has its own Adam, on the
schedule times ``train.flow_lr_mul``; the rest of the network has the
other. While ``current_iter < train.fix_flow`` the flow network takes no
gradient (its ``requires_grad`` is off, as BasicSR sets it, which also
spares its backward); at ``current_iter == fix_flow`` it trains. Both
Adams step every iteration, the frozen flow network's on zero gradients
(``models/optim.Adam`` takes a missing gradient as zeros): its moments
stay zero and its parameters still, but its count advances, so at the
unfreeze its bias correction and schedule stand at ``fix_flow`` - 1 steps
taken, as in the JAX package, whose ``optax.multi_transform`` updates
both groups every step with the flow's gradients multiplied by 0.

Validation runs each clip of the loader whole through the network (the
EMA's where there is one), computes the metrics frame by frame on uint8
images, averages them per clip folder and then over the folders, logs
them and writes them to TensorBoard. The training state carries both
Adams (the flow's under ``extra['opt_state_flow']``).
"""

import os.path as osp

import numpy as np
import torch

from bsvd_tpu_torch.losses import build_loss
from bsvd_tpu_torch.metrics import calculate_metric
from bsvd_tpu_torch.models.lr_scheduler import build_schedule
from bsvd_tpu_torch.models.sr_model import SRModel
from bsvd_tpu_torch.parallel.mesh import is_main_process, mean_over_ranks
from bsvd_tpu_torch.utils.img_util import imwrite, tensor2img
from bsvd_tpu_torch.utils.logger import get_root_logger
from bsvd_tpu_torch.utils.registry import MODEL_REGISTRY

FLOW_PREFIX = 'spynet.'


@MODEL_REGISTRY.register()
class VideoRecurrentModel(SRModel):

    def init_training_settings(self):
        train_opt = self.opt['train']
        if train_opt.get('perceptual_opt'):
            raise NotImplementedError(
                'VideoRecurrentModel trains on pixel_opt only (as the JAX '
                'package\'s, which ignores perceptual_opt)')
        self.fix_flow_iter = train_opt.get('fix_flow', 0)
        flow_lr_mul = train_opt.get('flow_lr_mul', 1)
        self._init_ema()
        self.cri_pix = build_loss(train_opt['pixel_opt'])
        self.cri_perceptual = None
        self.lr_schedule = schedule = build_schedule(train_opt)
        named = list(self.net.named_parameters())
        self.optimizer = self._adam(
            [(n, p) for n, p in named if not n.startswith(FLOW_PREFIX)],
            schedule, train_opt['optim_g'])
        self.optimizer_flow = self._adam(
            [(n, p) for n, p in named if n.startswith(FLOW_PREFIX)],
            lambda step: schedule(step) * flow_lr_mul, train_opt['optim_g'])
        if self.fix_flow_iter:
            get_root_logger().info(f'Fix flow network for the first '
                                   f'{self.fix_flow_iter} iters.')

    def feed_data(self, data):
        """lq / gt as (N, T, C, H, W) (or one (T, C, H, W) clip) numpy or
        tensors, moved to the model's device as fp32."""
        def dev(a):
            t = torch.as_tensor(np.asarray(a) if not isinstance(
                a, torch.Tensor) else a).to(self.device, torch.float32)
            return t[None] if t.ndim == 4 else t
        self.lq = dev(data['lq'])
        self.gt = dev(data['gt']) if 'gt' in data else None

    def optimize_parameters(self, current_iter):
        self.current_iter = current_iter
        frozen = bool(self.fix_flow_iter) and current_iter < self.fix_flow_iter
        for p in self.optimizer_flow.params:
            p.requires_grad_(not frozen)
        self.optimizer.zero_grad()
        self.optimizer_flow.zero_grad()
        losses = self._pixel_losses(self.net(self.lq), self.gt, '')
        sum(losses.values()).backward()
        means = mean_over_ranks(
            self.optimizer.params + self.optimizer_flow.params,
            list(losses.values()))
        self.optimizer.step()
        self.optimizer_flow.step()
        self.log_dict = dict(zip(losses, means))
        self._ema_step()

    # ---- evaluation ----------------------------------------------------
    def nondist_validation(self, dataloader, current_iter, tb_logger,
                           save_img):
        """Each clip of the loader's dataset whole: the metrics of every
        frame (uint8 images), averaged per folder in float32, then over
        the folders; logged, written to ``tb_logger`` and returned ({}
        without ``val.metrics``). Saved frames with ``save_img``. Rank 0
        runs it; the others return None."""
        if not is_main_process():
            return None
        dataset = dataloader.dataset
        dataset_name = dataset.opt['name']
        metric_opts = (self.opt.get('val') or {}).get('metrics') or {}
        results = {}
        for i in range(len(dataset)):
            item = dataset[i]
            folder = item['folder']
            self.feed_data(item)
            self.test()
            out = self.output[0]
            gt = self.gt[0].cpu().numpy()
            per_frame = np.zeros((out.shape[0], len(metric_opts)), np.float32)
            for fi in range(out.shape[0]):
                sr_img = tensor2img(out[fi])
                gt_img = tensor2img(gt[fi])
                if save_img:
                    imwrite(sr_img, osp.join(
                        self.opt['path']['visualization'], dataset_name,
                        folder, f'{fi:08d}.png'))
                for mi, mopt in enumerate(metric_opts.values()):
                    per_frame[fi, mi] = calculate_metric(
                        {'img': sr_img, 'img2': gt_img}, mopt)
            results[folder] = per_frame.mean(axis=0)
        totals = {m: float(np.mean([v[mi] for v in results.values()]))
                  for mi, m in enumerate(metric_opts)}
        get_root_logger().info(f'Validation {dataset_name}\n' + ''.join(
            f'\t # {m}: {v:.4f}\n' for m, v in totals.items()))
        if tb_logger:
            for m, v in totals.items():
                tb_logger.add_scalar(f'metrics/{m}', v, current_iter)
        return totals

    # ---- checkpoints ---------------------------------------------------
    def _training_state_extra(self):
        return {'opt_state_flow': self.optimizer_flow.state_dict()}

    def resume_training(self, resume_state):
        super().resume_training(resume_state)
        flow_state = (resume_state.get('extra') or {}).get('opt_state_flow')
        if flow_state is not None:
            self.optimizer_flow.load_state_dict(flow_state)
