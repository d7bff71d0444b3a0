"""VideoBaseModel and EDVRModel, the sliding-window video restoration
engines (counterpart of bsvd_tpu/models/video_base_model.py, BasicSR's
video_base_model and edvr_model).

- ``VideoBaseModel``: SRModel's network, EMA, loss and checkpoints on
  (N, T, C, H, W) windows whose centre frame the network restores; its
  validation runs the loader's dataset item by item (a window each, as
  ``VideoTestDataset`` gives them), computes the metrics on uint8
  images, averages them per clip folder and then over the folders (in
  float64, as the JAX package's ``np.mean`` of Python floats), logs them
  and writes them to TensorBoard.
- ``EDVRModel``: the pixel loss, and two Adams on the schedule: one for
  the ``pcd_align`` subtree (all of it, as the JAX package labels it) at
  ``train.dcn_lr_mul`` times the schedule, one for the rest. With
  ``train.tsa_iter``, iterations 1 .. tsa_iter - 1 train ``fusion`` only:
  every other parameter takes no gradient (``requires_grad`` off, which
  also spares its backward), but both Adams step every iteration (a
  missing gradient counts as zeros), so at the unfreeze their counts,
  bias corrections and schedules stand where the JAX package's
  ``multi_transform`` with gradients multiplied by 0 puts them. The
  training state carries both Adams (the DCN one's under
  ``extra['opt_state_dcn']``).
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

DCN_PREFIX = 'pcd_align.'
TSA_PREFIX = 'fusion.'


@MODEL_REGISTRY.register()
class VideoBaseModel(SRModel):
    """Windows in, centre frames out."""

    def feed_data(self, data):
        """lq (N, T, C, H, W) (or one (T, C, H, W) window) and gt (N, C,
        H', W') (or one (C, H', W') frame), numpy or tensors, to the
        model's device as fp32."""
        def dev(a, ndim):
            t = torch.as_tensor(np.asarray(a) if not isinstance(
                a, torch.Tensor) else a).to(self.device, torch.float32)
            return t[None] if t.ndim == ndim - 1 else t
        self.lq = dev(data['lq'], 5)
        self.gt = dev(data['gt'], 4) if 'gt' in data else None

    def nondist_validation(self, dataloader, current_iter, tb_logger,
                           save_img):
        """Each item of the loader's dataset: the restored centre frame's
        metrics, averaged per folder, then over the folders; logged, to
        ``tb_logger`` and returned ({} without ``val.metrics`` or GT).
        Saved frames (``<frame>_<name>.png`` under the folder) with
        ``save_img``. Rank 0 runs it; the others return None."""
        if not is_main_process():
            return None
        dataset = dataloader.dataset
        dataset_name = dataset.opt['name']
        metric_opts = (self.opt.get('val') or {}).get('metrics') or {}
        folder_results = {}
        for i in range(len(dataset)):
            item = dataset[i]
            folder = item['folder']
            self.feed_data(item)
            self.test()
            sr_img = tensor2img(self.output[0])
            if save_img:
                frame_idx = item.get('idx', f'{i}').split('/')[0]
                imwrite(sr_img, osp.join(
                    self.opt['path']['visualization'], dataset_name, folder,
                    f"{frame_idx}_{self.opt['name']}.png"))
            if metric_opts and self.gt is not None:
                gt_img = tensor2img(self.gt[0].cpu().numpy())
                folder_results.setdefault(folder, []).append(
                    [calculate_metric({'img': sr_img, 'img2': gt_img}, mopt)
                     for mopt in metric_opts.values()])
        if not folder_results:
            return {}
        per_folder = [np.mean(v, axis=0) for v in folder_results.values()]
        totals = {m: float(np.mean([v[mi] for v in per_folder]))
                  for mi, m in enumerate(metric_opts)}
        get_root_logger().info(f'Validation {dataset_name}\n' + ''.join(
            f'\t # {m}: {v:.4f}\n' for m, v in totals.items()))
        if tb_logger:
            for m, v in totals.items():
                tb_logger.add_scalar(f'metrics/{m}', v, current_iter)
        return totals


@MODEL_REGISTRY.register()
class EDVRModel(VideoBaseModel):

    def init_training_settings(self):
        train_opt = self.opt['train']
        if train_opt.get('perceptual_opt'):
            raise NotImplementedError(
                'EDVRModel trains on pixel_opt only (as the JAX package\'s, '
                'which ignores perceptual_opt)')
        logger = get_root_logger()
        self.tsa_iter = train_opt.get('tsa_iter', 0)
        dcn_lr_mul = train_opt.get('dcn_lr_mul', 1)
        if dcn_lr_mul != 1:
            logger.info(f'Multiple the learning rate for dcn with '
                        f'{dcn_lr_mul}.')
        self._init_ema()
        self.cri_pix = build_loss(train_opt['pixel_opt'])
        self.cri_perceptual = None
        self.lr_schedule = schedule = build_schedule(train_opt)
        named = list(self.net.named_parameters())
        self.optimizer = self._adam(
            [(n, p) for n, p in named if not n.startswith(DCN_PREFIX)],
            schedule, train_opt['optim_g'])
        self.optimizer_dcn = self._adam(
            [(n, p) for n, p in named if n.startswith(DCN_PREFIX)],
            lambda step: schedule(step) * dcn_lr_mul, train_opt['optim_g'])
        self.outside_tsa = [p for n, p in named if not n.startswith(
            TSA_PREFIX)]
        if self.tsa_iter:
            logger.info(f'Only train TSA module for {self.tsa_iter} iters.')

    def optimize_parameters(self, current_iter):
        self.current_iter = current_iter
        warm = bool(self.tsa_iter) and current_iter < self.tsa_iter
        for p in self.outside_tsa:
            p.requires_grad_(not warm)
        self.optimizer.zero_grad()
        self.optimizer_dcn.zero_grad()
        losses = self._pixel_losses(self.net(self.lq), self.gt, '')
        sum(losses.values()).backward()
        means = mean_over_ranks(
            self.optimizer.params + self.optimizer_dcn.params,
            list(losses.values()))
        self.optimizer.step()
        self.optimizer_dcn.step()
        self.log_dict = dict(zip(losses, means))
        self._ema_step()

    # ---- checkpoints ---------------------------------------------------
    def _training_state_extra(self):
        return {'opt_state_dcn': self.optimizer_dcn.state_dict()}

    def resume_training(self, resume_state):
        super().resume_training(resume_state)
        dcn_state = (resume_state.get('extra') or {}).get('opt_state_dcn')
        if dcn_state is not None:
            self.optimizer_dcn.load_state_dict(dcn_state)
