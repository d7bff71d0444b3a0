"""DenoisingModel (counterpart of bsvd_tpu/models/denoising_model.py): the
training half (init_training_settings, _build_optimizer, feed_data,
optimize_parameters, save, make_train_step) and the eval half (padding,
test, the serial validation with its metrics, images and per-scene CSVs).

It takes an options dict (what ``bsvd_tpu.utils.options.parse_options``
returns for a train YAML; the card's machine has no PyYAML) and a device.
One step: the TSN forward with autograd through the kernels' Functions,
the pixel loss in fp32, the backward (K7 weight gradients), the optax-exact
Adam update, the BN running statistics (norm 'bn'), then the EMA (over
the running statistics too, as the JAX package's tree-wide EMA). With
``train.fp16`` the forward and backward run in bf16 while the master
parameters, the loss, the optimizer state and the EMA stay fp32 (the JAX
package's AMP); norm 'bn' ignores it, with the JAX package's warning.

Evaluation: ``test`` denoises the fed clip by ``val``'s protocol
(``temp_psz`` / ``future_buffer_len``, ``streaming_eval``, ``fp16`` as
bf16), with the EMA parameters when they exist; ``validation`` scores each
clip of a dataset (PSNR / SSIM on uint8 images, float PSNR) and writes its
frames and per-scene CSVs.

On a mesh (``num_gpu`` ranks launched by torchrun, ``parallel.spatial``
of them splitting the rows; ``parallel.mesh.make_mesh``): each rank steps
on its shard and the gradients and the loss are averaged over every rank
in one ``all_reduce``, so every rank applies the same update; validation
shares the folders out over a data mesh and writes its CSVs and log on
rank 0 (``validation``).

With ``train.perceptual_opt`` the step adds the VGG perceptual (and
style) loss of the fp32 output against the target, frames flattened to
(N*T, C, H, W), the VGG in fp32 outside autocast (``losses.
PerceptualLoss``); with the rows split the ranks gather their rows first
(``parallel.mesh.gather_rows``), so the VGG sees whole frames.

Norms on a mesh: BN's statistics are those of the global batch (over
both axes) and 'in''s those of the whole frame (over 'spatial'), pooled by
one differentiable all-reduce a site (``nn.layers.norm_apply``), as the
JAX package's GSPMD step computes them; every rank then folds the same
global statistics into the running ones.
"""

import csv
import time
from collections import OrderedDict
from os import path as osp

import numpy as np
import torch
import torch.nn.functional as F

from bsvd_tpu_torch.archs import build_network
from bsvd_tpu_torch.archs.wnet_arch import (_map_tree, prepare_params,
                                            wnet_apply)
from bsvd_tpu_torch.losses import build_loss
from bsvd_tpu_torch.metrics import calculate_metric
from bsvd_tpu_torch.models.base_model import BaseModel
from bsvd_tpu_torch.models.lr_scheduler import build_schedule
from bsvd_tpu_torch.models.optim import Adam
from bsvd_tpu_torch.models.seq_inference import denoise_seq
from bsvd_tpu_torch.nn.layers import bn_update
from bsvd_tpu_torch.parallel.mesh import (all_gather, gather_objects,
                                          gather_rows, is_main_process,
                                          make_mesh, mean_over_ranks,
                                          norm_axes)
from bsvd_tpu_torch.parallel.spatial import _local_forward, spatial_ok
from bsvd_tpu_torch.utils.img_util import imwrite, tensor2img
from bsvd_tpu_torch.utils.logger import get_root_logger
from bsvd_tpu_torch.utils.registry import MODEL_REGISTRY


def _check_equal_shards(batch):
    """A mean of the ranks' mean losses is the global mean only when the
    ranks' shards are of one size: raise where they are not."""
    shapes = gather_objects(tuple(batch['lq'].shape))
    if len(set(shapes)) != 1:
        raise ValueError(f'train step on a mesh: the ranks\' batches differ '
                         f'in shape {shapes}; the averaged loss would not be '
                         f'the global mean')


def _frames_nchw(x):
    """(N, T, H, W, C) -> (N*T, C, H, W) for the VGG."""
    return x.reshape(-1, *x.shape[-3:]).permute(0, 3, 1, 2)


def make_train_step(net, optimizer, cri_pix, amp=False, mesh=None,
                    cri_perceptual=None):
    """The step ``(batch, ema_params, ema_decay) -> {'l_pix': loss, ...}``
    over ``net``'s parameters, updated in place by ``optimizer``; ``batch``
    holds 'lq' and 'gt' (N, T, H, W, C) on the parameters' device.
    ``cri_perceptual`` (a ``losses.PerceptualLoss``) adds 'l_percep' /
    'l_style' on the fp32 output's frames, ``gt`` taking no gradient. With
    norm 'bn' the forward runs BN on the batch's statistics, and once the
    optimizer has stepped they are folded into the module's running
    statistics (bsvd_tpu make_train_step's bn_fold_running_stats), which
    no optimizer touches.

    ``mesh`` (a ``parallel.mesh.Mesh`` of more than one rank): ``batch``
    is this rank's shard (``parallel.mesh.shard_batch``: batch over
    'data', rows over 'spatial'). Each rank runs forward and backward on
    it (the halo-exchange forward ``parallel.spatial._local_forward`` with
    the rows split, its pixel loss over its own rows), then the gradients
    and the loss are averaged over both axes in one all_reduce and every
    rank applies the same optax-exact Adam and EMA, so the parameters stay
    the same bits on every rank. A norm's statistics are the global
    batch's (``parallel.mesh.norm_axes``), so BN's running statistics are
    the same bits on every rank too."""
    cfg = net.cfg
    bn = cfg.norm == 'bn'
    sharded = mesh is not None and mesh.size > 1
    n_sp = mesh.shape['spatial'] if mesh is not None else 1
    axes = norm_axes(cfg.norm, mesh) if sharded else ()
    checked = []

    def forward(x, stats):
        if n_sp == 1:
            return net.train_forward(x, amp=amp, bn_stats=stats, apply=lambda
                                     p, v, c, s: wnet_apply(p, v, c, s, axes))
        hg = x.shape[2] * n_sp
        if not spatial_ok(cfg, hg, mesh, norms=True):
            raise ValueError(f'spatial train step: H {hg} is not a multiple '
                             f'of 4 x {n_sp} (parallel.spatial.spatial_ok)')
        axis = mesh.axis('spatial')
        return net.train_forward(x, amp=amp, bn_stats=stats, apply=lambda
                                 p, v, c, s: _local_forward(
                                     p, v, c, hg, axis, bn_stats=s,
                                     axes=axes))

    def step(batch, ema_params=None, ema_decay=0.0):
        if sharded and not checked:
            _check_equal_shards(batch)
            checked.append(True)
        optimizer.zero_grad()
        stats = [] if bn else None
        out = forward(batch['lq'], stats)
        gt = batch['gt'].float()
        losses = OrderedDict()
        if cri_pix is not None:
            losses['l_pix'] = cri_pix(out, gt)
        if cri_perceptual is not None:
            out32 = out.float()
            if n_sp > 1:
                axis = mesh.axis('spatial')
                out32 = gather_rows(out32, axis, 2)
                gt = all_gather(gt, axis, 2)
            percep, style = cri_perceptual(_frames_nchw(out32),
                                           _frames_nchw(gt))
            if percep is not None:
                losses['l_percep'] = percep
            if style is not None:
                losses['l_style'] = style
        sum(losses.values()).backward()
        if sharded:
            losses = OrderedDict(zip(losses, mean_over_ranks(
                optimizer.params, list(losses.values()))))
        optimizer.step()
        if bn:
            bn_update(stats)
        if ema_params is not None:
            BaseModel.ema_update(ema_params, net.param_tree(), ema_decay)
        return OrderedDict((k, v.detach()) for k, v in losses.items())

    return step


@MODEL_REGISTRY.register()
class DenoisingModel(BaseModel):
    """Video denoising train engine: MIMO training of the TSN with the
    temporal shift, on ``device`` (default: the options' ``device``, else
    'cuda'), over the mesh of ``num_gpu`` ranks with ``parallel.spatial``
    of them on the rows (JAX denoising_model.py:249-252)."""

    def __init__(self, opt, device=None):
        super().__init__(opt)
        self.device = torch.device(device or opt.get('device', 'cuda'))
        net = build_network(opt['network_g'], self.device)
        self.cfg = net.cfg
        self.print_network(net)
        path = opt.get('path') or {}
        load_path = path.get('pretrain_network_g')
        if load_path is not None:
            key = path.get('param_key_g', 'params')
            net.load_params(self.load_network(
                load_path, None if key == 'None' else key,
                path.get('strict_load_g', True)))
        self.net = net
        par = dict(opt.get('parallel') or {})
        self.mesh = make_mesh(opt.get('num_gpu', 'auto'),
                              spatial=int(par.get('spatial', 1)))
        self.ema_params = None
        self.center_frame_only = opt.get('center_frame_only', False)
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
        self.cri_pix = self.cri_perceptual = None
        if train_opt.get('pixel_opt'):
            self.cri_pix = build_loss(train_opt['pixel_opt'])
        if train_opt.get('perceptual_opt'):
            self.cri_perceptual = build_loss(train_opt['perceptual_opt'])
            self.cri_perceptual.vgg.to(self.device)
        if self.cri_pix is None and self.cri_perceptual is None:
            raise ValueError('Both pixel and perceptual losses are None.')
        self.lr_schedule = build_schedule(train_opt)
        self.optimizer = self._build_optimizer(train_opt)
        self.amp = bool(train_opt.get('fp16', False))
        if self.amp and self.cfg.norm == 'bn':
            get_root_logger().warning(
                'train.fp16 ignored for norm=bn (BN batch stats stay fp32, '
                'matching autocast BN policy)')
            self.amp = False
        self._train_step = make_train_step(
            self.net, self.optimizer, self.cri_pix, amp=self.amp,
            mesh=self.mesh, cri_perceptual=self.cri_perceptual)

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
        """One step on the fed batch. On a spatial mesh the fed batch is
        this rank's rows of the global batch (the loader's ``rank``): the
        ranks of one data row gather theirs (the JAX data shard) and each
        keeps its rows of H."""
        self.current_iter = current_iter
        lq = self.lq if self.noise_map is None else torch.cat(
            [self.lq, self.noise_map.to(self.lq.dtype)], dim=2)
        batch = {'lq': lq.permute(0, 1, 3, 4, 2).contiguous(),
                 'gt': self.gt.permute(0, 1, 3, 4, 2).contiguous()}
        if self.mesh.shape['spatial'] > 1:
            sp = self.mesh.axis('spatial')
            batch = {k: all_gather(v, sp, 0) for k, v in batch.items()}
            h = batch['lq'].shape[2] // sp.size
            batch = {k: v[:, :, sp.index * h:(sp.index + 1) * h].contiguous()
                     for k, v in batch.items()}
        self.log_dict = self._train_step(batch, self.ema_params,
                                         self.ema_decay)

    # ---- eval --------------------------------------------------------------
    def padding_input(self, seq):
        """Reflect-pad H and W of a (T, C, H, W) tensor to multiples of 16
        (the JAX package's eval padding, denoising_model.py:361-377; the
        reference pads to 4). Returns (padded, padding_list)."""
        window_size = 16
        h, w = seq.shape[-2:]
        mod_pad_h = (window_size - h % window_size) % window_size
        mod_pad_w = (window_size - w % window_size) % window_size
        padded = F.pad(torch.as_tensor(seq), (0, mod_pad_w, 0, mod_pad_h),
                       mode='reflect')
        return padded, [0, mod_pad_w, 0, mod_pad_h, 0, 0]

    def crop_output(self, padding_list):
        pad_w1, pad_w2, pad_h1, pad_h2, tp1, tp2 = padding_list
        _, f, _, h, w = self.output.shape
        self.output = self.output[:, tp1:f - tp2, :, pad_h1:h - pad_h2,
                                  pad_w1:w - pad_w2]

    def test(self):
        """Denoise the fed clip into ``self.output`` ((1, T, C, H, W) numpy
        fp32) by ``val``'s protocol: reflect padding, ``temp_psz`` /
        ``future_buffer_len``, ``streaming_eval``, ``fp16`` (bf16), the EMA
        parameters when they exist.

        ``val.reference_ema_branch: true`` with an EMA: the reference's EMA
        branch (denoising_model.py:170-178), one plain forward of the EMA
        parameters on the unpadded input, no chunking and no clamp."""
        val_opt = self.opt.get('val') or {}
        dtype = torch.bfloat16 if val_opt.get('fp16', False) else \
            torch.float32
        if (self.ema_params is not None
                and val_opt.get('reference_ema_branch', False)):
            x = self.lq if self.lq.ndim == 5 else self.lq[None]
            if self.noise_map is not None:
                nm = self.noise_map
                x = torch.cat([x, (nm if nm.ndim == 5 else nm[None]).to(
                    x.dtype)], dim=2)
            p = prepare_params(self.ema_params, self.device, dtype)
            with torch.no_grad():
                out = wnet_apply(p, x.to(dtype).permute(0, 1, 3, 4, 2),
                                 self.cfg)
            self.output = out.permute(0, 1, 4, 2, 3).float().cpu().numpy()
            return
        # val items are (1, T, C, H, W): drop the batch axis
        lq = self.lq[0] if self.lq.ndim == 5 else self.lq
        padded_lq, padding_list = self.padding_input(lq)
        sigma = None
        if self.noise_map is not None:
            sigma = float(self.noise_map.reshape(-1)[0])
        params = self.ema_params if self.ema_params is not None else self.net
        out = denoise_seq(
            params, self.cfg, padded_lq, noise_sigma=sigma,
            temp_psz=val_opt.get('temp_psz', -1),
            future_buffer_len=val_opt.get('future_buffer_len', 0),
            mode='streaming' if val_opt.get('streaming_eval', False)
            else 'mimo', compute_dtype=dtype, mesh=self.mesh)
        self.output = out[None]
        self.crop_output(padding_list)

    def validation(self, dataloader, current_iter, tb_logger, save_img=False):
        """Score every clip of ``dataloader.dataset``; returns the metrics'
        averages over clips (None where ``val`` names no metrics, and on
        ranks other than 0 of a mesh). Every rank of a mesh calls it."""
        return self.nondist_validation(dataloader, current_iter, tb_logger,
                                       save_img)

    def _val_share(self, num_folders):
        """How this rank takes part in a validation on the mesh: (ranks
        the folders are shared out over, this rank's index among them,
        whether it scores and writes what it denoises), or None where it
        sits out.

        - a data mesh (more than one rank, no split rows) with the whole
          clip protocol and more than one folder: folder i goes to data
          rank i % data (the JAX package's round-robin over its data
          devices, one rank per card here); each rank scores and writes
          its folders;
        - split rows: every rank denoises every folder (the forward is
          collective); rank 0 scores and writes;
        - any other mesh of more than one rank: rank 0 alone, as the
          JAX package validates on its main process.
        """
        mesh, main = self.mesh, is_main_process()
        if mesh.size == 1:
            return 1, 0, True
        val_opt = self.opt.get('val') or {}
        if mesh.shape['spatial'] > 1:
            return 1, 0, main
        if val_opt.get('temp_psz', -1) == -1 and num_folders > 1:
            return mesh.shape['data'], mesh.coords['data'], True
        return (1, 0, True) if main else None

    def _folder_metrics(self, result, gt, folder, dataset_name, save_img,
                        with_metrics):
        """Per-frame uint8 conversion, image saving and metric sums for one
        clip (reference denoising_model.py:260-316). Adds host seconds to
        ``self.val_seconds``."""
        if self.center_frame_only:
            mid = result.shape[0] // 2
            result, gt = result[mid:mid + 1], gt[mid:mid + 1]
        metrics = list(self.opt['val']['metrics'].values()) \
            if with_metrics else []
        secs = self.val_seconds
        for idx in range(result.shape[0]):
            t0 = time.perf_counter()
            result_img, gt_img = tensor2img(result[idx]), tensor2img(gt[idx])
            t1 = time.perf_counter()
            if save_img:
                imwrite(result_img, osp.join(
                    self.opt['path']['visualization'], dataset_name, folder,
                    f"{idx:08d}_{self.opt['name']}.png"))
            t2 = time.perf_counter()
            for m_idx, opt_ in enumerate(metrics):
                data = ({'img_float': result[idx], 'img2_float': gt[idx]}
                        if 'float' in opt_['type']
                        else {'img': result_img, 'img2': gt_img})
                self.metric_results[folder][idx, m_idx] += \
                    calculate_metric(data, opt_)
            secs['metrics'] += t1 - t0 + time.perf_counter() - t2
            secs['save'] += t2 - t1

    def nondist_validation(self, dataloader, current_iter, tb_logger,
                           save_img):
        """The validation: each clip read, denoised by ``test`` and scored
        in turn (on a mesh, the clips ``_val_share`` gives this rank, the
        per-folder metric arrays then gathered to rank 0, which writes the
        CSVs and the log line as a serial run does). ``self.val_seconds``
        holds this call's host seconds by part (read, denoise, metrics,
        save). Without ``val.metrics`` the clips are still denoised (and
        saved) and no metric is logged, as in BasicSR; the JAX package
        raises there (ROADMAP.md Queue 3)."""
        dataset = dataloader.dataset
        dataset_name = dataset.opt['name']
        share = self._val_share(len(dataset))
        if share is None:
            return None
        ranks, mine_at, scores = share
        metrics = (self.opt.get('val') or {}).get('metrics')
        with_metrics = metrics is not None
        if with_metrics:
            # center_frame_only scores one frame per clip
            self.metric_results = {
                folder: np.zeros((1 if self.center_frame_only
                                  else dataset.num_frames[index],
                                  len(metrics)), np.float32)
                for index, folder in enumerate(dataset.base_folder)}
        self.val_seconds = dict.fromkeys(('read', 'denoise', 'metrics',
                                          'save'), 0.0)
        logger = get_root_logger()
        mine = []
        for i in range(mine_at, len(dataset), ranks):
            t0 = time.perf_counter()
            val_data = dataset[i]
            t1 = time.perf_counter()
            # the scores read gt on the host: only lq and the map go over
            self.feed_data({k: val_data[k] for k in ('lq', 'noise_map')
                            if k in val_data})
            self.test()                     # ends in a device synchronise
            self.val_seconds['read'] += t1 - t0
            self.val_seconds['denoise'] += time.perf_counter() - t1
            folder = val_data['folder']
            mine.append(folder)
            if scores:
                self._folder_metrics(self.output[0],
                                     np.asarray(val_data['gt'])[0], folder,
                                     dataset_name, save_img, with_metrics)
            logger.info(f'Tested {folder} ({i + 1}/{len(dataset)})')
        if with_metrics and ranks > 1:
            # each folder's scores from the rank that denoised it
            for theirs in gather_objects(
                    {f: self.metric_results[f] for f in mine}):
                self.metric_results.update(theirs)
        if not with_metrics or not is_main_process():
            return None
        return self._log_validation_metric_values(current_iter, dataset_name,
                                                  tb_logger)

    def _log_validation_metric_values(self, current_iter, dataset_name,
                                      tb_logger):
        """Per-scene per-frame CSVs in path.log (``<dataset>_<folder>.csv``:
        an index column, then ``<folder>_<m>`` for metric m, as pandas'
        ``to_csv`` writes them in the JAX package), the log line, the
        TensorBoard scalars; returns the averages over clips."""
        logger = get_root_logger()
        avg = {folder: arr.mean(axis=0)
               for folder, arr in self.metric_results.items()}
        log_dir = self.opt['path'].get('log')
        if log_dir:
            for folder, arr in self.metric_results.items():
                with open(osp.join(log_dir, f'{dataset_name}_{folder}.csv'),
                          'w', newline='') as f:
                    out = csv.writer(f)
                    out.writerow([''] + [f'{folder}_{m}'
                                         for m in range(arr.shape[1])])
                    for r, row in enumerate(arr):
                        out.writerow([r] + [str(v) for v in row])
        metrics = list(self.opt['val']['metrics'].keys())
        total = {m: sum(float(a[i]) for a in avg.values()) / max(len(avg), 1)
                 for i, m in enumerate(metrics)}
        log_str = f'Validation {dataset_name}\n'
        for m_idx, (metric, value) in enumerate(total.items()):
            log_str += f'\t # {metric}: {value:.4f}'
            for folder, a in avg.items():
                log_str += f'\t # {folder}: {a[m_idx]:.4f}'
            log_str += '\n'
        logger.info(log_str)
        if tb_logger:
            for m_idx, (metric, value) in enumerate(total.items()):
                tb_logger.add_scalar(f'metrics/{metric}', value, current_iter)
                for folder, a in avg.items():
                    tb_logger.add_scalar(f'metrics/{metric}/{folder}',
                                         float(a[m_idx]), current_iter)
        return total

    def get_current_visuals(self):
        """The fed clip and its result as numpy: 'lq', 'result' and, where
        a target was fed, 'gt' (bsvd_tpu denoising_model.py:614); outside
        training, a fed (1, T, C, H, W) clip loses its batch axis, as the
        JAX package's feed_data drops it."""
        def host(t):
            a = t.cpu().numpy()
            return a[0] if a.ndim == 5 and not self.is_train else a
        out = OrderedDict()
        out['lq'] = host(self.lq)
        out['result'] = np.asarray(self.output)
        if self.gt is not None:
            out['gt'] = host(self.gt)
        return out

    def save(self, epoch, current_iter):
        params = self.net.param_tree()
        if self.ema_params is not None:
            self.save_network([params, self.ema_params], 'g', current_iter,
                              param_key=['params', 'params_ema'])
        else:
            self.save_network(params, 'g', current_iter)
        self.save_training_state(epoch, current_iter,
                                 opt_state=self.optimizer.state_dict())
