"""Paired LQ / GT images of the SR family (counterpart of
bsvd_tpu/data/paired_image_dataset.py): items of float32 (C, H, W) RGB in
[0, 1] (or normalised by the options' ``mean`` / ``std``), read with
``FileClient`` (from folders, a meta-info file's names, or two lmdb
stores under the client keys 'lq' and 'gt') and ``imfrombytes``; train
items are cropped by
``gt_size`` and flipped / rotated, val items have GT cut to LQ x scale.

One ``random.Random(manual_seed)`` per dataset draws every crop and flip,
as in the JAX package, so items come out the same bits in the same
order. For that reason the dataset does not set
``supports_parallel_read``: the batch loader reads its items one after
another. ``skip(index)`` makes an item's draws without decoding it (the
sizes read from the files' headers): the loader of one rank skips the
other ranks' rows of the global batch."""

import random

import numpy as np

from bsvd_tpu_torch.data.data_util import (paired_paths_from_folders,
                                           paired_paths_from_lmdb,
                                           paired_paths_from_meta_info_file)
from bsvd_tpu_torch.data.transforms import (augment, crop_origin,
                                            flip_draws, paired_random_crop)
from bsvd_tpu_torch.utils import img_util
from bsvd_tpu_torch.utils.file_client import FileClient
from bsvd_tpu_torch.utils.registry import DATASET_REGISTRY


@DATASET_REGISTRY.register()
class PairedImageDataset:
    """opt keys: dataroot_gt, dataroot_lq, io_backend{type}, scale, phase,
    gt_size, use_hflip, use_rot, filename_tmpl, meta_info_file, mean, std,
    manual_seed."""

    def __init__(self, opt):
        self.opt = opt
        self.io_backend_opt = dict(opt.get('io_backend') or {'type': 'disk'})
        self.mean = opt.get('mean')
        self.std = opt.get('std')
        self.gt_folder, self.lq_folder = opt['dataroot_gt'], opt['dataroot_lq']
        self.filename_tmpl = opt.get('filename_tmpl', '{}')
        if self.io_backend_opt.get('type', 'disk') == 'lmdb':
            self.io_backend_opt['db_paths'] = [self.lq_folder,
                                               self.gt_folder]
            self.io_backend_opt['client_keys'] = ['lq', 'gt']
            self.paths = paired_paths_from_lmdb(
                [self.lq_folder, self.gt_folder], ['lq', 'gt'])
        elif opt.get('meta_info_file') is not None:
            self.paths = paired_paths_from_meta_info_file(
                [self.lq_folder, self.gt_folder], ['lq', 'gt'],
                opt['meta_info_file'], self.filename_tmpl)
        else:
            self.paths = paired_paths_from_folders(
                [self.lq_folder, self.gt_folder], ['lq', 'gt'],
                self.filename_tmpl)
        self._client = None
        self._rng = random.Random(opt.get('manual_seed'))

    @property
    def file_client(self):
        if self._client is None:
            opt = dict(self.io_backend_opt)
            self._client = FileClient(opt.pop('type', 'disk'), **opt)
        return self._client

    def __getitem__(self, index):
        scale = self.opt.get('scale', 1)
        gt_path = self.paths[index]['gt_path']
        lq_path = self.paths[index]['lq_path']
        # img_util is read at call time: it imports this package itself
        img_gt = img_util.imfrombytes(self.file_client.get(gt_path, 'gt'),
                                      float32=True)
        img_lq = img_util.imfrombytes(self.file_client.get(lq_path, 'lq'),
                                      float32=True)
        if self.opt.get('phase') == 'train':
            img_gt, img_lq = paired_random_crop(
                img_gt, img_lq, self.opt['gt_size'], scale, gt_path,
                rng=self._rng)
            img_gt, img_lq = augment([img_gt, img_lq],
                                     self.opt.get('use_hflip', True),
                                     self.opt.get('use_rot', True),
                                     rng=self._rng)
        else:
            h, w = img_lq.shape[0:2]
            img_gt = img_gt[0:h * scale, 0:w * scale, :]
        gt, lq = img_util.img2tensor(img_gt), img_util.img2tensor(img_lq)
        if self.mean is not None:
            mean = np.asarray(self.mean, np.float32).reshape(-1, 1, 1)
            std = np.asarray(self.std, np.float32).reshape(-1, 1, 1)
            gt = (gt - mean) / std
            lq = (lq - mean) / std
        return {'lq': lq, 'gt': gt, 'lq_path': lq_path, 'gt_path': gt_path}

    def skip(self, index):
        """The RNG draws of ``self[index]`` (train: the crop's and the
        flips'), without decoding its images."""
        if self.opt.get('phase') != 'train':
            return
        gt_path = self.paths[index]['gt_path']
        sizes = [img_util.imsize(self.file_client.get(
            self.paths[index][f'{k}_path'], k)) for k in ('gt', 'lq')]
        crop_origin(*sizes, self.opt['gt_size'], self.opt.get('scale', 1),
                    gt_path, self._rng)
        flip_draws(self.opt.get('use_hflip', True),
                   self.opt.get('use_rot', True), self._rng)

    def __len__(self):
        return len(self.paths)
