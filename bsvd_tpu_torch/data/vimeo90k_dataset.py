"""Vimeo90K training datasets (counterpart of bsvd_tpu/data/
vimeo90k_dataset.py, BasicSR's vimeo90k_dataset): septuplets
``<root>/<clip>/<seq>/im1.png .. im7.png`` named by a meta-info file.

- ``Vimeo90KDataset``: the ``num_frame`` middle LQ frames -> the centre
  GT frame ``im4``;
- ``Vimeo90KRecurrentDataset``: the same LQ frames -> their GT frames,
  with ``flip_sequence`` the clip and its reverse.

Frames are read through the file client and ``imfrombytes`` (BGR, float
[0, 1], turned by their EXIF orientation as cv2 turns them), paired-
cropped and flipped, and returned as float32 RGB (T, C, H, W) / (C, H,
W). One ``random.Random(manual_seed)`` draws in the JAX package's order
(the reversal with ``random_reverse``, the crop's two ``randint``s, the
three flips), so a seed gives the same items; ``skip`` makes an item's
draws from the frames' headers without decoding them (the other ranks'
rows on a mesh). On lmdb the LQ and GT roots are two stores under the
client keys 'lq' and 'gt', a frame's key ``<clip>/<seq>/im<i>`` (what
``create_lmdb`` gives a ``sequences`` folder).
"""

import os
import random

import numpy as np

from bsvd_tpu_torch.data.transforms import (augment, crop_origin,
                                            flip_draws, paired_random_crop)
from bsvd_tpu_torch.utils.file_client import FileClient
from bsvd_tpu_torch.utils.img_util import imfrombytes, img2tensor, imsize
from bsvd_tpu_torch.utils.registry import DATASET_REGISTRY


@DATASET_REGISTRY.register()
class Vimeo90KDataset:
    """opt: dataroot_gt, dataroot_lq, meta_info_file, io_backend,
    num_frame, gt_size, scale, random_reverse, use_hflip, use_rot,
    manual_seed. Items: lq (num_frame, 3, h, w), gt (3, H, W), key
    ('<clip>/<seq>')."""

    def __init__(self, opt):
        self.opt = opt
        self.gt_root, self.lq_root = opt['dataroot_gt'], opt['dataroot_lq']
        with open(opt['meta_info_file'], 'r') as fin:
            self.keys = [line.split(' ')[0] for line in fin]
        self.io_backend_opt = dict(opt.get('io_backend') or {'type': 'disk'})
        self.is_lmdb = self.io_backend_opt.get('type') == 'lmdb'
        if self.is_lmdb:
            self.io_backend_opt['db_paths'] = [self.lq_root, self.gt_root]
            self.io_backend_opt['client_keys'] = ['lq', 'gt']
        self.neighbor_list = [i + (9 - opt['num_frame']) // 2
                              for i in range(opt['num_frame'])]
        self.random_reverse = opt.get('random_reverse', False)
        self._client = None
        self._rng = random.Random(opt.get('manual_seed'))

    @property
    def file_client(self):
        if self._client is None:
            o = dict(self.io_backend_opt)
            self._client = FileClient(o.pop('type', 'disk'), **o)
        return self._client

    def __len__(self):
        return len(self.keys)

    def _read(self, path, client_key):
        return imfrombytes(self.file_client.get(path, client_key),
                           float32=True)

    def _paths(self, index):
        """The item's key, its neighbours (reversed by the draw) and the
        LQ / GT path (or lmdb key) of a frame number."""
        neighbors = list(self.neighbor_list)
        if self.random_reverse and self._rng.random() < 0.5:
            neighbors.reverse()
        key = self.keys[index]
        clip, seq = key.split('/')

        def frame(root):
            if self.is_lmdb:
                return lambda i: f'{clip}/{seq}/im{i}'
            return lambda i: os.path.join(root, clip, seq, f'im{i}.png')
        return key, neighbors, frame(self.lq_root), frame(self.gt_root)

    def _crop_and_flip(self, img_gts, img_lqs, key):
        img_gts, img_lqs = paired_random_crop(
            img_gts, img_lqs, self.opt['gt_size'], self.opt['scale'], key,
            rng=self._rng)
        gts = img_gts if isinstance(img_gts, list) else [img_gts]
        return augment(img_lqs + gts, self.opt.get('use_hflip', True),
                       self.opt.get('use_rot', True), rng=self._rng)

    def __getitem__(self, index):
        key, neighbors, lq, gt = self._paths(index)
        imgs = self._crop_and_flip(self._read(gt(4), 'gt'),
                                   [self._read(lq(i), 'lq')
                                    for i in neighbors], key)
        return {'lq': np.stack([img2tensor(v) for v in imgs[:-1]]),
                'gt': img2tensor(imgs[-1]), 'key': key}

    def skip(self, index):
        """The draws of ``self[index]`` without decoding its frames."""
        key, neighbors, lq, gt = self._paths(index)
        crop_origin(imsize(self.file_client.get(gt(4), 'gt')),
                    imsize(self.file_client.get(lq(neighbors[0]), 'lq')),
                    self.opt['gt_size'], self.opt['scale'], key, self._rng)
        flip_draws(self.opt.get('use_hflip', True),
                   self.opt.get('use_rot', True), self._rng)


@DATASET_REGISTRY.register()
class Vimeo90KRecurrentDataset(Vimeo90KDataset):
    """As Vimeo90KDataset, gt (num_frame, 3, H, W) the neighbours' GT
    frames; ``flip_sequence`` appends the reversed clip to lq and gt."""

    def __init__(self, opt):
        super().__init__(opt)
        self.flip_sequence = opt.get('flip_sequence', False)

    def __getitem__(self, index):
        key, neighbors, lq, gt = self._paths(index)
        imgs = self._crop_and_flip([self._read(gt(i), 'gt')
                                    for i in neighbors],
                                   [self._read(lq(i), 'lq')
                                    for i in neighbors], key)
        t = len(neighbors)
        lqs = np.stack([img2tensor(v) for v in imgs[:t]])
        gts = np.stack([img2tensor(v) for v in imgs[t:]])
        if self.flip_sequence:
            lqs = np.concatenate([lqs, lqs[::-1]], axis=0)
            gts = np.concatenate([gts, gts[::-1]], axis=0)
        return {'lq': lqs, 'gt': gts, 'key': key}

    def skip(self, index):
        key, neighbors, lq, gt = self._paths(index)
        crop_origin(imsize(self.file_client.get(gt(neighbors[0]), 'gt')),
                    imsize(self.file_client.get(lq(neighbors[0]), 'lq')),
                    self.opt['gt_size'], self.opt['scale'], key, self._rng)
        flip_draws(self.opt.get('use_hflip', True),
                   self.opt.get('use_rot', True), self._rng)
