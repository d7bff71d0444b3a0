"""The video SR datasets over clip-folder trees (counterpart of
bsvd_tpu/data/video_test_dataset.py, BasicSR's video_test_dataset
and REDSRecurrentDataset): ``root/<clip>/<frames>``, LQ and GT trees of
the same clips.

- ``VideoRecurrentTestDataset``: one item a clip, its whole LQ and GT
  sequences (``open_sequence``: the native route, frames unturned);
- ``VideoTestDataset``: one item a frame, its ``num_frame`` LQ neighbours
  (``data_util.generate_frame_indices``) and its GT frame;
- ``REDSRecurrentDataset``: training windows of ``num_frame`` frames at a
  random interval and start, paired-cropped and flipped;
- ``VideoTestVimeo90KDataset``: one Vimeo90K-Test septuplet an item (a
  meta-info file's folders), its ``num_frame`` middle LQ frames and the
  centre GT frame ``im4``;
- ``VideoTestDUFDataset``: ``VideoTestDataset`` whose LQ window is, with
  ``use_duf_downsampling``, made from the GT frames by
  ``data_util.duf_downsample`` (both mod-cropped to ``scale``).

Single frames are read by ``open_image`` (cv2's route in the JAX package,
so turned by their EXIF orientation). Items are float32 (T, C, H, W) RGB
in [0, 1].

``REDSRecurrentDataset`` draws from one ``random.Random(manual_seed)`` in
the JAX package's order (the interval's ``choice``, the start's
``randint``, the crop's two ``randint``s, the three flips), so a seed
gives the same windows, crops and flips; the batch loader therefore reads
its items one after another, and ``skip`` makes an item's draws without
decoding it (the other ranks' rows on a mesh).
"""

import glob
import os
import random

import numpy as np

from bsvd_tpu_torch.data.data_util import (duf_downsample,
                                           generate_frame_indices)
from bsvd_tpu_torch.data.transforms import (augment, crop_origin,
                                            flip_draws, mod_crop,
                                            paired_random_crop)
from bsvd_tpu_torch.data.utils_common import (get_imagenames, open_image,
                                              open_image_dims, open_sequence)
from bsvd_tpu_torch.utils.registry import DATASET_REGISTRY


def _clip_dirs(root):
    """The clip folders under ``root``, sorted by name."""
    return sorted(p for p in glob.glob(os.path.join(root, '*'))
                  if os.path.isdir(p))


def _hwc(path):
    """``open_image`` of a frame as (H, W, C)."""
    return np.transpose(open_image(path)[0], (1, 2, 0))


def _chw_stack(imgs):
    return np.stack([np.transpose(v, (2, 0, 1)) for v in imgs])


@DATASET_REGISTRY.register()
class VideoRecurrentTestDataset:
    """Whole clips. opt: dataroot_lq, dataroot_gt, name, num_frame (a cap
    on the frames read, -1 for all). Items: lq / gt (T, C, H, W), folder,
    index."""

    def __init__(self, opt):
        self.opt = opt
        self.lq_dirs = _clip_dirs(opt['dataroot_lq'])
        self.gt_dirs = _clip_dirs(opt['dataroot_gt'])
        assert len(self.lq_dirs) == len(self.gt_dirs), (
            f"lq/gt clip count mismatch under {opt['dataroot_lq']} vs "
            f"{opt['dataroot_gt']}")
        self.base_folder = [os.path.basename(p) for p in self.lq_dirs]
        cap = opt.get('num_frame', -1)
        self.max_fr = cap if cap and cap > 0 else 10**6
        self.num_frames = [min(len(get_imagenames(d)), self.max_fr)
                           for d in self.lq_dirs]

    def __getitem__(self, index):
        lq, _, _ = open_sequence(self.lq_dirs[index], max_num_fr=self.max_fr)
        gt, _, _ = open_sequence(self.gt_dirs[index], max_num_fr=self.max_fr)
        return {'lq': lq, 'gt': gt, 'folder': self.base_folder[index],
                'index': index}

    def __len__(self):
        return len(self.lq_dirs)


@DATASET_REGISTRY.register()
class VideoTestDataset:
    """Sliding windows for EDVR-style models. opt: dataroot_lq,
    dataroot_gt, name, num_frame (odd, default 5), padding (default
    'reflection_circle'). Items: lq (num_frame, C, H, W), gt (C, H, W),
    folder, idx ('<frame>/<frames>')."""

    def __init__(self, opt):
        self.opt = opt
        self.num_frame = opt.get('num_frame', 5)
        self.padding = opt.get('padding', 'reflection_circle')
        self.lq_dirs = _clip_dirs(opt['dataroot_lq'])
        self.gt_dirs = _clip_dirs(opt['dataroot_gt'])
        self.base_folder = [os.path.basename(p) for p in self.lq_dirs]
        self.lq_frames = [get_imagenames(d) for d in self.lq_dirs]
        self.gt_frames = [get_imagenames(d) for d in self.gt_dirs]
        self.items = [(fi, i) for fi, frames in enumerate(self.lq_frames)
                      for i in range(len(frames))]
        self.num_frames = [len(f) for f in self.lq_frames]

    def __getitem__(self, index):
        fi, ci = self.items[index]
        idxs = generate_frame_indices(ci, len(self.lq_frames[fi]),
                                      self.num_frame, self.padding)
        lq = np.stack([open_image(self.lq_frames[fi][i])[0] for i in idxs])
        gt = open_image(self.gt_frames[fi][ci])[0]
        return {'lq': lq, 'gt': gt, 'folder': self.base_folder[fi],
                'idx': f'{ci}/{len(self.lq_frames[fi])}'}

    def __len__(self):
        return len(self.items)


@DATASET_REGISTRY.register()
class VideoTestVimeo90KDataset:
    """opt: dataroot_gt, dataroot_lq, meta_info_file (a septuplet folder
    per line, first column), num_frame (default 7), name. Items: lq
    (num_frame, C, H, W) of ``im<i>.png``, gt (C, H', W') of ``im4.png``,
    folder 'vimeo90k', idx ('<item>/<items>'), lq_path (the centre
    frame's)."""

    def __init__(self, opt):
        self.opt = opt
        if opt.get('cache_data'):
            raise NotImplementedError(
                'cache_data in Vimeo90K-Test dataset is not implemented.')
        gt_root, lq_root = opt['dataroot_gt'], opt['dataroot_lq']
        num_frame = opt.get('num_frame', 7)
        neighbors = [i + (9 - num_frame) // 2 for i in range(num_frame)]
        with open(opt['meta_info_file']) as fin:
            subfolders = [line.split(' ')[0] for line in fin if line.strip()]
        self.gt_paths = [os.path.join(gt_root, s, 'im4.png')
                         for s in subfolders]
        self.lq_paths = [[os.path.join(lq_root, s, f'im{i}.png')
                          for i in neighbors] for s in subfolders]
        self.total = len(subfolders)

    def __getitem__(self, index):
        paths = self.lq_paths[index]
        return {'lq': np.stack([open_image(p)[0] for p in paths]),
                'gt': open_image(self.gt_paths[index])[0],
                'folder': 'vimeo90k', 'idx': f'{index}/{self.total}',
                'lq_path': paths[len(paths) // 2]}

    def __len__(self):
        return self.total


def _mod_crop_chw(img, scale):
    return np.transpose(mod_crop(np.transpose(img, (1, 2, 0)), scale),
                        (2, 0, 1))


@DATASET_REGISTRY.register()
class VideoTestDUFDataset(VideoTestDataset):
    """VideoTestDataset for DUF; extra opt: use_duf_downsampling, scale
    (default 4). The GT frame is mod-cropped to ``scale``."""

    def __getitem__(self, index):
        fi, ci = self.items[index]
        scale = self.opt.get('scale', 4)
        idxs = generate_frame_indices(ci, len(self.lq_frames[fi]),
                                      self.num_frame, self.padding)
        if self.opt.get('use_duf_downsampling'):
            gt_seq = np.stack([_mod_crop_chw(open_image(
                self.gt_frames[fi][i])[0], scale) for i in idxs])
            lq = duf_downsample(gt_seq, kernel_size=13, scale=scale)
        else:
            lq = np.stack([open_image(self.lq_frames[fi][i])[0]
                           for i in idxs])
        gt = _mod_crop_chw(open_image(self.gt_frames[fi][ci])[0], scale)
        return {'lq': lq, 'gt': gt, 'folder': self.base_folder[fi],
                'idx': f'{ci}/{len(self.lq_frames[fi])}'}


class _ClipTrees:
    """The paired GT / LQ clip trees of a training dataset and its one
    ``random.Random(manual_seed)``."""

    def __init__(self, opt, default_num_frame):
        self.opt = opt
        self.scale = opt.get('scale', 4)
        self.gt_size = opt.get('gt_size', 256)
        self.num_frame = opt.get('num_frame', default_num_frame)
        self.interval_list = opt.get('interval_list', [1])
        self.gt_dirs = _clip_dirs(opt['dataroot_gt'])
        self.lq_dirs = _clip_dirs(opt['dataroot_lq'])
        assert len(self.gt_dirs) == len(self.lq_dirs)
        self.gt_frames = [get_imagenames(d) for d in self.gt_dirs]
        self.lq_frames = [get_imagenames(d) for d in self.lq_dirs]
        self._rng = random.Random(opt.get('manual_seed'))

    def _crop_and_flip(self, gt_imgs, lq_imgs):
        """The paired random crop and the flips of one item (HWC lists),
        in the JAX package's draw order -> lq + gt as one list."""
        gt_imgs, lq_imgs = paired_random_crop(gt_imgs, lq_imgs, self.gt_size,
                                              self.scale, rng=self._rng)
        return augment(lq_imgs + gt_imgs, self.opt.get('use_hflip', True),
                       self.opt.get('use_rot', True), rng=self._rng)

    def _skip_crop_and_flip(self, gt_path, lq_path):
        """``_crop_and_flip``'s draws, from the frames' sizes alone."""
        crop_origin(open_image_dims(gt_path), open_image_dims(lq_path),
                    self.gt_size, self.scale, gt_path, self._rng)
        flip_draws(self.opt.get('use_hflip', True),
                   self.opt.get('use_rot', True), self._rng)


@DATASET_REGISTRY.register()
class REDSRecurrentDataset(_ClipTrees):
    """Recurrent training windows. opt: dataroot_gt, dataroot_lq,
    num_frame (default 15), gt_size, scale, interval_list, use_hflip,
    use_rot, manual_seed. Items: lq (num_frame, C, gt_size / scale, ...),
    gt (num_frame, C, gt_size, gt_size), key ('<clip>/<start>')."""

    def __init__(self, opt):
        super().__init__(opt, 15)

    def __len__(self):
        return len(self.gt_dirs) * 100       # a virtual epoch

    def _window(self, index):
        fi = index % len(self.gt_dirs)
        interval = self._rng.choice(self.interval_list)
        span = (self.num_frame - 1) * interval
        start = self._rng.randint(
            0, max(len(self.lq_frames[fi]) - 1 - span, 0))
        return fi, start, list(range(start, start + span + 1, interval))

    def __getitem__(self, index):
        fi, start, idxs = self._window(index)
        imgs = self._crop_and_flip(
            [_hwc(self.gt_frames[fi][i]) for i in idxs],
            [_hwc(self.lq_frames[fi][i]) for i in idxs])
        n = len(idxs)
        return {'lq': _chw_stack(imgs[:n]), 'gt': _chw_stack(imgs[n:]),
                'key': f'{fi}/{start}'}

    def skip(self, index):
        """The draws of ``self[index]`` without decoding its frames."""
        fi, _, idxs = self._window(index)
        self._skip_crop_and_flip(self.gt_frames[fi][idxs[0]],
                                 self.lq_frames[fi][idxs[0]])
