"""REDS sliding-window training dataset (counterpart of
bsvd_tpu/data/reds_dataset.py, BasicSR's REDSDataset): ``num_frame`` LQ
neighbours at a random interval around a centre frame -> its GT frame,
paired-cropped and flipped, on clip-folder trees
(``root/<clip>/<frames>``). It shares the trees, the frame reading and
the draws of ``video_test_dataset.REDSRecurrentDataset``; its one
``random.Random(manual_seed)`` draws in the JAX package's order (the
interval, the centre until the window fits, the reversal with
``random_reverse``, the crop, the flips)."""

import numpy as np

from bsvd_tpu_torch.data.video_test_dataset import _ClipTrees, _chw_stack, _hwc
from bsvd_tpu_torch.utils.registry import DATASET_REGISTRY


@DATASET_REGISTRY.register()
class REDSDataset(_ClipTrees):
    """opt: dataroot_gt, dataroot_lq, num_frame (odd, default 5), gt_size,
    scale, interval_list, random_reverse, use_hflip, use_rot,
    manual_seed. Items: lq (num_frame, C, h, w), gt (C, H, W), key
    ('<clip>/<centre>')."""

    def __init__(self, opt):
        super().__init__(opt, 5)
        assert self.num_frame % 2 == 1, 'num_frame should be odd'
        self.num_half = self.num_frame // 2
        self.random_reverse = opt.get('random_reverse', False)
        self.items = [(fi, ci) for fi in range(len(self.gt_dirs))
                      for ci in range(len(self.gt_frames[fi]))]

    def __len__(self):
        return len(self.items)

    def _window(self, index):
        fi, center = self.items[index]
        total = len(self.lq_frames[fi])
        interval = self._rng.choice(self.interval_list)
        reach = self.num_half * interval
        # draw the centre again until the window fits (as the JAX package)
        while center - reach < 0 or center + reach >= total:
            center = self._rng.randint(reach, total - 1 - reach)
        neighbors = list(range(center - reach, center + reach + 1, interval))
        if self.random_reverse and self._rng.random() < 0.5:
            neighbors.reverse()
        return fi, center, neighbors

    def __getitem__(self, index):
        fi, center, neighbors = self._window(index)
        imgs = self._crop_and_flip(
            [_hwc(self.gt_frames[fi][center])],
            [_hwc(self.lq_frames[fi][i]) for i in neighbors])
        return {'lq': _chw_stack(imgs[:-1]),
                'gt': np.transpose(imgs[-1], (2, 0, 1)),
                'key': f'{fi}/{center}'}

    def skip(self, index):
        """The draws of ``self[index]`` without decoding its frames."""
        fi, center, neighbors = self._window(index)
        self._skip_crop_and_flip(self.gt_frames[fi][center],
                                 self.lq_frames[fi][neighbors[0]])
