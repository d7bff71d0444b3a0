"""Validation clips: whole clips from image folders plus fixed-sigma
Gaussian noise (counterpart of bsvd_tpu/data/val_folder_dataset.py).

The noise comes from ``np.random.default_rng((manual_seed, index))``,
drawn as the JAX package draws it, so lq, gt and noise_map equal its bit
for bit. Arrays stay numpy on the host; the model moves them.
"""

import glob
import os

import numpy as np

from bsvd_tpu_torch.data.utils_common import get_imagenames, open_sequence
from bsvd_tpu_torch.utils.registry import DATASET_REGISTRY


@DATASET_REGISTRY.register()
class ValFolderDataset:
    """One item per sub-folder of ``valsetdir``.

    opt keys: valsetdir, num_validation_frames, valnoisestd (in [0, 255]
    units); optional: gray_mode, scene_name, blind, manual_seed.
    """

    def __init__(self, opt):
        self.opt = opt
        self.valsetdir = opt['valsetdir']
        self.gray_mode = opt.get('gray_mode', False)
        self.num_input_frames = opt['num_validation_frames']
        self.valnoisestd = opt['valnoisestd']
        self.scene_name = opt.get('scene_name', None)
        self.seed = opt.get('manual_seed', 0)
        self.seqs_dirs = sorted(
            pth for pth in glob.glob(os.path.join(self.valsetdir, '*'))
            if os.path.isdir(pth))
        if self.scene_name is not None:
            self.seqs_dirs = [d for d in self.seqs_dirs
                              if self.scene_name in d]
        self.base_folder = [os.path.basename(p) for p in self.seqs_dirs]
        self.num_frames = [min(len(get_imagenames(d)), self.num_input_frames)
                           for d in self.seqs_dirs]

    def __getitem__(self, index):
        seq, _, _ = open_sequence(self.seqs_dirs[index], self.gray_mode,
                                  expand_if_needed=False,
                                  max_num_fr=self.num_input_frames)
        gt = seq[None, ...]                                  # (1, T, C, H, W)
        n, t, _, h, w = gt.shape
        rng = np.random.default_rng((self.seed, index))
        sigma = self.valnoisestd / 255.0
        noise = rng.normal(0.0, sigma, size=gt.shape).astype(np.float32)
        out = {'gt': gt, 'lq': gt + noise,
               'noise_map': np.full((n, t, 1, h, w), sigma, dtype=np.float32),
               'folder': self.base_folder[index], 'index': index}
        if self.opt.get('blind', False):
            out.pop('noise_map')
        return out

    def __len__(self):
        return len(self.base_folder)
