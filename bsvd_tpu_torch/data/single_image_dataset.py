"""Single-image datasets (counterpart of bsvd_tpu/data/
single_image_dataset.py): ``SingleImageDataset``, LQ only, and
``FFHQDataset``, GT faces with a horizontal flip drawn per item from one
``random.Random(manual_seed)``, as in the JAX package, so both give the
same flips in the same order. Items are float32 (C, H, W) RGB in [0, 1]
(or normalised by the options' ``mean`` / ``std``), read with
``FileClient`` and the port's ``imfrombytes``; on lmdb the folder is one
store under the client key 'lq' (SingleImageDataset) or 'gt'
(FFHQDataset), its keys from ``meta_info.txt``."""

import os
import random

import numpy as np

from bsvd_tpu_torch.data.data_util import paths_from_folder, paths_from_lmdb
from bsvd_tpu_torch.utils import img_util
from bsvd_tpu_torch.utils.file_client import FileClient
from bsvd_tpu_torch.utils.registry import DATASET_REGISTRY


def _normalise(img, mean, std):
    if mean is None:
        return img
    mean = np.asarray(mean, np.float32).reshape(-1, 1, 1)
    std = np.asarray(std, np.float32).reshape(-1, 1, 1)
    return (img - mean) / std


class _ImageFolder:
    """Paths of one folder (sorted) and its file client."""

    def __init__(self, opt, folder, client_key):
        self.opt = opt
        self.io_backend_opt = dict(opt.get('io_backend') or {'type': 'disk'})
        self.mean = opt.get('mean')
        self.std = opt.get('std')
        self.client_key = client_key
        if self.io_backend_opt.get('type') == 'lmdb':
            self.io_backend_opt['db_paths'] = [folder]
            self.io_backend_opt['client_keys'] = [client_key]
            self.paths = paths_from_lmdb(folder)
        elif client_key == 'lq' and opt.get('meta_info_file') is not None:
            with open(opt['meta_info_file'], 'r') as fin:
                self.paths = [os.path.join(folder,
                                           line.rstrip().split(' ')[0])
                              for line in fin]
        else:
            self.paths = sorted(paths_from_folder(folder))
        self._client = None

    @property
    def file_client(self):
        if self._client is None:
            o = dict(self.io_backend_opt)
            self._client = FileClient(o.pop('type', 'disk'), **o)
        return self._client

    def _read(self, path):
        return img_util.imfrombytes(self.file_client.get(path,
                                                         self.client_key),
                                    float32=True)

    def __len__(self):
        return len(self.paths)


@DATASET_REGISTRY.register()
class SingleImageDataset(_ImageFolder):
    """LQ images of ``dataroot_lq`` (or the files its ``meta_info_file``
    names): {'lq', 'lq_path'}."""

    def __init__(self, opt):
        super().__init__(opt, opt['dataroot_lq'], 'lq')

    def __getitem__(self, index):
        lq_path = self.paths[index]
        lq = img_util.img2tensor(self._read(lq_path))
        return {'lq': _normalise(lq, self.mean, self.std), 'lq_path': lq_path}


@DATASET_REGISTRY.register()
class FFHQDataset(_ImageFolder):
    """GT faces of ``dataroot_gt``, flipped with probability 1/2 when
    ``use_hflip`` (default on): {'gt', 'gt_path'}."""

    def __init__(self, opt):
        super().__init__(opt, opt['dataroot_gt'], 'gt')
        self._rng = random.Random(opt.get('manual_seed'))

    def __getitem__(self, index):
        gt_path = self.paths[index]
        img_gt = self._read(gt_path)
        if self.opt.get('use_hflip', True) and self._rng.random() < 0.5:
            img_gt = np.ascontiguousarray(img_gt[:, ::-1, :])
        gt = img_util.img2tensor(img_gt)
        return {'gt': _normalise(gt, self.mean, self.std), 'gt_path': gt_path}
