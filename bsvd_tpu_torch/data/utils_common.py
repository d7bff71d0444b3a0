"""Reading a clip from a folder of frames (counterpart of bsvd_tpu/data/
utils_common.py get_imagenames / open_sequence): digit-sorted file names,
frames decoded by the port's native decoder (no cv2), RGB (C, H, W)
float32 in [0, 1]."""

import glob
import os

import numpy as np

from bsvd_tpu_torch.data import native_decode
from bsvd_tpu_torch.utils.misc import digit_sort_key

IMAGETYPES = ('*.bmp', '*.png', '*.jpg', '*.jpeg', '*.tif')


def get_imagenames(seq_dir, pattern=None):
    """Image file names in a folder, ordered by the digits they hold."""
    files = []
    for typ in IMAGETYPES:
        files.extend(glob.glob(os.path.join(seq_dir, typ)))
    if pattern is not None:
        files = [f for f in files if pattern in os.path.split(f)[-1]]
    files.sort(key=digit_sort_key)
    return files


def open_sequence(seq_dir, gray_mode=False, max_num_fr=100):
    """The first ``max_num_fr`` frames of a folder -> (T, 3, H, W) float32
    in [0, 1]. PNG and JPEG (the native decoder); gray frames are not
    ported."""
    if gray_mode:
        raise NotImplementedError('open_sequence(gray_mode=True): the native '
                                  'decoder reads RGB only')
    files = get_imagenames(seq_dir)[:max_num_fr]
    if not files:
        raise IOError(f'no images found in {seq_dir}')
    seq = native_decode.load_seq(files)                 # (T, H, W, 3) uint8
    return np.transpose(seq, (0, 3, 1, 2)).astype(np.float32) / 255.
