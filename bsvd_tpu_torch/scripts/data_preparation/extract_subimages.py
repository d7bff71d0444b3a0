"""Overlapping sub-images of large images, for faster train reads
(counterpart of the JAX repo's scripts/data_preparation/
extract_subimages.py, BasicSR's).

    python -m bsvd_tpu_torch.scripts.data_preparation.extract_subimages \\
        --input datasets/DIV2K/DIV2K_train_HR \\
        --output datasets/DIV2K/DIV2K_train_HR_sub \\
        --crop_size 480 --step 240 [--thresh_size 0] [--n_thread 8] \\
        [--compression_level 3]

Windows start every ``step`` pixels, plus one flush with the far edge
where more than ``thresh_size`` pixels would be left; the sub-images are
``<name>_s<idx:03d>.png`` (``name`` without any 'x2' / 'x3' / 'x4' / 'x8',
so LR sub-images pair with HR ones), PNG of zlib level
``compression_level``. Files are read as cv2's IMREAD_UNCHANGED reads
them and written with the port's codecs; a file that does not decode is
skipped, as cv2.imread's None.
"""

import argparse
import os
from concurrent.futures import ThreadPoolExecutor
from os import path as osp

import numpy as np

from bsvd_tpu_torch.utils.img_util import (IMWRITE_PNG_COMPRESSION,
                                           imfrombytes, imwrite)

IMAGE_EXTS = ('.png', '.jpg', '.jpeg', '.bmp')


def read_unchanged(path):
    """A file's image as cv2.imread(IMREAD_UNCHANGED) gives it, or None
    where it does not decode."""
    try:
        with open(path, 'rb') as f:
            return imfrombytes(f.read(), 'unchanged')
    except (OSError, ValueError):
        return None


def starts(size, crop_size, step, thresh_size):
    """Window origins along an axis of ``size`` pixels."""
    s = np.arange(0, size - crop_size + 1, step)
    if size - (s[-1] + crop_size) > thresh_size:
        s = np.append(s, size - crop_size)
    return s


def _worker(path, out_dir, crop_size, step, thresh_size, compression):
    name, _ = osp.splitext(osp.basename(path))
    for suf in ('x2', 'x3', 'x4', 'x8'):
        name = name.replace(suf, '')
    img = read_unchanged(path)
    if img is None:
        return f'{name}: unreadable, skipped'
    h, w = img.shape[:2]
    idx = 0
    for y in starts(h, crop_size, step, thresh_size):
        for x in starts(w, crop_size, step, thresh_size):
            idx += 1
            imwrite(np.ascontiguousarray(img[y:y + crop_size,
                                             x:x + crop_size, ...]),
                    osp.join(out_dir, f'{name}_s{idx:03d}.png'),
                    [IMWRITE_PNG_COMPRESSION, compression])
    return f'{name}: {idx} patches'


def extract_subimages(input_folder, save_folder, crop_size, step,
                      thresh_size=0, n_thread=None, compression_level=3):
    os.makedirs(save_folder, exist_ok=True)
    paths = sorted(osp.join(input_folder, f)
                   for f in os.listdir(input_folder)
                   if f.lower().endswith(IMAGE_EXTS))
    n_thread = n_thread or min(8, os.cpu_count() or 1)
    with ThreadPoolExecutor(n_thread) as pool:
        for info in pool.map(
                lambda p: _worker(p, save_folder, crop_size, step,
                                  thresh_size, compression_level), paths):
            print(info)
    print(f'{len(paths)} images -> {save_folder}')


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--input', required=True)
    ap.add_argument('--output', required=True)
    ap.add_argument('--crop_size', type=int, default=480)
    ap.add_argument('--step', type=int, default=240)
    ap.add_argument('--thresh_size', type=int, default=0)
    ap.add_argument('--n_thread', type=int, default=None)
    ap.add_argument('--compression_level', type=int, default=3)
    a = ap.parse_args(argv)
    extract_subimages(a.input, a.output, a.crop_size, a.step, a.thresh_size,
                      a.n_thread, a.compression_level)


if __name__ == '__main__':
    main()
