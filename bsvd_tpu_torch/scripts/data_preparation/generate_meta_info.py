"""A meta-info file of a folder, ``<name> (<h>,<w>,<c>)`` a line
(counterpart of the JAX repo's scripts/data_preparation/
generate_meta_info.py, BasicSR's).

    python -m bsvd_tpu_torch.scripts.data_preparation.generate_meta_info \\
        --input datasets/DIV2K/DIV2K_train_HR_sub \\
        --meta_info datasets/meta_info_DIV2K800sub_GT.txt

The folder's PNG / JPEG / BMP files in sorted order, each read as cv2's
IMREAD_UNCHANGED reads it (its channels 1 for gray) with the port's
codecs.
"""

import argparse
import os
from os import path as osp

from bsvd_tpu_torch.scripts.data_preparation.extract_subimages import (
    IMAGE_EXTS, read_unchanged)


def generate_meta_info(input_folder, meta_info_path):
    names = sorted(f for f in os.listdir(input_folder)
                   if f.lower().endswith(IMAGE_EXTS))
    os.makedirs(osp.dirname(osp.abspath(meta_info_path)), exist_ok=True)
    with open(meta_info_path, 'w') as f:
        for idx, name in enumerate(names):
            img = read_unchanged(osp.join(input_folder, name))
            if img.ndim == 2:
                h, w, c = *img.shape, 1
            else:
                h, w, c = img.shape
            info = f'{name} ({h},{w},{c})'
            print(idx + 1, info)
            f.write(info + '\n')
    print(f'wrote {len(names)} entries -> {meta_info_path}')


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--input', required=True)
    ap.add_argument('--meta_info', required=True)
    a = ap.parse_args(argv)
    generate_meta_info(a.input, a.meta_info)


if __name__ == '__main__':
    main()
