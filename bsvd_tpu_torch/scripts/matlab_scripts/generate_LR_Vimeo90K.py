"""MATLAB-bicubic LR frames of the Vimeo90K septuplet tree (counterpart
of the JAX repo's scripts/matlab_scripts/generate_LR_Vimeo90K.py,
BasicSR's generate_LR_Vimeo90K.m).

    python -m bsvd_tpu_torch.scripts.matlab_scripts.generate_LR_Vimeo90K \\
        --root datasets/vimeo90k/vimeo_septuplet [--up_scale 4] \\
        [--mod_scale 4] [--device cuda|cpu]

Every ``sequences/*/*/*.png`` under ``root`` is mod-cropped and resized
by 1 / ``up_scale`` with ``utils/matlab_functions.imresize`` on
``device``, and written to the same path with 'vimeo_septuplet' replaced
by 'vimeo_septuplet_matlabLRx4'.
"""

import argparse
import glob
import os
from os import path as osp

from bsvd_tpu_torch.scripts.data_preparation.extract_subimages import \
    read_unchanged
from bsvd_tpu_torch.scripts.matlab_scripts.generate_bicubic_img import (
    imwrite01, modcrop, to_unit)
from bsvd_tpu_torch.utils.matlab_functions import imresize


def process_tree(root, up_scale=4, mod_scale=4, device='cuda'):
    paths = sorted(glob.glob(osp.join(root, 'sequences', '*', '*', '*.png')))
    for idx, path in enumerate(paths):
        folder, name = osp.split(path)
        save_folder = folder.replace('vimeo_septuplet',
                                     'vimeo_septuplet_matlabLRx4')
        os.makedirs(save_folder, exist_ok=True)
        print(f'{idx + 1}\t{osp.splitext(name)[0]}.')
        img = to_unit(read_unchanged(path), device)
        imwrite01(imresize(modcrop(img, mod_scale), 1 / up_scale),
                  osp.join(save_folder, name))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--root', required=True,
                        help='vimeo_septuplet root (contains sequences/)')
    parser.add_argument('--up_scale', type=int, default=4)
    parser.add_argument('--mod_scale', type=int, default=4)
    parser.add_argument('--device', default='cuda')
    args = parser.parse_args(argv)
    process_tree(args.root, args.up_scale, args.mod_scale, args.device)


if __name__ == '__main__':
    main()
