"""Mod-cropped GT, MATLAB-bicubic LR and (optionally) bicubic-upsampled
images of a folder (counterpart of the JAX repo's scripts/matlab_scripts/
generate_bicubic_img.py, BasicSR's generate_bicubic_img.m).

    python -m bsvd_tpu_torch.scripts.matlab_scripts.generate_bicubic_img \\
        --input datasets/Set5/original --mod_scale 12 --up_scale 2 \\
        --save_mod datasets/Set5/GTmod12 --save_lr datasets/Set5/LRbicx2 \\
        [--save_bic <folder>] [--device cuda|cpu]

Each file decodes as cv2's IMREAD_UNCHANGED (the port's codecs; files
that do not decode are skipped), goes to ``device`` as float64 / 255, is
mod-cropped, resized by ``utils/matlab_functions.imresize`` there and
written as ``<stem>.png`` of ``round(clip(x, 0, 1) * 255)`` (half to
even, as numpy's).
"""

import argparse
import os
from os import path as osp

import torch

from bsvd_tpu_torch.scripts.data_preparation.extract_subimages import \
    read_unchanged
from bsvd_tpu_torch.utils.img_util import imwrite
from bsvd_tpu_torch.utils.matlab_functions import imresize


def modcrop(img, modulo):
    """H and W cropped down to multiples of ``modulo`` (MATLAB's
    modcrop); numpy or torch."""
    h, w = img.shape[:2]
    return img[:h - h % modulo, :w - w % modulo, ...]


def to_unit(img, device):
    """A uint8 image (numpy) -> a float64 tensor in [0, 1] on ``device``."""
    return torch.from_numpy(img).to(device).double() / 255.0


def imwrite01(img, path):
    """A [0, 1] tensor written as uint8 ``round(clip(x) * 255)``."""
    imwrite((img.clamp(0, 1) * 255.0).round().to(torch.uint8).cpu().numpy(),
            path)


def process_folder(input_folder, mod_scale, up_scale, save_mod=None,
                   save_lr=None, save_bic=None, device='cuda'):
    for folder in (save_mod, save_lr, save_bic):
        if folder:
            os.makedirs(folder, exist_ok=True)
    for idx, name in enumerate(sorted(os.listdir(input_folder))):
        stem = osp.splitext(name)[0]
        img = read_unchanged(osp.join(input_folder, name))
        if img is None:
            continue
        print(f'{idx + 1}\t{stem}.')
        img = modcrop(to_unit(img, device), mod_scale)
        if save_mod:
            imwrite01(img, osp.join(save_mod, f'{stem}.png'))
        lr = imresize(img, 1 / up_scale)
        if save_lr:
            imwrite01(lr, osp.join(save_lr, f'{stem}.png'))
        if save_bic:
            imwrite01(imresize(lr, up_scale), osp.join(save_bic,
                                                       f'{stem}.png'))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--input', required=True, help='input image folder')
    parser.add_argument('--mod_scale', type=int, default=12)
    parser.add_argument('--up_scale', type=int, default=2)
    parser.add_argument('--save_mod', default=None, help='mod-crop GT folder')
    parser.add_argument('--save_lr', default=None, help='bicubic LR folder')
    parser.add_argument('--save_bic', default=None,
                        help='bicubic-upsampled folder')
    parser.add_argument('--device', default='cuda')
    args = parser.parse_args(argv)
    process_folder(args.input, args.mod_scale, args.up_scale,
                   args.save_mod, args.save_lr, args.save_bic, args.device)


if __name__ == '__main__':
    main()
