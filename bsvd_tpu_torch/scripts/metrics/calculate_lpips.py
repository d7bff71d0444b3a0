"""LPIPS between a GT folder and a restored folder (counterpart of the JAX
repo's scripts/metrics/calculate_lpips.py, which replaces BasicSR's
``lpips`` package by its own LPIPS-VGG, as the port does with
``metrics/lpips``).

    python -m bsvd_tpu_torch.scripts.metrics.calculate_lpips \\
        --gt <folder> --restored <folder> [--suffix ''] [--device cuda|cpu]

Needs ``BSVD_LPIPS_PRETRAIN_PATH`` and ``BSVD_VGG16_PRETRAIN_PATH``.
Images are read as cv2's IMREAD_UNCHANGED reads them, with the port's
codecs; BGR -> RGB, [0, 1] -> [-1, 1].
"""

import argparse
import glob
import os.path as osp

import numpy as np
import torch

from bsvd_tpu_torch.metrics.lpips import load_lpips
from bsvd_tpu_torch.utils.img_util import imfrombytes


def _read(path):
    with open(path, 'rb') as f:
        return imfrombytes(f.read(), 'unchanged').astype(np.float32) / 255.


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--gt', type=str,
                        default='datasets/celeba/celeba_512_validation')
    parser.add_argument('--restored', type=str,
                        default='datasets/celeba/celeba_512_validation_lq')
    parser.add_argument('--suffix', type=str, default='')
    parser.add_argument('--device', default='cuda')
    args = parser.parse_args(argv)

    lpips = load_lpips(device=args.device)
    lpips_all = []
    for i, img_path in enumerate(sorted(glob.glob(osp.join(args.gt, '*')))):
        basename, ext = osp.splitext(osp.basename(img_path))
        img_gt = _read(img_path)
        img_restored = _read(osp.join(args.restored,
                                      basename + args.suffix + ext))
        pair = [torch.from_numpy(np.ascontiguousarray(
            ((im[..., ::-1] - 0.5) / 0.5).transpose(2, 0, 1)))[None]
            .to(args.device) for im in (img_restored, img_gt)]
        with torch.no_grad():
            lpips_val = float(lpips(*pair)[0])
        print(f'{i+1:3d}: {basename:25}. \tLPIPS: {lpips_val:.6f}.')
        lpips_all.append(lpips_val)
    print(f'Average: LPIPS: {sum(lpips_all) / len(lpips_all):.6f}')
    return lpips_all


if __name__ == '__main__':
    main()
