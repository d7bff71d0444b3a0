"""PSNR / SSIM between two image folders (counterpart of the JAX repo's
scripts/metrics/calculate_psnr_ssim.py; the metrics are numpy float64 on
the host, as the port's ``metrics/psnr_ssim``).

    python -m bsvd_tpu_torch.scripts.metrics.calculate_psnr_ssim \\
        --gt <folder> --restored <folder> [--crop_border 4] \\
        [--suffix _x] [--test_y_channel]

Images are read as cv2's IMREAD_UNCHANGED reads them, with the port's
codecs.
"""

import argparse
import os

import numpy as np

from bsvd_tpu_torch.metrics import calculate_psnr, calculate_ssim
from bsvd_tpu_torch.utils.img_util import imfrombytes
from bsvd_tpu_torch.utils.misc import scandir


def _read(path):
    with open(path, 'rb') as f:
        return imfrombytes(f.read(), 'unchanged')


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--gt', required=True)
    ap.add_argument('--restored', required=True)
    ap.add_argument('--crop_border', type=int, default=0)
    ap.add_argument('--suffix', default='')
    ap.add_argument('--test_y_channel', action='store_true')
    a = ap.parse_args(argv)

    psnrs, ssims = [], []
    gt_list = sorted(scandir(a.gt, recursive=True, full_path=True))
    for i, gt_path in enumerate(gt_list):
        base = os.path.splitext(os.path.basename(gt_path))[0]
        restored_path = os.path.join(a.restored, base + a.suffix +
                                     os.path.splitext(gt_path)[1])
        gt, restored = _read(gt_path), _read(restored_path)
        p = calculate_psnr(gt, restored, crop_border=a.crop_border,
                           test_y_channel=a.test_y_channel)
        s = calculate_ssim(gt, restored, crop_border=a.crop_border,
                           test_y_channel=a.test_y_channel)
        print(f'{i + 1:3d}: {base:25}. \tPSNR: {p:.6f} dB, \tSSIM: {s:.6f}')
        psnrs.append(p)
        ssims.append(s)
    print(f'Average: PSNR: {np.mean(psnrs):.6f} dB, SSIM: {np.mean(ssims):.6f}')
    return psnrs, ssims


if __name__ == '__main__':
    main()
