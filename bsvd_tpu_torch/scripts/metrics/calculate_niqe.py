"""NIQE over a folder (counterpart of the JAX repo's
scripts/metrics/calculate_niqe.py).

    python -m bsvd_tpu_torch.scripts.metrics.calculate_niqe \\
        --input <folder> [--crop_border 0] [--device cuda|cpu]

Needs the pristine NIQE parameters (``metrics/niqe``: the
``BSVD_NIQE_PARAMS`` search). Images are read as cv2's IMREAD_UNCHANGED
reads them, with the port's codecs.
"""

import argparse
import os
import warnings

from bsvd_tpu_torch.metrics import calculate_niqe
from bsvd_tpu_torch.utils.img_util import imfrombytes
from bsvd_tpu_torch.utils.misc import scandir


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--input', type=str, required=True)
    parser.add_argument('--crop_border', type=int, default=0)
    parser.add_argument('--device', default='cuda')
    args = parser.parse_args(argv)
    niqe_all = []
    img_list = sorted(scandir(args.input, recursive=True, full_path=True))
    for i, img_path in enumerate(img_list):
        basename, _ = os.path.splitext(os.path.basename(img_path))
        with open(img_path, 'rb') as f:
            img = imfrombytes(f.read(), 'unchanged')
        with warnings.catch_warnings():
            warnings.simplefilter('ignore', category=RuntimeWarning)
            score = calculate_niqe(img, args.crop_border, input_order='HWC',
                                   convert_to='y', device=args.device)
        print(f'{i + 1:3d}: {basename:25}. \tNIQE: {score:.6f}')
        niqe_all.append(score)
    print(args.input)
    print(f'Average: NIQE: {sum(niqe_all) / len(niqe_all):.6f}')
    return niqe_all


if __name__ == '__main__':
    main()
