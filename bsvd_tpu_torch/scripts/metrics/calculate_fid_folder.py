"""FID between a folder of images and precomputed dataset statistics
(counterpart of the JAX repo's scripts/metrics/calculate_fid_folder.py).

    python -m bsvd_tpu_torch.scripts.metrics.calculate_fid_folder <folder> \\
        --fid_stats <stats.npz|.pth> [--batch_size 64] [--num_sample 50000] \\
        [--device cuda|cpu]

The images are ``SingleImageDataset``'s (mean / std 0.5: [-1, 1]); the
features the TF-FID InceptionV3 (``BSVD_INCEPTION_PRETRAIN_PATH``); the
statistics an ``.npz`` of ``calculate_fid_stats_from_datasets`` or a torch
``.pth`` dict with ``mean`` and ``cov`` (read with ``weights_only``:
tensors or arrays torch's safe loader accepts). Prints ``fid: <value>``.
"""

import argparse

import numpy as np
import torch

from bsvd_tpu_torch.data import build_dataset
from bsvd_tpu_torch.metrics.fid import (calculate_fid,
                                        extract_inception_features,
                                        load_patched_inception_v3)
from bsvd_tpu_torch.scripts.metrics.calculate_fid_stats_from_datasets import (
    batches, stats)


def load_stats(path):
    """(mean, cov) of a statistics file, ``.npz`` or torch ``.pth``."""
    if path.endswith('.npz'):
        with np.load(path) as z:
            return np.asarray(z['mean']), np.asarray(z['cov'])
    st = torch.load(path, map_location='cpu', weights_only=True)
    return np.asarray(st['mean']), np.asarray(st['cov'])


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('folder', type=str, help='Path to the folder.')
    parser.add_argument('--fid_stats', type=str, required=True,
                        help='Path to the dataset fid statistics.')
    parser.add_argument('--batch_size', type=int, default=64)
    parser.add_argument('--num_sample', type=int, default=50000)
    parser.add_argument('--backend', type=str, default='disk',
                        help='io backend for dataset. Option: disk, lmdb')
    parser.add_argument('--device', default='cuda')
    args = parser.parse_args(argv)

    inception = load_patched_inception_v3(device=args.device)
    opt = {'name': 'SingleImageDataset', 'type': 'SingleImageDataset',
           'dataroot_lq': args.folder, 'io_backend': {'type': args.backend},
           'mean': [0.5, 0.5, 0.5], 'std': [0.5, 0.5, 0.5]}
    dataset = build_dataset(opt)
    num_sample = min(args.num_sample, len(dataset))
    features = extract_inception_features(
        batches(dataset, 'lq', num_sample, args.batch_size), inception)
    sample_mean, sample_cov = stats(features, num_sample)
    real_mean, real_cov = load_stats(args.fid_stats)
    fid = calculate_fid(sample_mean, sample_cov, real_mean, real_cov)
    print('fid:', fid)
    return fid


if __name__ == '__main__':
    main()
