"""FID statistics (mean and covariance of the pool3 features) of a dataset
(counterpart of the JAX repo's
scripts/metrics/calculate_fid_stats_from_datasets.py).

    python -m bsvd_tpu_torch.scripts.metrics.calculate_fid_stats_from_datasets \\
        --dataroot datasets/ffhq/ffhq_512 [--size 512] [--num_sample 50000] \\
        [--batch_size 64] [--device cuda|cpu]

The images are ``FFHQDataset``'s (no flip, mean / std 0.5: [-1, 1]); the
features the TF-FID InceptionV3 (``BSVD_INCEPTION_PRETRAIN_PATH``). Writes
``inception_FFHQ_<size>.npz`` in the working directory with the keys
``name``, ``size``, ``mean`` and ``cov``, as the JAX script does.
"""

import argparse
import math

import numpy as np

from bsvd_tpu_torch.data import build_dataset
from bsvd_tpu_torch.metrics.fid import (extract_inception_features,
                                        load_patched_inception_v3)


def batches(dataset, key, num_sample, batch_size):
    """The first ceil(num_sample / batch_size) batches of ``dataset``'s
    ``key`` images, (N, C, H, W) numpy arrays."""
    total_batch = math.ceil(min(num_sample, len(dataset)) / batch_size)
    for b in range(total_batch):
        idx = range(b * batch_size, min((b + 1) * batch_size, len(dataset)))
        yield np.stack([dataset[i][key] for i in idx])


def stats(features, num_sample):
    """(mean, cov) of the first ``num_sample`` features, after the JAX
    script's message."""
    total_len = features.shape[0]
    features = features[:num_sample]
    print(f'Extracted {total_len} features, use the first '
          f'{features.shape[0]} features to calculate stats.')
    return np.mean(features, 0), np.cov(features, rowvar=False)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--num_sample', type=int, default=50000)
    parser.add_argument('--batch_size', type=int, default=64)
    parser.add_argument('--size', type=int, default=512)
    parser.add_argument('--dataroot', type=str, default='datasets/ffhq')
    parser.add_argument('--backend', type=str, default='disk',
                        help='disk or lmdb')
    parser.add_argument('--device', default='cuda')
    args = parser.parse_args(argv)

    inception = load_patched_inception_v3(device=args.device)
    opt = {'name': 'FFHQ', 'type': 'FFHQDataset',
           'dataroot_gt': args.dataroot, 'io_backend': {'type': args.backend},
           'use_hflip': False, 'mean': [0.5, 0.5, 0.5],
           'std': [0.5, 0.5, 0.5]}
    dataset = build_dataset(opt)
    num_sample = min(args.num_sample, len(dataset))
    features = extract_inception_features(
        batches(dataset, 'gt', num_sample, args.batch_size), inception)
    mean, cov = stats(features, num_sample)
    save_path = f'inception_{opt["name"]}_{args.size}.npz'
    np.savez(save_path, name=opt['name'], size=args.size, mean=mean, cov=cov)
    print(f'saved statistics to {save_path}')
    return save_path


if __name__ == '__main__':
    main()
