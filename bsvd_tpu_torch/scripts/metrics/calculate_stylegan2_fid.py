"""FID of a StyleGAN2 generator checkpoint against dataset statistics
(counterpart of the JAX repo's scripts/metrics/calculate_stylegan2_fid.py).

    python -m bsvd_tpu_torch.scripts.metrics.calculate_stylegan2_fid \\
        <ckpt> <fid_stats> [--size 256] [--channel_multiplier 2] \\
        [--num_sample 50000] [--batch_size 64] [--truncation 1] \\
        [--truncation_mean 4096] [--seed 0] [--device cuda|cpu]

The generator (512 style features, 8 mapping layers, resample kernel
(1, 3, 3, 1)) loads ``params_ema`` of a BasicSR ``.pth`` or an ``.npz`` of
either package and samples with its fixed noise. The codes (and the
truncation mean's) are drawn from one ``torch.Generator`` seeded with
``--seed`` on the device: the JAX script draws from ``jax.random``, so the
two scripts score other samples of one net.
"""

import argparse
import math

import numpy as np
import torch

from bsvd_tpu_torch.archs.stylegan2_arch import StyleGAN2Generator
from bsvd_tpu_torch.convert.torch_generic import load_torch_generic
from bsvd_tpu_torch.metrics.fid import (calculate_fid,
                                        extract_inception_features,
                                        load_patched_inception_v3)
from bsvd_tpu_torch.scripts.metrics.calculate_fid_folder import load_stats
from bsvd_tpu_torch.scripts.metrics.calculate_fid_stats_from_datasets import (
    stats)


def samples(generator, z_batches, truncation=1, truncation_latent=None):
    """The generator's images, (N, 3, H, W) in [-1, 1], of each code batch
    (fixed noise)."""
    with torch.no_grad():
        for z in z_batches:
            yield generator([z], truncation=truncation,
                            truncation_latent=truncation_latent,
                            randomize_noise=False)[0]


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('ckpt', type=str,
                        help='Path to the stylegan2 checkpoint.')
    parser.add_argument('fid_stats', type=str,
                        help='Path to the dataset fid statistics.')
    parser.add_argument('--size', type=int, default=256)
    parser.add_argument('--channel_multiplier', type=int, default=2)
    parser.add_argument('--batch_size', type=int, default=64)
    parser.add_argument('--num_sample', type=int, default=50000)
    parser.add_argument('--truncation', type=float, default=1)
    parser.add_argument('--truncation_mean', type=int, default=4096)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--device', default='cuda')
    args = parser.parse_args(argv)

    device = torch.device(args.device)
    generator = StyleGAN2Generator(
        out_size=args.size, num_style_feat=512, num_mlp=8,
        channel_multiplier=args.channel_multiplier,
        resample_kernel=(1, 3, 3, 1))
    load_torch_generic(args.ckpt, generator, 'params_ema')
    generator = generator.to(device).eval()
    gen = torch.Generator(device).manual_seed(args.seed)
    truncation_latent = None
    if args.truncation < 1:
        with torch.no_grad():
            truncation_latent = generator.mean_latent(args.truncation_mean,
                                                      generator=gen)
    inception = load_patched_inception_v3(device=device)
    total_batch = math.ceil(args.num_sample / args.batch_size)
    z_batches = (torch.randn(args.batch_size, 512, generator=gen,
                             device=device) for _ in range(total_batch))
    features = extract_inception_features(
        samples(generator, z_batches, args.truncation, truncation_latent),
        inception)
    sample_mean, sample_cov = stats(features, args.num_sample)
    real_mean, real_cov = load_stats(args.fid_stats)
    fid = calculate_fid(sample_mean, sample_cov, real_mean, real_cov)
    print('fid:', fid)
    return fid


if __name__ == '__main__':
    main()
