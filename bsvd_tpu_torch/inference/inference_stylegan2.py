"""Sample images from a StyleGAN2 generator checkpoint (counterpart of the
JAX repo's inference/inference_stylegan2.py).

    python -m bsvd_tpu_torch.inference.inference_stylegan2 --ckpt <ckpt> \\
        --size 1024 --sample 1 --pics 1 [--truncation 0.7] \\
        [--output samples] [--seed 2020] [--device cuda|cpu]

The generator (512 style features, 8 mapping layers) loads ``params_ema``
of a BasicSR ``.pth`` or an ``.npz`` of either package. Each picture is
``--sample`` images from one seeded ``torch.Generator`` (codes, then
noise; the JAX script's draws come from its own keys, so the two give
other images of one net), mapped from (-1, 1) to [0, 1], tiled
``int(sqrt(sample))`` to a row and written as ``<output>/<i:06d>.png``
(x 255, rounded half to even, BGR).
"""

import argparse
import math
import os

import numpy as np
import torch

from bsvd_tpu_torch.archs.stylegan2_arch import StyleGAN2Generator
from bsvd_tpu_torch.convert.torch_generic import load_torch_generic
from bsvd_tpu_torch.utils.img_util import imwrite


def tile(arr, nrow):
    """(B, C, H, W) -> (C, rows * H, nrow * W), row-major, zeros where
    the last row is short."""
    b, c, h, w = arr.shape
    rows = int(np.ceil(b / nrow))
    grid = np.zeros((c, rows * h, nrow * w), arr.dtype)
    for j in range(b):
        r, q = divmod(j, nrow)
        grid[:, r * h:(r + 1) * h, q * w:(q + 1) * w] = arr[j]
    return grid


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--size', type=int, default=1024)
    ap.add_argument('--sample', type=int, default=1)
    ap.add_argument('--pics', type=int, default=1)
    ap.add_argument('--truncation', type=float, default=1)
    ap.add_argument('--truncation_mean', type=int, default=4096)
    ap.add_argument('--ckpt', type=str, required=True)
    ap.add_argument('--channel_multiplier', type=int, default=2)
    ap.add_argument('--randomize_noise', type=lambda s: s != 'False',
                    default=True)
    ap.add_argument('--output', default='samples')
    ap.add_argument('--seed', type=int, default=2020)
    ap.add_argument('--device', default='cuda')
    a = ap.parse_args(argv)

    device = torch.device(a.device)
    os.makedirs(a.output, exist_ok=True)
    g = StyleGAN2Generator(a.size, num_style_feat=512, num_mlp=8,
                           channel_multiplier=a.channel_multiplier)
    load_torch_generic(a.ckpt, g, 'params_ema')
    g = g.to(device).eval()
    gen = torch.Generator(device).manual_seed(a.seed)
    mean_latent = None
    with torch.no_grad():
        if a.truncation < 1:
            mean_latent = g.mean_latent(a.truncation_mean, generator=gen)
        nrow = int(math.sqrt(a.sample))
        for i in range(a.pics):
            z = torch.randn(a.sample, 512, generator=gen, device=device)
            img, _ = g([z], truncation=a.truncation,
                       truncation_latent=mean_latent,
                       randomize_noise=a.randomize_noise, generator=gen)
            arr = ((img + 1) / 2).clamp(0, 1).float().cpu().numpy()
            grid = tile(arr, nrow)
            bgr = (np.transpose(grid, (1, 2, 0))[:, :, ::-1] * 255).round()
            imwrite(bgr.astype(np.uint8),
                    os.path.join(a.output, f'{i:06d}.png'))
            print(f'saved {a.output}/{i:06d}.png')


if __name__ == '__main__':
    main()
