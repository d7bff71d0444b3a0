"""RIDNet denoising inference (counterpart of the JAX repo's
inference/inference_ridnet.py).

    python -m bsvd_tpu_torch.inference.inference_ridnet \\
        --model_path <ckpt> --test_path <folder> --noise_g 25 \\
        [--output results/RIDNet] [--device cuda|cpu]

Gaussian noise of sigma ``noise_g`` / 255 is added to each image first
(0: the input is already noisy), drawn, as the JAX script draws it, from
one ``numpy.random.default_rng(0)`` in the images' sorted order; each
output, clipped to [0, 1], is written as ``<name>_RIDNet.png``.
"""

import argparse
import os

import numpy as np
import torch

from bsvd_tpu_torch.archs import build_network
from bsvd_tpu_torch.convert.torch_generic import load_torch_generic
from bsvd_tpu_torch.inference._common import folder_images
from bsvd_tpu_torch.utils.img_util import imwrite, tensor2img


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--model_path', required=True)
    ap.add_argument('--test_path', default='datasets/denoise')
    ap.add_argument('--output', default='results/RIDNet')
    ap.add_argument('--noise_g', type=int, default=25,
                    help='add Gaussian noise of this sigma before denoising '
                         '(0 = input is already noisy)')
    ap.add_argument('--device', default='cuda')
    a = ap.parse_args(argv)

    net = build_network({'type': 'RIDNet', 'in_channels': 3,
                         'mid_channels': 64, 'out_channels': 3},
                        a.device).eval()
    load_torch_generic(a.model_path, net, 'params')
    os.makedirs(a.output, exist_ok=True)
    rng = np.random.default_rng(0)
    for idx, name, img in folder_images(a.test_path):
        print(f'{idx} {name}')
        if a.noise_g:
            img = img + rng.normal(0, a.noise_g / 255.,
                                   img.shape).astype(np.float32)
        with torch.no_grad():
            out = net(torch.from_numpy(img[None]).to(a.device))
        imwrite(tensor2img(np.clip(out[0].cpu().numpy(), 0, 1)),
                os.path.join(a.output, f'{name}_RIDNet.png'))


if __name__ == '__main__':
    main()
