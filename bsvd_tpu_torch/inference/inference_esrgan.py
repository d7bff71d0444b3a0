"""ESRGAN (RRDBNet, 64 features, 23 blocks) single-image inference
(counterpart of the JAX repo's inference/inference_esrgan.py).

    python -m bsvd_tpu_torch.inference.inference_esrgan \\
        --model_path <ckpt> --input <folder> --output results/ESRGAN \\
        [--scale 4] [--device cuda|cpu]

Each image of ``--input`` is written as ``<name>_ESRGAN.png``: the net's
fp32 output through ``tensor2img`` (clip, x 255, round half to even).
``--model_path`` is a BasicSR ``.pth`` or an ``.npz`` of either package
(``params``).
"""

import argparse
import os

import torch

from bsvd_tpu_torch.archs import build_network
from bsvd_tpu_torch.convert.torch_generic import load_torch_generic
from bsvd_tpu_torch.inference._common import folder_images
from bsvd_tpu_torch.utils.img_util import imwrite, tensor2img


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--model_path', type=str, required=True)
    ap.add_argument('--input', type=str, default='datasets/LR')
    ap.add_argument('--output', type=str, default='results/ESRGAN')
    ap.add_argument('--scale', type=int, default=4)
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)

    net = build_network({'type': 'RRDBNet', 'num_in_ch': 3, 'num_out_ch': 3,
                         'num_feat': 64, 'num_block': 23,
                         'scale': args.scale}, args.device).eval()
    load_torch_generic(args.model_path, net, 'params')
    os.makedirs(args.output, exist_ok=True)
    for idx, name, img in folder_images(args.input):
        print(f'{idx} {name}')
        with torch.no_grad():
            out = net(torch.from_numpy(img[None]).to(args.device))
        imwrite(tensor2img(out[0].cpu().numpy()),
                os.path.join(args.output, f'{name}_ESRGAN.png'))


if __name__ == '__main__':
    main()
