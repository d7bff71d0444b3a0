"""SwinIR inference over a folder (counterpart of the JAX repo's
inference/inference_swinir.py).

    python -m bsvd_tpu_torch.inference.inference_swinir \\
        --model_path <ckpt> --input <folder> --output results/SwinIR \\
        [--task classical_sr|lightweight_sr|color_dn] [--scale 4] \\
        [--device cuda|cpu]

The three tasks build the JAX script's nets: classical SR (embed 180, six
RSTBs of depth 6 and 6 heads, window 8, MLP ratio 2, pixelshuffle),
lightweight SR (embed 60, four RSTBs, pixelshuffledirect) and colour
denoising (embed 180, six RSTBs, no upsampler, x1). ``--model_path`` is a
released SwinIR ``.pth`` or an ``.npz`` of either package, read under
``params``. Each image of ``--input`` (the port's decoders, as
``cv2.imread(IMREAD_COLOR)``) is written as ``<name>_SwinIR.png``: the
fp32 output through ``tensor2img``.
"""

import argparse
import os

import torch

from bsvd_tpu_torch.archs import build_network
from bsvd_tpu_torch.convert.torch_generic import load_torch_generic
from bsvd_tpu_torch.inference._common import folder_images
from bsvd_tpu_torch.utils.img_util import imwrite, tensor2img


def task_network(task, scale):
    """The JAX script's network options for ``task``."""
    if task == 'classical_sr':
        return dict(type='SwinIR', upscale=scale, in_chans=3, img_size=48,
                    window_size=8, depths=(6, 6, 6, 6, 6, 6), embed_dim=180,
                    num_heads=(6, 6, 6, 6, 6, 6), mlp_ratio=2,
                    upsampler='pixelshuffle')
    if task == 'lightweight_sr':
        return dict(type='SwinIR', upscale=scale, in_chans=3, img_size=64,
                    window_size=8, depths=(6, 6, 6, 6), embed_dim=60,
                    num_heads=(6, 6, 6, 6), mlp_ratio=2,
                    upsampler='pixelshuffledirect')
    return dict(type='SwinIR', upscale=1, in_chans=3, img_size=128,
                window_size=8, depths=(6, 6, 6, 6, 6, 6), embed_dim=180,
                num_heads=(6, 6, 6, 6, 6, 6), mlp_ratio=2, upsampler='')


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--model_path', required=True)
    ap.add_argument('--input', default='datasets/LR')
    ap.add_argument('--output', default='results/SwinIR')
    ap.add_argument('--task', default='classical_sr',
                    choices=['classical_sr', 'lightweight_sr', 'color_dn'])
    ap.add_argument('--scale', type=int, default=4)
    ap.add_argument('--device', default='cuda')
    a = ap.parse_args(argv)

    net = build_network(task_network(a.task, a.scale), a.device).eval()
    load_torch_generic(a.model_path, net, 'params')
    os.makedirs(a.output, exist_ok=True)
    for idx, name, img in folder_images(a.input):
        print(f'{idx} {name}')
        with torch.no_grad():
            out = net(torch.from_numpy(img[None]).to(a.device))
        imwrite(tensor2img(out[0].cpu().numpy()),
                os.path.join(a.output, f'{name}_SwinIR.png'))


if __name__ == '__main__':
    main()
