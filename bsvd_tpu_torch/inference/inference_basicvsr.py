"""BasicVSR (64 features, 30 blocks) video inference over a folder of LR
frames (counterpart of the JAX repo's inference/inference_basicvsr.py).

    python -m bsvd_tpu_torch.inference.inference_basicvsr \\
        --model_path <ckpt> --input_path <frame folder> \\
        [--save_path results/BasicVSR] [--interval 15] [--device cuda|cpu]

The folder's frames are read as ``open_sequence`` reads them and go
through the net ``--interval`` frames at a time (each chunk its own
clip); frame i is written as ``<i:08d>_BasicVSR.png``: the fp32 output
through ``tensor2img``. ``--model_path`` is a BasicSR ``.pth`` or an
``.npz`` of either package (``params``).
"""

import argparse
import os

import torch

from bsvd_tpu_torch.archs import build_network
from bsvd_tpu_torch.convert.torch_generic import load_torch_generic
from bsvd_tpu_torch.data.utils_common import open_sequence
from bsvd_tpu_torch.utils.img_util import imwrite, tensor2img


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--model_path', type=str, required=True)
    ap.add_argument('--input_path', type=str, required=True)
    ap.add_argument('--save_path', type=str, default='results/BasicVSR')
    ap.add_argument('--interval', type=int, default=15,
                    help='frames per forward (memory bound)')
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)

    net = build_network({'type': 'BasicVSR', 'num_feat': 64,
                         'num_block': 30}, args.device).eval()
    load_torch_generic(args.model_path, net, 'params')
    seq, _, _ = open_sequence(args.input_path, max_num_fr=10 ** 6)
    os.makedirs(args.save_path, exist_ok=True)
    for start in range(0, seq.shape[0], args.interval):
        chunk = torch.from_numpy(seq[start:start + args.interval])
        with torch.no_grad():
            out = net(chunk[None].to(args.device))[0].cpu().numpy()
        for i in range(out.shape[0]):
            imwrite(tensor2img(out[i]), os.path.join(
                args.save_path, f'{start + i:08d}_BasicVSR.png'))


if __name__ == '__main__':
    main()
