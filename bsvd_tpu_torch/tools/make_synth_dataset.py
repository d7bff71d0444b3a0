"""A small synthetic video dataset, folders of frames, for smoke runs and
benchmarks where Set8 / DAVIS are not on disk (counterpart of the JAX
repo's tools/make_synth_dataset.py: the same frames, pixel for pixel,
written by the port's own PNG / JPEG / TIFF writers instead of cv2).

    python -m bsvd_tpu_torch.tools.make_synth_dataset OUT_DIR
        [--num_clips 2] [--frames 12] [--height 64] [--width 64]
        [--seed 0] [--format png|jpg|tif]

Frames are smooth moving gradients and a moving disc, so that denoising
metrics behave (pure noise would make PSNR meaningless). ``jpg`` mirrors
DAVIS-train's storage (quality 95), ``png`` Set8-style lossless eval
data, ``tif`` the same frames as LZW TIFF. Prints one JSON line.
"""

import argparse
import json
import os
import sys

import numpy as np

from bsvd_tpu_torch.utils.img_util import IMWRITE_JPEG_QUALITY, imwrite

FORMATS = {'png': [], 'jpg': [IMWRITE_JPEG_QUALITY, 95], 'tif': []}


def make_clip(seed, t, h, w):
    """``t`` uint8 RGB frames (h, w, 3) of clip ``seed``: the JAX tool's
    draws and arithmetic, in its order."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    fx, fy = rng.uniform(0.5, 2, 2)
    phase_v = rng.uniform(0, 2 * np.pi, 3)
    speed = rng.uniform(0.05, 0.2)
    cx, cy = rng.uniform(0.2, 0.8) * w, rng.uniform(0.2, 0.8) * h
    r = rng.uniform(0.1, 0.3) * min(h, w)
    frames = []
    for i in range(t):
        img = np.stack([
            0.5 + 0.4 * np.sin(2 * np.pi * (fx * xx / w + fy * yy / h) + p
                               + speed * i)
            for p in phase_v], axis=-1)
        dx = cx + 2.0 * i                      # the moving disc
        mask = ((xx - dx) ** 2 + (yy - cy) ** 2) < r ** 2
        img[mask] = rng.uniform(0.1, 0.9, 3)
        frames.append((np.clip(img, 0, 1) * 255).astype(np.uint8))
    return frames


def write(out_dir, num_clips=2, t=12, h=64, w=64, seed=0, fmt='png'):
    """Write ``num_clips`` folders ``clipNN/00000.<fmt>``...; returns the
    folders."""
    if fmt not in FORMATS:
        raise ValueError(f'format {fmt!r}: {sorted(FORMATS)}')
    folders = []
    for c in range(num_clips):
        clip_dir = os.path.join(out_dir, f'clip{c:02d}')
        os.makedirs(clip_dir, exist_ok=True)
        for i, frame in enumerate(make_clip(seed + c, t, h, w)):
            imwrite(np.ascontiguousarray(frame[..., ::-1]),
                    os.path.join(clip_dir, f'{i:05d}.{fmt}'), FORMATS[fmt])
        folders.append(clip_dir)
    return folders


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('out_dir')
    ap.add_argument('--num_clips', type=int, default=2)
    ap.add_argument('--frames', type=int, default=12)
    ap.add_argument('--height', type=int, default=64)
    ap.add_argument('--width', type=int, default=64)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--format', default='png', choices=sorted(FORMATS))
    a = ap.parse_args(argv)
    folders = write(a.out_dir, a.num_clips, a.frames, a.height, a.width,
                    a.seed, a.format)
    rec = {'tool': 'make_synth_dataset', 'out_dir': a.out_dir,
           'clips': len(folders), 'frames': a.frames,
           'height': a.height, 'width': a.width, 'format': a.format}
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == '__main__':
    main(sys.argv[1:])
