"""Degraded LQ faces from a GT folder by the HiFaceGAN paper's templates
(counterpart of the JAX repo's
scripts/data_preparation/prepare_hifacegan_dataset.py).

    python -m bsvd_tpu_torch.scripts.data_preparation.prepare_hifacegan_dataset \\
        --gt_folder datasets/FFHQ_512_gt --deg sr4x [--lq_folder <out>] \\
        [--seed 0] [--device cuda|cpu]

Templates: sr4x, sr4x8x, denoise, deblur, jpeg, 16x, face_renov (the last
chains deblur, denoise, jpeg and sr4x8x in a random order). The draws are
the JAX script's ``np.random.default_rng(seed)`` draws in the same order,
so a seed gives the same degradation parameters. The image work runs on
``device`` through ``utils/cv2_ops``; the noise is drawn on the host (it is
numpy's stream) and added on the device; the JPEG round trip goes through
the port's JPEG writer and decoder on the host. Frames are read and
written with the port's codecs, as cv2.imread / cv2.imwrite do for the
JAX script (files that do not decode are skipped, as cv2.imread's None).

The LQ files equal the JAX script's but where cv2_ops states a gap with
cv2: the cubic upscale of sr4x / sr4x8x / face_renov (cv2 runs IPP), and
the motion blur (cv2 warps the float kernel's last W % 16 columns apart,
and filters from 12 x 12 taps through a DFT): at most 1 LSB on at most
0.1% of pixels; after face_renov's JPEG step such a pixel can move its
8 x 8 block.
"""

import argparse
import os

import numpy as np
import torch

from bsvd_tpu_torch.utils import cv2_ops


def _mosaic16(img, rng):
    """Each 16 x 16 block replaced by its mean (float64, truncated)."""
    del rng
    h, w, c = img.shape
    ph, pw = -h % 16, -w % 16
    x = torch.nn.functional.pad(img.double().permute(2, 0, 1),
                                (0, pw, 0, ph)).permute(1, 2, 0)
    blocks = x.reshape((h + ph) // 16, 16, (w + pw) // 16, 16, c)
    counts = torch.nn.functional.pad(
        torch.ones((h, w), dtype=torch.float64, device=img.device),
        (0, pw, 0, ph)).reshape((h + ph) // 16, 16, (w + pw) // 16, 16)
    mean = blocks.sum((1, 3)) / counts.sum((1, 3))[..., None]
    out = mean[:, None, :, None].expand(-1, 16, -1, 16, -1)
    out = out.reshape(h + ph, w + pw, c)[:h, :w]
    return out.clamp(0, 255).to(torch.uint8)


def _resize_chain(img, rng, lo, hi):
    """Area-downscale by a random factor in [lo, hi], cubic-upscale
    back."""
    h, w = img.shape[:2]
    s = rng.uniform(lo, hi)
    small = cv2_ops.resize(img, (max(1, round(w * s)), max(1, round(h * s))),
                           interpolation=cv2_ops.INTER_AREA)
    return cv2_ops.resize(small, (w, h), interpolation=cv2_ops.INTER_CUBIC)


def _noise(img, rng):
    """One of gaussian / laplace / poisson noise, per channel."""
    x = img.double()
    shape = tuple(img.shape)
    kind = rng.integers(0, 3)
    if kind == 0:
        noise = rng.normal(0, rng.uniform(20, 40), shape)
    elif kind == 1:
        noise = rng.laplace(0, rng.uniform(20, 40), shape)
    else:
        lam = rng.uniform(15, 30)
        noise = rng.poisson(lam, shape) - lam
        noise = np.where(rng.random(shape) < 0.5, noise, -noise)
    x = x + torch.from_numpy(noise).to(img.device)
    return x.clamp(0, 255).to(torch.uint8)


def numpy_sum_f32(t):
    """numpy's float32 sum of a contiguous array (its pairwise algorithm:
    blocks of up to 128 in 8 running sums), as a 0-d tensor on t's device:
    the motion kernel is normalised by the JAX script's ``kern.sum()``."""
    t = t.reshape(-1).float()
    n = t.numel()
    if n < 8:
        res = torch.zeros((), dtype=torch.float32, device=t.device)
        for i in range(n):
            res = res + t[i]
        return res
    if n <= 128:
        m = n - n % 8
        r = t[:8].clone()
        for i in range(8, m, 8):
            r = r + t[i:i + 8]
        res = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]))
        for i in range(m, n):
            res = res + t[i]
        return res
    n2 = n // 2
    n2 -= n2 % 8
    return numpy_sum_f32(t[:n2]) + numpy_sum_f32(t[n2:])


def _motion_kernel(k, angle_deg, device):
    kern = torch.zeros((k, k), dtype=torch.float32, device=device)
    kern[k // 2, :] = 1.0
    rot = cv2_ops.get_rotation_matrix_2d((k / 2 - 0.5, k / 2 - 0.5),
                                         angle_deg, 1.0)
    kern = cv2_ops.warp_affine(kern, rot, (k, k))
    s = numpy_sum_f32(kern)
    return kern / s if float(s) > 0 else kern


def _blur(img, rng):
    """One of motion blur (k in [10, 20]) / gaussian blur (sigma in
    [3, 8])."""
    if rng.integers(0, 2) == 0:
        k = int(rng.integers(10, 21))
        return cv2_ops.filter2d(img, -1, _motion_kernel(
            k, rng.uniform(0, 360), img.device))
    sigma = rng.uniform(3.0, 8.0)
    ksize = int(2 * round(3 * sigma) + 1)
    return cv2_ops.gaussian_blur(img, (ksize, ksize), sigma)


def _jpeg(img, rng):
    """JPEG at imgaug's compression 50-85, cv2's quality 50-15."""
    from bsvd_tpu_torch.data import jpeg_decode
    from bsvd_tpu_torch.utils.jpeg_encode import encode_jpeg
    quality = int(100 - rng.uniform(50, 85))
    rgb = img.flip(-1).cpu().numpy()
    out = jpeg_decode.decode(encode_jpeg(rgb, quality))
    return torch.from_numpy(np.ascontiguousarray(out[..., ::-1])).to(
        img.device)


def _face_renov(img, rng):
    ops = [_blur, _noise, _jpeg,
           lambda x, r: _resize_chain(x, r, 0.125, 0.25)]
    for idx in rng.permutation(len(ops)):
        img = ops[idx](img, rng)
    return img


DEG_TEMPLATES = {
    'sr4x': lambda x, r: _resize_chain(x, r, 0.25, 0.25001),
    'sr4x8x': lambda x, r: _resize_chain(x, r, 0.125, 0.25),
    'denoise': _noise,
    'deblur': _blur,
    'jpeg': _jpeg,
    '16x': _mosaic16,
    'face_renov': _face_renov,
}


def _read(path):
    """A frame as cv2.imread reads it (BGR uint8), or None where cv2.imread
    gives None (a folder, a file that does not decode)."""
    from bsvd_tpu_torch.utils.img_util import imfrombytes
    if not os.path.isfile(path):
        return None
    with open(path, 'rb') as f:
        data = f.read()
    try:
        return imfrombytes(data, 'color')
    except (ValueError, OSError, NotImplementedError):
        return None


def degrade(gt, deg, rng, device='cuda'):
    """One BGR uint8 GT face (array or tensor) through template ``deg``
    with ``rng``'s draws -> its LQ as a uint8 tensor on ``device``."""
    if not torch.is_tensor(gt):
        gt = torch.from_numpy(np.ascontiguousarray(gt))
    return DEG_TEMPLATES[deg](gt.to(device), rng)


def create_training_dataset(deg, gt_folder, lq_folder=None, seed=0,
                            device='cuda'):
    from bsvd_tpu_torch.utils.img_util import imwrite
    if deg not in DEG_TEMPLATES:
        raise ValueError(f'Degradation type {deg!r} not recognized: '
                         f'{"|".join(DEG_TEMPLATES)}')
    if not lq_folder:
        lq_folder = '_'.join([gt_folder.replace('gt', 'lq'), deg])
    print(lq_folder)
    os.makedirs(lq_folder, exist_ok=True)
    rng = np.random.default_rng(seed)
    names = sorted(os.listdir(gt_folder))
    for name in names:
        gt = _read(os.path.join(gt_folder, name))
        if gt is None:
            continue
        lq = degrade(gt, deg, rng, device)
        imwrite(lq.cpu().numpy(), os.path.join(lq_folder, name))
    print(f'Dataset prepared ({len(names)} images).')


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--gt_folder', required=True)
    ap.add_argument('--lq_folder', default=None)
    ap.add_argument('--deg', default='sr4x', choices=sorted(DEG_TEMPLATES))
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--device', default='cuda')
    a = ap.parse_args(argv)
    create_training_dataset(a.deg, a.gt_folder, a.lq_folder, a.seed,
                            a.device)


if __name__ == '__main__':
    main()
