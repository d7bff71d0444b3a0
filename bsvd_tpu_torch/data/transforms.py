"""Paired crop and augment transforms on HWC numpy images (counterpart of
bsvd_tpu/data/transforms.py): ``mod_crop``, ``paired_random_crop`` and
``augment`` (flips, 90 degree rotation, flows), and their draws alone
(``crop_origin``, ``flip_draws``). Each draws from the
``random.Random`` it is given (the ``random`` module without one), in the
JAX package's order, so a seeded dataset crops and flips as JAX's does."""

import random

import numpy as np


def mod_crop(img, scale):
    """Crop H and W down to multiples of ``scale``."""
    img = np.asarray(img)
    if img.ndim not in (2, 3):
        raise ValueError(f'Wrong img ndim: {img.ndim}.')
    h, w = img.shape[0], img.shape[1]
    return img[:h - h % scale, :w - w % scale, ...]


def crop_origin(gt_hw, lq_hw, gt_patch_size, scale, gt_path=None,
                rng=None):
    """The LQ patch's (top, left) of ``paired_random_crop``, drawn from
    ``rng`` for images of these (H, W) (the draws of a crop without the
    images)."""
    rng = rng or random
    (h_gt, w_gt), (h_lq, w_lq) = gt_hw, lq_hw
    lq_patch_size = gt_patch_size // scale
    if h_gt != h_lq * scale or w_gt != w_lq * scale:
        raise ValueError(f'Scale mismatches. GT ({h_gt}, {w_gt}) is not '
                         f'{scale}x multiplication of LQ ({h_lq}, {w_lq}).')
    if h_lq < lq_patch_size or w_lq < lq_patch_size:
        raise ValueError(f'LQ ({h_lq}, {w_lq}) is smaller than patch size '
                         f'({lq_patch_size}, {lq_patch_size}). Check '
                         f'{gt_path}.')
    top = rng.randint(0, h_lq - lq_patch_size)
    left = rng.randint(0, w_lq - lq_patch_size)
    return top, left


def flip_draws(hflip=True, rotation=True, rng=None):
    """``augment``'s (hflip, vflip, rot90), drawn from ``rng`` in its
    order."""
    rng = rng or random
    hflip = hflip and rng.random() < 0.5
    vflip = rotation and rng.random() < 0.5
    rot90 = rotation and rng.random() < 0.5
    return hflip, vflip, rot90


def paired_random_crop(img_gts, img_lqs, gt_patch_size, scale, gt_path=None,
                       rng=None):
    """A random LQ patch of ``gt_patch_size // scale`` and the GT patch
    over it (arrays or lists of arrays, returned in kind)."""
    single_gt = not isinstance(img_gts, list)
    single_lq = not isinstance(img_lqs, list)
    if single_gt:
        img_gts = [img_gts]
    if single_lq:
        img_lqs = [img_lqs]
    lq_patch_size = gt_patch_size // scale
    top, left = crop_origin(img_gts[0].shape[0:2], img_lqs[0].shape[0:2],
                            gt_patch_size, scale, gt_path, rng)
    img_lqs = [v[top:top + lq_patch_size, left:left + lq_patch_size, ...]
               for v in img_lqs]
    top_gt, left_gt = int(top * scale), int(left * scale)
    img_gts = [v[top_gt:top_gt + gt_patch_size,
                 left_gt:left_gt + gt_patch_size, ...] for v in img_gts]
    return (img_gts[0] if single_gt else img_gts,
            img_lqs[0] if single_lq else img_lqs)


def augment(imgs, hflip=True, rotation=True, flows=None, return_status=False,
            rng=None):
    """Random horizontal flip, vertical flip and transpose (each with
    probability 1/2, drawn in that order) of HWC images, and of flows,
    whose components change sign and swap with them."""
    hflip, vflip, rot90 = flip_draws(hflip, rotation, rng)

    def _augment(img):
        if hflip:
            img = img[:, ::-1, ...]
        if vflip:
            img = img[::-1, :, ...]
        if rot90:
            img = img.transpose(1, 0, 2) if img.ndim == 3 else img.T
        return np.ascontiguousarray(img)

    def _augment_flow(flow):
        if hflip:
            flow = flow[:, ::-1, :].copy()
            flow[:, :, 0] *= -1
        if vflip:
            flow = flow[::-1, :, :].copy()
            flow[:, :, 1] *= -1
        if rot90:
            flow = flow.transpose(1, 0, 2)[:, :, [1, 0]]
        return np.ascontiguousarray(flow)

    def each(fn, items):
        if isinstance(items, list):
            return [fn(v) for v in items]
        return fn(items)

    imgs = each(_augment, imgs)
    status = (hflip, vflip, rot90)
    if flows is not None:
        flows = each(_augment_flow, flows)
        return (imgs, flows, status) if return_status else (imgs, flows)
    return (imgs, status) if return_status else imgs
