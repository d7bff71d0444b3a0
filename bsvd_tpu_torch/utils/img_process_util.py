"""Unsharp masking (counterpart of bsvd_tpu/utils/img_process_util.py):
``usm_sharp`` on one image through ``utils/cv2_ops`` (cv2's GaussianBlur
in JAX), and ``usm_sharp_torch``, the batched form of JAX's
``usm_sharp_jax`` on (N, H, W, C) tensors, both on the tensor's device."""

import torch
import torch.nn.functional as F

from bsvd_tpu_torch.utils import cv2_ops


def usm_sharp(img, weight=0.5, radius=50, threshold=10):
    """Unsharp masking with a soft threshold mask.

    Args:
        img (Tensor): (H, W, C) BGR float32 in [0, 1].
    """
    if radius % 2 == 0:
        radius += 1
    blur = cv2_ops.gaussian_blur(img, (radius, radius), 0)
    residual = img - blur
    mask = (torch.abs(residual) * 255 > threshold).float()
    soft_mask = cv2_ops.gaussian_blur(mask, (radius, radius), 0)

    sharp = img + weight * residual
    sharp = torch.clamp(sharp, 0, 1)
    return soft_mask * sharp + (1 - soft_mask) * img


def usm_sharp_torch(img, weight=0.5, radius=51, threshold=10):
    """Batched USM on (N, H, W, C) tensors: JAX's separable Gaussian of
    cv2's default sigma for ``radius``, reflect padding (edge not
    repeated)."""
    if radius % 2 == 0:
        radius += 1
    sigma = 0.3 * ((radius - 1) * 0.5 - 1) + 0.8    # cv2's default sigma
    half = radius // 2
    xs = torch.arange(-half, half + 1, dtype=img.dtype, device=img.device)
    g = torch.exp(-0.5 * (xs / sigma) ** 2)
    g = g / g.sum()

    def blur(x):
        c = x.shape[-1]
        y = x.permute(0, 3, 1, 2)
        y = F.pad(y, (half, half, half, half), mode='reflect')
        y = F.conv2d(y, g.view(1, 1, radius, 1).repeat(c, 1, 1, 1),
                     groups=c)
        y = F.conv2d(y, g.view(1, 1, 1, radius).repeat(c, 1, 1, 1),
                     groups=c)
        return y.permute(0, 2, 3, 1)

    residual = img - blur(img)
    mask = (torch.abs(residual) * 255 > threshold).to(img.dtype)
    soft_mask = blur(mask)
    sharp = torch.clamp(img + weight * residual, 0, 1)
    return soft_mask * sharp + (1 - soft_mask) * img
