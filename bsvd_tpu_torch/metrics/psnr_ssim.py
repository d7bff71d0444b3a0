"""PSNR / SSIM / float PSNR with the reference's conventions, in numpy
float64 (counterpart of bsvd_tpu/metrics/psnr_ssim.py): uint8 inputs in
[0, 255], optional border crop, optional Y channel; SSIM on the 11x11
sigma-1.5 Gaussian window with MATLAB's constants.

SSIM needs no cv2: ``cv2.getGaussianKernel(11, 1.5)`` is the normalised
``exp(-(i-5)^2 / 4.5)``, and only the ``[5:-5, 5:-5]`` region of
``cv2.filter2D`` is kept, where the window never reaches the border, so a
valid-mode separable correlation gives the same numbers.
"""

import numpy as np
from scipy.ndimage import correlate1d

from bsvd_tpu_torch.utils.registry import METRIC_REGISTRY

_TAPS = np.exp(-(np.arange(11) - 5.0) ** 2 / (2 * 1.5 ** 2))
GAUSS_11 = _TAPS / _TAPS.sum()


def reorder_image(img, input_order='HWC'):
    if input_order not in ('HWC', 'CHW'):
        raise ValueError(f"Wrong input_order {input_order}; use 'HWC' or "
                         f"'CHW'")
    if len(img.shape) == 2:
        return img[..., None]
    if input_order == 'CHW':
        img = img.transpose(1, 2, 0)
    return img


def to_y_channel(img):
    """BGR [0, 255] -> the Y channel (BT.601, MATLAB's convention) in
    [16, 235], through the reference's [0, 1] round trip."""
    img = img.astype(np.float32) / 255.
    if img.ndim == 3 and img.shape[2] == 3:
        img = np.dot(img, np.array([24.966, 128.553, 65.481],
                                   dtype=np.float32)) + 16.0
        img = img[..., None] / 255.
    return img * 255.


def _prepare(img, img2, crop_border, input_order, test_y_channel):
    img = reorder_image(np.asarray(img), input_order).astype(np.float64)
    img2 = reorder_image(np.asarray(img2), input_order).astype(np.float64)
    if img.shape != img2.shape:
        raise ValueError(f'Image shapes differ: {img.shape} vs '
                         f'{img2.shape}.')
    if crop_border != 0:
        img = img[crop_border:-crop_border, crop_border:-crop_border, ...]
        img2 = img2[crop_border:-crop_border, crop_border:-crop_border, ...]
    if test_y_channel:
        img, img2 = to_y_channel(img), to_y_channel(img2)
    return img, img2


@METRIC_REGISTRY.register()
def calculate_psnr(img, img2, crop_border, input_order='HWC',
                   test_y_channel=False, **kwargs):
    """PSNR of uint8 images in [0, 255]."""
    img, img2 = _prepare(img, img2, crop_border, input_order,
                         test_y_channel)
    mse = np.mean((img - img2) ** 2)
    if mse == 0:
        return float('inf')
    return 20. * np.log10(255. / np.sqrt(mse))


def _window_mean(a):
    """The 11x11 Gaussian-weighted mean at every pixel whose window lies
    inside ``a``: (H-10, W-10)."""
    a = correlate1d(a, GAUSS_11, axis=0, mode='constant')[5:-5]
    return correlate1d(a, GAUSS_11, axis=1, mode='constant')[:, 5:-5]


def _ssim_one(img, img2):
    c1 = (0.01 * 255) ** 2
    c2 = (0.03 * 255) ** 2
    img, img2 = img.astype(np.float64), img2.astype(np.float64)
    mu1, mu2 = _window_mean(img), _window_mean(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    sigma1_sq = _window_mean(img ** 2) - mu1_sq
    sigma2_sq = _window_mean(img2 ** 2) - mu2_sq
    sigma12 = _window_mean(img * img2) - mu1_mu2
    ssim_map = (((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) /
                ((mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)))
    return ssim_map.mean()


@METRIC_REGISTRY.register()
def calculate_ssim(img, img2, crop_border, input_order='HWC',
                   test_y_channel=False, **kwargs):
    """SSIM of uint8 images, averaged over channels."""
    img, img2 = _prepare(img, img2, crop_border, input_order,
                         test_y_channel)
    return np.array([_ssim_one(img[..., i], img2[..., i])
                     for i in range(img.shape[2])]).mean()


@METRIC_REGISTRY.register()
def calculate_psnr_float(img_float, img2_float, crop_border,
                         input_order='CHW', test_y_channel=False, **kwargs):
    """PSNR of float arrays in [0, 1]. With ``test_y_channel`` it keeps the
    reference's quirk: to_y_channel expects [0, 255], so the Y-PSNR of
    [0, 1] floats comes out inflated (reference psnr_ssim.py:161-163)."""
    img, img2 = _prepare(img_float, img2_float, crop_border, input_order,
                         test_y_channel)
    mse = np.mean((img - img2) ** 2)
    if mse == 0:
        return float('inf')
    return -10 * np.log10(mse)
