"""MATLAB's bicubic imresize (antialiased) and the YCbCr conversions
(counterpart of bsvd_tpu/utils/matlab_functions.py). The resize is two
gathers and weighted sums on the tensor's device, in float64 as JAX's
numpy; the weights and indices depend on sizes only and are made on the
host. The colour conversions take numpy arrays, as JAX's do."""

import numpy as np
import torch


def cubic(x):
    """MATLAB's bicubic kernel (a = -0.5); numpy or torch."""
    absx = abs(x)
    absx2 = absx ** 2
    absx3 = absx ** 3
    return ((1.5 * absx3 - 2.5 * absx2 + 1) * (absx <= 1) +
            (-0.5 * absx3 + 2.5 * absx2 - 4 * absx + 2) *
            ((absx > 1) & (absx <= 2)))


def _weights_indices(in_length, out_length, scale, kernel_width,
                     antialiasing):
    if scale < 1 and antialiasing:
        kernel_width = kernel_width / scale
    x = np.arange(1, out_length + 1, dtype=np.float64)
    u = x / scale + 0.5 * (1 - 1 / scale)
    left = np.floor(u - kernel_width / 2)
    p = int(np.ceil(kernel_width)) + 2
    indices = left[:, None] + np.arange(p)[None, :] - 1
    dist = u[:, None] - indices - 1
    if scale < 1 and antialiasing:
        weights = scale * cubic(dist * scale)
    else:
        weights = cubic(dist)
    weights = weights / np.sum(weights, axis=1, keepdims=True)
    # trim the zero-weight columns
    nz = np.nonzero(np.any(weights != 0, axis=0))[0]
    if len(nz):
        weights = weights[:, nz[0]:nz[-1] + 1]
        indices = indices[:, nz[0]:nz[-1] + 1]
    # mirror out-of-range indices (MATLAB's symmetric padding)
    aux = np.concatenate([np.arange(in_length), np.arange(in_length)[::-1]])
    indices = aux[np.mod(indices.astype(np.int64), aux.size)]
    return weights, indices


def imresize(img, scale, antialiasing=True):
    """MATLAB imresize with the bicubic kernel.

    Args:
        img: (H, W, C) or (H, W) array or tensor (any range, or uint8).
    Returns:
        float64 resized image of the input's kind (a tensor stays on its
        device).
    """
    is_tensor = torch.is_tensor(img)
    x = img if is_tensor else torch.from_numpy(np.asarray(img))
    squeeze = x.ndim == 2
    if squeeze:
        x = x[:, :, None]
    in_h, in_w, _ = x.shape
    out_h = int(np.ceil(in_h * scale))
    out_w = int(np.ceil(in_w * scale))
    wh, ih = _weights_indices(in_h, out_h, scale, 4, antialiasing)
    ww, iw = _weights_indices(in_w, out_w, scale, 4, antialiasing)
    dev = x.device
    xf = x.double()
    tmp = torch.einsum('ok,okwc->owc', torch.from_numpy(wh).to(dev),
                       xf[torch.from_numpy(ih).to(dev)])
    out = torch.einsum('ok,hokc->hoc', torch.from_numpy(ww).to(dev),
                       tmp[:, torch.from_numpy(iw).to(dev)])
    if squeeze:
        out = out[:, :, 0]
    return out if is_tensor else out.numpy()


def _convert_input_type_range(img):
    img_type = img.dtype
    img = img.astype(np.float32)
    if img_type == np.uint8:
        img /= 255.
    elif img_type not in (np.float32, np.float64):
        raise TypeError(f'The img type should be np.float32 or np.uint8, '
                        f'but got {img_type}')
    return img


def _convert_output_type_range(img, dst_type):
    if dst_type not in (np.uint8, np.float32):
        raise TypeError(f'The dst_type should be np.float32 or np.uint8, '
                        f'but got {dst_type}')
    if dst_type == np.uint8:
        img = img.round()
    else:
        img /= 255.
    return img.astype(dst_type)


def rgb2ycbcr(img, y_only=False):
    """ITU-R BT.601 (MATLAB's rgb2ycbcr); uint8 [0, 255] or float [0, 1]."""
    img_type = img.dtype
    img = _convert_input_type_range(img)
    if y_only:
        out_img = np.dot(img, [65.481, 128.553, 24.966]) + 16.0
    else:
        out_img = np.matmul(img, [[65.481, -37.797, 112.0],
                                  [128.553, -74.203, -93.786],
                                  [24.966, 112.0, -18.214]]) + [16, 128, 128]
    return _convert_output_type_range(out_img, img_type)


def bgr2ycbcr(img, y_only=False):
    img_type = img.dtype
    img = _convert_input_type_range(img)
    if y_only:
        out_img = np.dot(img, [24.966, 128.553, 65.481]) + 16.0
    else:
        out_img = np.matmul(img, [[24.966, 112.0, -18.214],
                                  [128.553, -74.203, -93.786],
                                  [65.481, -37.797, 112.0]]) + [16, 128, 128]
    return _convert_output_type_range(out_img, img_type)


def ycbcr2rgb(img):
    img_type = img.dtype
    img = _convert_input_type_range(img) * 255
    out_img = np.matmul(img, [[0.00456621, 0.00456621, 0.00456621],
                              [0, -0.00153632, 0.00791071],
                              [0.00625893, -0.00318811, 0]]) * 255.0 + \
        [-222.921, 135.576, -276.836]
    return _convert_output_type_range(out_img, img_type)


def ycbcr2bgr(img):
    img_type = img.dtype
    img = _convert_input_type_range(img) * 255
    out_img = np.matmul(img, [[0.00456621, 0.00456621, 0.00456621],
                              [0.00791071, -0.00153632, 0],
                              [0, -0.00318811, 0.00625893]]) * 255.0 + \
        [-276.836, 135.576, -222.921]
    return _convert_output_type_range(out_img, img_type)
