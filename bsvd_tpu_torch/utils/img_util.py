"""Host-side image conversion and a PNG writer, numpy and zlib only
(counterpart of bsvd_tpu/utils/img_util.py tensor2img / imwrite, without
cv2): metric parity depends on tensor2img's clip, scale and round order."""

import os
import struct
import zlib

import numpy as np


def tensor2img(img):
    """Float (C, H, W) RGB (or (H, W) gray) in [0, 1] -> uint8 (H, W, C) BGR:
    clip, scale to [0, 255], round half to even."""
    t = np.clip(np.asarray(img, np.float32), 0, 1)
    if t.ndim == 3:
        t = np.transpose(t, (1, 2, 0))
        if t.shape[2] == 3:
            t = t[..., ::-1]
    elif t.ndim != 2:
        raise ValueError(f'unsupported ndim {t.ndim}')
    return (t * 255.0).round().astype(np.uint8)


def _png_chunk(tag, data):
    return (struct.pack('>I', len(data)) + tag + data
            + struct.pack('>I', zlib.crc32(tag + data) & 0xffffffff))


def encode_png(img):
    """uint8 (H, W) gray or (H, W, 3) BGR (cv2's order) -> PNG bytes: 8-bit,
    filter 0 on every row, zlib level 6."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f'PNG writer takes uint8, got {img.dtype}')
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.ndim == 2:
        color = 0
    elif img.ndim == 3 and img.shape[2] == 3:
        img, color = img[..., ::-1], 2
    else:
        raise ValueError(f'PNG writer takes (H, W) or (H, W, 3), got '
                         f'{img.shape}')
    h, w = img.shape[:2]
    rows = np.ascontiguousarray(img).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    return (b'\x89PNG\r\n\x1a\n'
            + _png_chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, 8, color,
                                              0, 0, 0))
            + _png_chunk(b'IDAT', zlib.compress(raw.tobytes(), 6))
            + _png_chunk(b'IEND', b''))


def imwrite(img, file_path):
    """Write a uint8 BGR (or gray) image as PNG, creating the parent folder
    (what cv2.imwrite does for the JAX package)."""
    if not file_path.lower().endswith('.png'):
        raise ValueError(f'imwrite writes PNG only, got {file_path}')
    os.makedirs(os.path.dirname(os.path.abspath(file_path)), exist_ok=True)
    with open(file_path, 'wb') as f:
        f.write(encode_png(img))
