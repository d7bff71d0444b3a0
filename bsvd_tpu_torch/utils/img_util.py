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


def filter_rows(rows, bpp, filters):
    """PNG-filter (h, rowbytes) uint8 rows: row r with type filters[r]
    (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth; the PNG specification,
    section 9) -> (h, 1 + rowbytes) uint8, each row led by its type."""
    x = rows.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[:, bpp:] = b[:, :-bpp]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    pred = np.stack([np.zeros_like(x), a, b, (a + b) >> 1, paeth])
    filters = np.asarray(filters, np.int64)
    out = (x - pred[filters, np.arange(len(x))]) % 256
    return np.concatenate([filters[:, None], out], axis=1).astype(np.uint8)


def encode_png(img, filters=None):
    """uint8 (H, W) gray or (H, W, 3) BGR (cv2's order) -> PNG bytes: 8-bit,
    zlib level 6; row r filtered with type ``filters[r]`` (0-4), filter 0
    on every row by default."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f'PNG writer takes uint8, got {img.dtype}')
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.ndim == 2:
        color, bpp = 0, 1
    elif img.ndim == 3 and img.shape[2] == 3:
        img, color, bpp = img[..., ::-1], 2, 3
    else:
        raise ValueError(f'PNG writer takes (H, W) or (H, W, 3), got '
                         f'{img.shape}')
    h, w = img.shape[:2]
    rows = np.ascontiguousarray(img).reshape(h, -1)
    if filters is None:
        raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    else:
        raw = filter_rows(rows, bpp, filters)
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
