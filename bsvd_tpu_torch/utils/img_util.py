"""Host-side image conversion, the PNG / JPEG writers and ``imfrombytes``,
with no image library (counterpart of bsvd_tpu/utils/img_util.py
tensor2img / img2tensor / imwrite / imfrombytes / crop_border, without
cv2): metric parity depends on tensor2img's clip, scale and round order.

``imwrite`` takes cv2's ``params``, a flat list of (flag, value) integers;
the port defines the flags it reads with cv2's numbers."""

import os
import struct
import zlib

import numpy as np

from bsvd_tpu_torch.utils.jpeg_encode import encode_jpeg

# cv2's imwrite flags and sampling values, by their numbers in OpenCV
IMWRITE_JPEG_QUALITY = 1
IMWRITE_JPEG_SAMPLING_FACTOR = 7
IMWRITE_PNG_COMPRESSION = 16
IMWRITE_JPEG_SAMPLING_FACTOR_420 = 0x221111
IMWRITE_JPEG_SAMPLING_FACTOR_422 = 0x211111
IMWRITE_JPEG_SAMPLING_FACTOR_440 = 0x121111
IMWRITE_JPEG_SAMPLING_FACTOR_444 = 0x111111
_SAMPLING = {IMWRITE_JPEG_SAMPLING_FACTOR_420: '4:2:0',
             IMWRITE_JPEG_SAMPLING_FACTOR_422: '4:2:2',
             IMWRITE_JPEG_SAMPLING_FACTOR_440: '4:4:0',
             IMWRITE_JPEG_SAMPLING_FACTOR_444: '4:4:4'}
_FLAGS = {'.png': (IMWRITE_PNG_COMPRESSION,),
          '.jpg': (IMWRITE_JPEG_QUALITY, IMWRITE_JPEG_SAMPLING_FACTOR)}
_FLAGS['.jpeg'] = _FLAGS['.jpg']


def tensor2img(img, rgb2bgr=True, min_max=(0, 1)):
    """Float (C, H, W) RGB (or (H, W) gray) -> uint8 (H, W, C): clip to
    ``min_max``, scale to [0, 255], round half to even, RGB to BGR with
    ``rgb2bgr``. A list (or tuple) gives a list, or its one image."""
    def one(t):
        t = np.clip(np.asarray(t, np.float32), min_max[0], min_max[1])
        t = (t - min_max[0]) / (min_max[1] - min_max[0])
        if t.ndim == 3:
            t = np.transpose(t, (1, 2, 0))
            if rgb2bgr and t.shape[2] == 3:
                t = t[..., ::-1]
        elif t.ndim != 2:
            raise ValueError(f'unsupported ndim {t.ndim}')
        return (t * 255.0).round().astype(np.uint8)

    if isinstance(img, (list, tuple)):
        out = [one(t) for t in img]
        return out if len(out) > 1 else out[0]
    return one(img)


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


def encode_png(img, filters=None, level=6):
    """uint8 (H, W) gray or (H, W, 3) BGR (cv2's order) -> PNG bytes: 8-bit,
    zlib ``level``; row r filtered with type ``filters[r]`` (0-4), filter 0
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
            + _png_chunk(b'IDAT', zlib.compress(raw.tobytes(), level))
            + _png_chunk(b'IEND', b''))


def _params(params, ext):
    """cv2's flat (flag, value) list -> {flag: value}, each flag one the
    writer of ``ext`` reads."""
    params = list(params or [])
    if len(params) % 2:
        raise ValueError(f'imwrite params {params}: (flag, value) pairs')
    out = {}
    for flag, value in zip(params[::2], params[1::2]):
        if flag not in _FLAGS[ext]:
            raise ValueError(f'imwrite flag {flag} is not read for {ext} '
                             f'files (flags {list(_FLAGS[ext])})')
        out[flag] = int(value)
    return out


def imwrite(img, file_path, params=None, auto_mkdir=True):
    """Write a uint8 BGR (or gray) image as PNG or JPEG by the file's
    extension (what cv2.imwrite does for the JAX package), creating the
    parent folder with ``auto_mkdir``. ``params``: cv2's (flag, value)
    list; PNG reads IMWRITE_PNG_COMPRESSION (zlib level 0-9, default 6),
    JPEG reads IMWRITE_JPEG_QUALITY (default 95) and
    IMWRITE_JPEG_SAMPLING_FACTOR (the 4:2:0 / 4:2:2 / 4:4:0 / 4:4:4
    values; default 4:2:0). Any other flag or extension raises
    ValueError."""
    ext = os.path.splitext(file_path)[1].lower()
    if ext not in _FLAGS:
        raise ValueError(f'imwrite writes PNG and JPEG only, got '
                         f'{file_path}')
    flags = _params(params, ext)
    if ext == '.png':
        level = flags.get(IMWRITE_PNG_COMPRESSION, 6)
        if not 0 <= level <= 9:
            raise ValueError(f'IMWRITE_PNG_COMPRESSION {level}: 0-9')
        data = encode_png(img, level=level)
    else:
        sampling = flags.get(IMWRITE_JPEG_SAMPLING_FACTOR,
                             IMWRITE_JPEG_SAMPLING_FACTOR_420)
        if sampling not in _SAMPLING:
            raise ValueError(f'IMWRITE_JPEG_SAMPLING_FACTOR {sampling:#x}: '
                             f'{", ".join(f"{k:#x}" for k in _SAMPLING)} '
                             f'only (4:1:1 is not written)')
        img = np.asarray(img)
        if img.dtype != np.uint8:
            raise ValueError(f'JPEG writer takes uint8, got {img.dtype}')
        rgb = img[..., ::-1] if img.ndim == 3 and img.shape[2] == 3 else img
        data = encode_jpeg(rgb, flags.get(IMWRITE_JPEG_QUALITY, 95),
                           _SAMPLING[sampling])
    if auto_mkdir:
        os.makedirs(os.path.dirname(os.path.abspath(file_path)),
                    exist_ok=True)
    with open(file_path, 'wb') as f:
        f.write(data)
    return True


def img2tensor(img, bgr2rgb=True, float32=True):
    """(H, W, C) BGR (or (H, W) gray) -> contiguous (C, H, W) numpy, RGB
    with ``bgr2rgb``, float32 / 255 with ``float32``."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    if bgr2rgb and img.shape[2] == 3:
        img = img[..., ::-1]
    img = np.transpose(img, (2, 0, 1))
    if float32:
        img = img.astype(np.float32) / 255.0
    return np.ascontiguousarray(img)


def crop_border(imgs, crop_border):
    """Crop ``crop_border`` pixels off each side of (H, W, ...) image(s)."""
    if crop_border == 0:
        return imgs
    if isinstance(imgs, list):
        return [v[crop_border:-crop_border, crop_border:-crop_border, ...]
                for v in imgs]
    return imgs[crop_border:-crop_border, crop_border:-crop_border, ...]


# file signatures -> the reader of that format (data/<module>.decode)
_SIGNATURES = ((b'\x89PNG', 'png_decode'), (b'\xff\xd8', 'jpeg_decode'),
               (b'BM', 'bmp_decode'))
_MODES = {'color': 'color', 'grayscale': 'gray', 'unchanged': 'unchanged'}


def _reader(content, caller):
    """The reader module of the format that ``content`` starts with."""
    import importlib        # the readers' package imports this module
    for sig, mod in _SIGNATURES:
        if content.startswith(sig):
            return importlib.import_module(f'bsvd_tpu_torch.data.{mod}')
    raise ValueError(f'{caller}: unknown image signature {content[:8]!r} '
                     f'(PNG, JPEG and BMP are read)')


def imsize(content):
    """(H, W) of a PNG, JPEG or BMP file's bytes, from its header, without
    decoding it (the reader picked by the signature, as ``imfrombytes``
    picks it)."""
    content = bytes(content)
    return _reader(content, 'imsize').buffer_dims(content)


def imfrombytes(content, flag='color', float32=False):
    """Decode a file's bytes as ``cv2.imdecode`` does for the JAX package,
    with the port's own readers, picked by the signature (PNG, JPEG, BMP;
    other bytes raise ValueError naming their first bytes). ``flag``
    'color': (H, W, 3) uint8 BGR (a 16-bit PNG reduced to 8 bits);
    'grayscale': (H, W) uint8; 'unchanged': the file's own channels and
    depth (gray (H, W), BGR, BGRA; 16-bit PNG uint16). ``float32`` divides
    by 255, whatever the depth (a 16-bit image then runs past 1, as in
    the JAX package)."""
    if flag not in _MODES:
        raise ValueError(f'imfrombytes: flag {flag!r} (color, grayscale, '
                         f'unchanged)')
    content = bytes(content)
    img = _reader(content, 'imfrombytes').decode(content, _MODES[flag])
    if flag == 'color':
        img = np.ascontiguousarray(img[..., ::-1])
    if float32:
        img = img.astype(np.float32) / 255.0
    return img
