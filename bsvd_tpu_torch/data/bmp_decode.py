"""BMP frames with no image library (what ``cv2.imread`` does for ``.bmp``
files in the JAX package): uncompressed (``BI_RGB``) 24- and 32-bit and
8-bit paletted files, bottom-up or top-down, with a BITMAPINFOHEADER or
its V4 / V5 extensions; 32-bit ``BI_BITFIELDS`` files whose masks are the
plain B, G, R byte order (cv2 writes 32-bit BMPs so) read as ``BI_RGB``. Output is (H, W, 3) uint8 RGB as cv2 gives it
(32-bit pixels drop their fourth byte; palette indices past the palette
read black). ``load_gray`` gives (H, W) uint8 as cv2's IMREAD_GRAYSCALE
does: pixels and 8-bit palette entries through cv2's BGR -> gray in
14-bit fixed point (R 4899, G 9617, B 1868, rounded), except 32-bit files
with an alpha mask (cv2's own), whose pixels cv2 5 converts as ``0.299f
R + 0.587f G + 0.114f B`` in float32, truncated (both rules found by
holding the reader against cv2).

Other kinds (RLE or bitfield compression, 1 / 4 / 16-bit pixels, OS/2
headers) raise ``UnsupportedBMP`` (an IOError that is also a
NotImplementedError); truncated or malformed files raise IOError.
"""

import struct

import numpy as np

_INFO_SIZES = (40, 108, 124)
# cv2's icvCvt_BGR2Gray_8u_C3C1R: 0.114, 0.587, 0.299 in 14-bit fixed point
_GRAY_SHIFT = 14
_GRAY_R = int(0.299 * (1 << _GRAY_SHIFT) + 0.5)
_GRAY_G = int(0.587 * (1 << _GRAY_SHIFT) + 0.5)
_GRAY_B = (1 << _GRAY_SHIFT) - _GRAY_R - _GRAY_G


class UnsupportedBMP(IOError, NotImplementedError):
    """A valid BMP of a kind the reader does not read."""


class _Bmp:
    """The header fields of one file."""

    def __init__(self, data, path, header_only=False):
        if len(data) < 18 or data[:2] != b'BM':
            raise IOError(f'{path}: not a BMP file (bad signature)')
        self.offset, info = struct.unpack_from('<II', data, 10)
        if info not in _INFO_SIZES:
            raise UnsupportedBMP(f'{path}: BMP with a {info}-byte header '
                                 f'(BITMAPINFOHEADER and V4 / V5 only)')
        if len(data) < 14 + info:
            raise IOError(f'{path}: truncated BMP header')
        (width, height, _, self.bpp, comp, _, _, _,
         used) = struct.unpack_from('<iiHHIIiiI', data, 18)
        self.top_down = height < 0
        self.width, self.height = width, abs(height)
        if width <= 0 or height == 0:
            raise IOError(f'{path}: invalid BMP size {width}x{height}')
        # a 32-bit BI_BITFIELDS file with an alpha mask (as cv2 writes
        # them): cv2 reads it as BGRA, which its gray conversion treats
        # apart
        self.alpha = False
        if comp == 3 and self.bpp == 32 and len(data) >= 66 and \
                struct.unpack_from('<III', data, 54) == (0xFF0000, 0xFF00,
                                                         0xFF):
            comp = 0
            self.alpha = info >= 56 and len(data) >= 70 and \
                struct.unpack_from('<I', data, 66)[0] != 0
        if comp != 0:
            raise UnsupportedBMP(f'{path}: compressed BMP (compression '
                                 f'{comp}; BI_RGB only)')
        if self.bpp not in (8, 24, 32):
            raise UnsupportedBMP(f'{path}: {self.bpp}-bit BMP (8, 24 and '
                                 f'32 only)')
        self.stride = (self.width * self.bpp + 31) // 32 * 4
        if header_only:
            return
        if self.bpp == 8:
            n = used or 256
            start = 14 + info
            if n > 256 or start + 4 * n > len(data):
                raise IOError(f'{path}: invalid BMP palette ({n} entries)')
            self.palette = np.zeros((256, 3), np.uint8)
            self.palette[:n] = np.frombuffer(
                data, np.uint8, 4 * n, start).reshape(n, 4)[:, 2::-1]
        if self.offset + self.stride * self.height > len(data):
            raise IOError(f'{path}: truncated BMP pixel data')


def _read(path):
    with open(path, 'rb') as f:
        return f.read()


def _header(path):
    with open(path, 'rb') as f:
        return _Bmp(f.read(14 + max(_INFO_SIZES)), path, header_only=True)


def image_dims(path):
    """(H, W) of a BMP file, from its header."""
    bmp = _header(path)
    return bmp.height, bmp.width


def load_crop(path, y0, x0, ch, cw):
    """The (ch, cw) window at (y0, x0) of a BMP file -> (ch, cw, 3) uint8
    RGB."""
    data = _read(path)
    bmp = _Bmp(data, path)
    if y0 < 0 or x0 < 0 or y0 + ch > bmp.height or x0 + cw > bmp.width:
        raise IOError(f'{path}: window ({y0}, {x0}, {ch}, {cw}) outside the '
                      f'{bmp.height}x{bmp.width} frame')
    rows = np.frombuffer(data, np.uint8, bmp.stride * bmp.height,
                         bmp.offset).reshape(bmp.height, bmp.stride)
    if not bmp.top_down:
        rows = rows[::-1]
    rows = rows[y0:y0 + ch]
    if bmp.bpp == 8:
        return bmp.palette[rows[:, x0:x0 + cw]]
    px = bmp.bpp // 8
    bgr = rows[:, :bmp.width * px].reshape(ch, bmp.width, px)
    return np.ascontiguousarray(bgr[:, x0:x0 + cw, 2::-1])


def load(path):
    """A whole BMP file -> (H, W, 3) uint8 RGB."""
    h, w = image_dims(path)
    return load_crop(path, 0, 0, h, w)


def load_gray(path):
    """A whole BMP file -> (H, W) uint8 gray, as cv2 converts it."""
    rgb = load(path)
    if _header(path).alpha:
        r, g, b = np.moveaxis(rgb.astype(np.float32), -1, 0)
        y = (np.float32(0.299) * r + np.float32(0.587) * g
             + np.float32(0.114) * b)
        return np.floor(y).astype(np.uint8)
    r, g, b = np.moveaxis(rgb.astype(np.int32), -1, 0)
    y = (r * _GRAY_R + g * _GRAY_G + b * _GRAY_B
         + (1 << (_GRAY_SHIFT - 1))) >> _GRAY_SHIFT
    return y.astype(np.uint8)


def load_crop_seq(paths, y0, x0, ch, cw):
    """The same window of each frame -> (T, ch, cw, 3) uint8 RGB."""
    out = np.empty((len(paths), ch, cw, 3), np.uint8)
    for i, p in enumerate(paths):
        out[i] = load_crop(p, y0, x0, ch, cw)
    return out


def load_seq(paths, gray=False):
    """Whole frames of one size -> (T, H, W, 3) uint8 RGB, or (T, H, W)
    gray with ``gray``; raises IOError where a frame differs in size."""
    frames = [(load_gray if gray else load)(p) for p in paths]
    for p, f in zip(paths, frames):
        if f.shape != frames[0].shape:
            raise IOError(f'{p}: {f.shape[:2]} differs from the first '
                          f'frame\'s {frames[0].shape[:2]}')
    return np.stack(frames)
