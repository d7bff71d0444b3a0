"""PNG frames with no image library: the stdlib's zlib and a C++ unfilter
(counterpart of the PNG half of the JAX package's native decoder and of
``cv2.imread`` on ``.png`` files). Every ``.png`` frame takes this reader,
on every machine (``data/utils_common.route``).

Output is (H, W, 3) uint8 RGB, equal bit for bit to libpng with the
native decoder's transforms: 16-bit samples keep their high byte
(``png_set_strip_16``), palettes expand to RGB (an index past the palette
reads black, as libpng's zero-filled 256-entry palette gives), 1/2/4-bit
gray scales to 8 bits, and alpha (a channel or ``tRNS``) is dropped, which
leaves the colours as they are; gray becomes RGB.

A file is read whole: the signature, then the chunks, with the CRC of
every critical chunk (IHDR, PLTE, IDAT, IEND) checked; the IDAT data are
concatenated and inflated by ``zlib``, only as far as the last row needed;
those rows' filters are undone by ``_native/png_unfilter.cpp`` (built by
g++ at first use into ``bsvd_tpu_torch/_build/``, standard library only).
Adam7-interlaced files raise ``UnsupportedPNG`` (an IOError that is
also a NotImplementedError: valid, but not read yet); truncated files,
bad CRCs, unknown critical chunks and filter types above 4 raise
IOError.

Every function is thread-safe: zlib and the ctypes call release the GIL,
so the train loader's worker threads decode in parallel.
"""

import ctypes
import os
import struct
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from bsvd_tpu_torch.data import _gxx

SOURCE = Path(__file__).resolve().parent / '_native' / 'png_unfilter.cpp'
GXX_FLAGS = ['-O3', '-shared', '-fPIC']
SIGNATURE = b'\x89PNG\r\n\x1a\n'
# colour type -> samples per pixel, and the bit depths it may have
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}

_lock = threading.Lock()
_lib = None
_pool = None


def build():
    """Compile the unfilter if this source has no library yet; returns its
    path. Raises RuntimeError with g++'s output on failure."""
    return _gxx.build(SOURCE, 'bsvd_png', GXX_FLAGS, [])


def lib():
    """The loaded unfilter library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            so = ctypes.CDLL(str(build()))
            so.bsvd_png_unfilter.restype = ctypes.c_int
            so.bsvd_png_unfilter.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p]
            _lib = so
        return _lib


class _Png:
    """The parsed chunks of one file."""

    def __init__(self, path, width, height, depth, color, palette, idat):
        self.path, self.width, self.height = path, width, height
        self.depth, self.color = depth, color
        self.palette, self.idat = palette, idat
        self.channels = _CHANNELS[color]
        self.rowbytes = (width * self.channels * depth + 7) // 8
        self.bpp = max(1, self.channels * depth // 8)


class UnsupportedPNG(IOError, NotImplementedError):
    """A valid PNG of a kind the reader does not read yet (Adam7)."""


def _header(data, path):
    """(width, height, depth, color) from the signature and the IHDR chunk
    at the start of ``data``."""
    if data[:8] != SIGNATURE:
        raise IOError(f'{path}: not a PNG file (bad signature)')
    if len(data) < 33:
        raise IOError(f'{path}: truncated PNG (no complete IHDR chunk)')
    length, ctype = struct.unpack_from('>I4s', data, 8)
    if ctype != b'IHDR' or length != 13:
        raise IOError(f'{path}: the first chunk is not a 13-byte IHDR')
    if zlib.crc32(data[12:29]) != struct.unpack_from('>I', data, 29)[0]:
        raise IOError(f'{path}: bad CRC in chunk IHDR')
    width, height, depth, color, comp, filt, interlace = struct.unpack_from(
        '>IIBBBBB', data, 16)
    if width == 0 or height == 0 or color not in _DEPTHS or \
            depth not in _DEPTHS[color] or comp != 0 or filt != 0 or \
            interlace > 1:
        raise IOError(f'{path}: invalid IHDR ({width}x{height}, depth '
                      f'{depth}, colour type {color}, compression {comp}, '
                      f'filter {filt}, interlace {interlace})')
    if interlace == 1:
        raise UnsupportedPNG(f'{path}: Adam7-interlaced PNG is not read yet '
                             f'(ROADMAP Queue 1)')
    return width, height, depth, color


def _parse(data, path):
    """The chunks of a whole file -> _Png (the IDAT data concatenated)."""
    width, height, depth, color = _header(data, path)
    view = memoryview(data)
    pos, palette, idat, ended = 33, None, [], False
    while pos < len(data):
        if pos + 12 > len(data):
            break
        length, ctype = struct.unpack_from('>I4s', data, pos)
        end = pos + 8 + length
        if end + 4 > len(data):
            break
        critical = not ctype[0] & 0x20
        if critical and zlib.crc32(view[pos + 4:end]) != \
                struct.unpack_from('>I', data, end)[0]:
            raise IOError(f'{path}: bad CRC in chunk '
                          f'{ctype.decode("latin-1")}')
        if ctype == b'IDAT':
            idat.append(view[pos + 8:end])
        elif ctype == b'PLTE':
            if length % 3 or not 0 < length <= 768:
                raise IOError(f'{path}: invalid PLTE of {length} bytes')
            palette = np.zeros((256, 3), np.uint8)
            palette[:length // 3] = np.frombuffer(
                data, np.uint8, length, pos + 8).reshape(-1, 3)
        elif ctype == b'IEND':
            ended = True
            break
        elif ctype == b'IHDR' or critical:
            raise IOError(f'{path}: unexpected critical chunk '
                          f'{ctype.decode("latin-1")}')
        pos = end + 4
    if not ended:
        raise IOError(f'{path}: truncated PNG (no IEND chunk)')
    if not idat:
        raise IOError(f'{path}: no IDAT chunk')
    if color == 3 and palette is None:
        raise IOError(f'{path}: palette image without PLTE')
    return _Png(path, width, height, depth, color, palette, b''.join(idat))


def _read(path):
    with open(path, 'rb') as f:
        return f.read()


def _rows(png, rows):
    """The first ``rows`` rows inflated and unfiltered -> (rows, rowbytes)
    uint8."""
    need = rows * (png.rowbytes + 1)
    try:
        raw = zlib.decompressobj().decompress(png.idat, need)
    except zlib.error as e:
        raise IOError(f'{png.path}: corrupt image data ({e})') from None
    if len(raw) < need:
        raise IOError(f'{png.path}: truncated image data ({len(raw)} of '
                      f'{need} bytes)')
    out = np.empty((rows, png.rowbytes), np.uint8)
    bad = lib().bsvd_png_unfilter(raw, rows, png.rowbytes, png.bpp,
                                  out.ctypes.data)
    if bad:
        raise IOError(f'{png.path}: row {bad - 1} has filter type '
                      f'{raw[(bad - 1) * (png.rowbytes + 1)]} (0-4 only)')
    return out


def _to_rgb(png, rows, x0, x1):
    """Unfiltered rows -> (rows, x1 - x0, 3) uint8 RGB, as libpng's
    transforms give them."""
    n, w, c, depth = rows.shape[0], png.width, png.channels, png.depth
    if depth == 16:
        px = rows[:, :2 * w * c].reshape(n, w, c, 2)[:, x0:x1, :, 0]
    elif depth == 8:
        px = rows[:, :w * c].reshape(n, w, c)[:, x0:x1]
    else:                       # 1/2/4-bit gray or palette indices
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        samples = (rows[:, :, None] >> shifts) & np.uint8((1 << depth) - 1)
        px = samples.reshape(n, -1)[:, x0:x1, None]
        if png.color == 0:
            px = px * np.uint8(255 // ((1 << depth) - 1))
    if png.color == 3:
        return png.palette[px[..., 0]]
    if png.color in (0, 4):
        return np.repeat(px[..., :1], 3, axis=-1)
    return np.ascontiguousarray(px[..., :3])


def image_dims(path):
    """(H, W) of a PNG file, from its header."""
    with open(path, 'rb') as f:
        width, height, _, _ = _header(f.read(33), path)
    return height, width


def load_crop(path, y0, x0, ch, cw):
    """The (ch, cw) window at (y0, x0) of a PNG file -> (ch, cw, 3) uint8
    RGB. Only the rows above y0 + ch are inflated and unfiltered."""
    png = _parse(_read(path), path)
    if y0 < 0 or x0 < 0 or y0 + ch > png.height or x0 + cw > png.width:
        raise IOError(f'{path}: window ({y0}, {x0}, {ch}, {cw}) outside the '
                      f'{png.height}x{png.width} frame')
    rows = _rows(png, y0 + ch)[y0:]
    return _to_rgb(png, rows, x0, x0 + cw)


def load(path):
    """A whole PNG file -> (H, W, 3) uint8 RGB."""
    png = _parse(_read(path), path)
    return _to_rgb(png, _rows(png, png.height), 0, png.width)


def load_crop_seq(paths, y0, x0, ch, cw):
    """The same window of each frame -> (T, ch, cw, 3) uint8 RGB, decoded
    in the calling thread."""
    out = np.empty((len(paths), ch, cw, 3), np.uint8)
    for i, p in enumerate(paths):
        out[i] = load_crop(p, y0, x0, ch, cw)
    return out


def _get_pool():
    global _pool
    with _lock:
        if _pool is None:
            _pool = ThreadPoolExecutor(min(8, os.cpu_count() or 4),
                                       thread_name_prefix='png_decode')
        return _pool


def load_seq(paths):
    """Whole frames of one size, decoded in parallel -> (T, H, W, 3) uint8
    RGB; raises IOError where a frame cannot be read or differs in
    size."""
    frames = list(_get_pool().map(load, paths))
    for p, f in zip(paths, frames):
        if f.shape != frames[0].shape:
            raise IOError(f'{p}: {f.shape[:2]} differs from the first '
                          f'frame\'s {frames[0].shape[:2]}')
    return np.stack(frames)
