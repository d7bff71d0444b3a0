"""PNG frames with no image library: the stdlib's zlib and a C++ unfilter
(counterpart of the PNG half of the JAX package's native decoder and of
``cv2.imread`` on ``.png`` files). Every ``.png`` frame takes this reader,
on every machine (``data/utils_common.route``).

Output is (H, W, 3) uint8 RGB, equal bit for bit to libpng with the
native decoder's transforms: 16-bit samples keep their high byte
(``png_set_strip_16``), palettes expand to RGB (an index past the palette
reads black, as libpng's zero-filled 256-entry palette gives), 1/2/4-bit
gray scales to 8 bits, and alpha (a channel or ``tRNS``) is dropped, which
leaves the colours as they are; gray becomes RGB. ``load_gray`` gives (H,
W) uint8 as ``cv2.imread(path, cv2.IMREAD_GRAYSCALE)`` does: colour and
palette pixels through libpng's ``png_set_rgb_to_gray`` with cv2's
weights (0.299, 0.587 as 15-bit fixed point: 9797, 19234, 3737; 8-bit
sums truncated, 16-bit ones rounded and then reduced to their high byte;
a pixel with R = G = B keeps its value). A colour file with a ``gAMA``
other than 1.0, an ``sRGB`` or an ``iCCP`` chunk makes libpng convert in
linear light: that raises ``UnsupportedPNG`` in gray mode.

A file is read whole: the signature, then the chunks, with the CRC of
every critical chunk (IHDR, PLTE, IDAT, IEND) checked; the IDAT data are
concatenated and inflated by ``zlib``, only as far as the last row needed;
those rows' filters are undone by ``_native/png_unfilter.cpp`` (built by
g++ at first use into ``bsvd_tpu_torch/_build/``, standard library only).
An Adam7-interlaced file is inflated whole; each of its seven passes is
unfiltered on its own sub-image width and scattered into the frame's
rows, which then take the same transforms. Truncated files, bad CRCs,
unknown critical chunks and filter types above 4 raise IOError.

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
# Adam7 passes: (x0, y0, dx, dy)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
# libpng's png_set_rgb_to_gray(png, 1, 0.299, 0.587), as cv2 calls it:
# the coefficients in 15-bit fixed point, blue the rest of 32768
GRAY_RC, GRAY_GC = 29900 * 32768 // 100000, 58700 * 32768 // 100000
GRAY_BC = 32768 - GRAY_RC - GRAY_GC

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

    def __init__(self, path, header, palette, idat, colour_space, trns=None):
        width, height, depth, color, interlace = header
        self.path, self.width, self.height = path, width, height
        self.depth, self.color, self.interlace = depth, color, interlace
        self.palette, self.idat = palette, idat
        # the tRNS chunk's bytes (None without one)
        self.trns = trns
        # the chunk that makes libpng's RGB -> gray conversion non-linear
        self.colour_space = colour_space
        self.channels = _CHANNELS[color]
        self.rowbytes = self.pass_rowbytes(width)
        self.bpp = max(1, self.channels * depth // 8)

    def pass_rowbytes(self, width):
        return (width * self.channels * self.depth + 7) // 8


class UnsupportedPNG(IOError, NotImplementedError):
    """A valid PNG of a kind the reader does not read (gray mode of a
    colour file that names a non-linear colour space)."""


def _header(data, path):
    """(width, height, depth, color, interlace) from the signature and the
    IHDR chunk at the start of ``data``."""
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
    return width, height, depth, color, interlace


def _parse(data, path):
    """The chunks of a whole file -> _Png (the IDAT data concatenated)."""
    header = _header(data, path)
    color = header[3]
    view = memoryview(data)
    pos, palette, idat, ended, space, trns = 33, None, [], False, None, None
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
        elif ctype == b'tRNS':
            trns = bytes(data[pos + 8:end])
        elif ctype in (b'sRGB', b'iCCP') or (
                ctype == b'gAMA' and data[pos + 8:end] !=
                struct.pack('>I', 100000)):
            space = ctype.decode('latin-1')
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
    return _Png(path, header, palette, b''.join(idat), space, trns)


def _read(path):
    with open(path, 'rb') as f:
        return f.read()


def _inflate(png, need):
    """The first ``need`` bytes of the inflated image data."""
    try:
        raw = zlib.decompressobj().decompress(png.idat, need)
    except zlib.error as e:
        raise IOError(f'{png.path}: corrupt image data ({e})') from None
    if len(raw) < need:
        raise IOError(f'{png.path}: truncated image data ({len(raw)} of '
                      f'{need} bytes)')
    return raw


def _unfilter(png, raw, rows, rowbytes):
    """``rows`` filtered rows of ``rowbytes`` (each after its filter byte)
    -> (rows, rowbytes) uint8."""
    out = np.empty((rows, rowbytes), np.uint8)
    bad = lib().bsvd_png_unfilter(raw, rows, rowbytes, png.bpp,
                                  out.ctypes.data)
    if bad:
        raise IOError(f'{png.path}: row {bad - 1} has filter type '
                      f'{raw[(bad - 1) * (rowbytes + 1)]} (0-4 only)')
    return out


def _passes(png):
    """The Adam7 passes that hold pixels: (x0, y0, dx, dy, width,
    height)."""
    out = []
    for x0, y0, dx, dy in ADAM7:
        pw, ph = -(-(png.width - x0) // dx), -(-(png.height - y0) // dy)
        if pw > 0 and ph > 0:
            out.append((x0, y0, dx, dy, pw, ph))
    return out


def _unpack(rows, depth, width):
    """1/2/4-bit samples of packed rows -> (n, width) uint8."""
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    samples = (rows[:, :, None] >> shifts) & np.uint8((1 << depth) - 1)
    return samples.reshape(len(rows), -1)[:, :width]


def _pack(samples, depth):
    """(n, width) 1/2/4-bit samples -> packed rows (n, rowbytes)."""
    per = 8 // depth
    n, w = samples.shape
    padded = np.zeros((n, -(-w // per) * per), np.uint8)
    padded[:, :w] = samples
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    return np.bitwise_or.reduce(padded.reshape(n, -1, per) << shifts,
                                axis=-1).astype(np.uint8)


def _interlaced_rows(png):
    """The unfiltered rows of an Adam7 file as the non-interlaced file's
    rows would be: each pass unfiltered on its own width, its pixels put
    at their places."""
    passes = _passes(png)
    sizes = [ph * (png.pass_rowbytes(pw) + 1) for *_, pw, ph in passes]
    raw = _inflate(png, sum(sizes))
    sub = png.depth < 8
    full = (np.zeros((png.height, png.width), np.uint8) if sub else
            np.zeros((png.height, png.width, png.bpp), np.uint8))
    pos = 0
    for (x0, y0, dx, dy, pw, ph), size in zip(passes, sizes):
        rb = png.pass_rowbytes(pw)
        rows = _unfilter(png, raw[pos:pos + size], ph, rb)
        pos += size
        full[y0::dy, x0::dx] = (_unpack(rows, png.depth, pw) if sub else
                                rows.reshape(ph, pw, png.bpp))
    if sub:
        return _pack(full, png.depth)
    return full.reshape(png.height, png.rowbytes)


def _rows(png, rows):
    """The first ``rows`` rows inflated and unfiltered -> (rows, rowbytes)
    uint8 (an interlaced file's whole frame)."""
    if png.interlace:
        return _interlaced_rows(png)[:rows]
    raw = _inflate(png, rows * (png.rowbytes + 1))
    return _unfilter(png, raw, rows, png.rowbytes)


def _to_rgb(png, rows, x0, x1):
    """Unfiltered rows -> (rows, x1 - x0, 3) uint8 RGB, as libpng's
    transforms give them."""
    n, w, c, depth = rows.shape[0], png.width, png.channels, png.depth
    if depth == 16:
        px = rows[:, :2 * w * c].reshape(n, w, c, 2)[:, x0:x1, :, 0]
    elif depth == 8:
        px = rows[:, :w * c].reshape(n, w, c)[:, x0:x1]
    else:                       # 1/2/4-bit gray or palette indices
        px = _unpack(rows, depth, w)[:, x0:x1, None]
        if png.color == 0:
            px = px * np.uint8(255 // ((1 << depth) - 1))
    if png.color == 3:
        return png.palette[px[..., 0]]
    if png.color in (0, 4):
        return np.repeat(px[..., :1], 3, axis=-1)
    return np.ascontiguousarray(px[..., :3])


def _rgb_to_gray(r, g, b, depth):
    """libpng's png_do_rgb_to_gray without gamma, on int32 samples."""
    if depth == 16:
        y = (GRAY_RC * r + GRAY_GC * g + GRAY_BC * b + 16384) >> 15
    else:
        y = (GRAY_RC * r + GRAY_GC * g + GRAY_BC * b) >> 15
    return np.where((r == g) & (g == b), r, y)


def _to_gray(png, rows, x0, x1):
    """Unfiltered rows -> (rows, x1 - x0) uint8, as cv2's IMREAD_GRAYSCALE
    gives them."""
    if png.color in (2, 3, 6):
        if png.colour_space:
            raise UnsupportedPNG(
                f'{png.path}: gray mode of a colour PNG with an '
                f'{png.colour_space} chunk (libpng converts in linear '
                f'light; not read)')
        if png.color == 3 or png.depth == 8:
            rgb = _to_rgb(png, rows, x0, x1).astype(np.int32)
            return _rgb_to_gray(*np.moveaxis(rgb, -1, 0), 8).astype(np.uint8)
        n, c = rows.shape[0], png.channels
        px = rows[:, :2 * png.width * c].reshape(n, png.width, c, 2)
        px = px[:, x0:x1, :3].astype(np.int32)
        y = _rgb_to_gray(*np.moveaxis(px[..., 0] << 8 | px[..., 1], -1, 0),
                         16)
        return (y >> 8).astype(np.uint8)
    return np.ascontiguousarray(_to_rgb(png, rows, x0, x1)[..., 0])


def _to_unchanged(png, rows):
    """Unfiltered rows -> what ``cv2.imdecode(..., IMREAD_UNCHANGED)``
    gives: gray (H, W); colour and palette (H, W, 3) BGR, or (H, W, 4)
    BGRA where the file has alpha (a channel, or ``tRNS`` on a colour or
    palette image; gray + alpha becomes BGRA); 16-bit files uint16, others
    uint8 (1/2/4-bit gray scaled to 8 bits)."""
    n, w, c, depth = rows.shape[0], png.width, png.channels, png.depth
    if depth == 16:
        px = rows[:, :2 * w * c].reshape(n, w, c, 2).astype(np.uint16)
        px = px[..., 0] << 8 | px[..., 1]
    elif depth == 8:
        px = rows[:, :w * c].reshape(n, w, c)
    else:
        px = _unpack(rows, depth, w)[:, :, None]
        if png.color == 0:
            px = px * np.uint8(255 // ((1 << depth) - 1))
    top = np.iinfo(px.dtype).max
    if png.color == 0:
        return np.ascontiguousarray(px[..., 0])
    if png.color == 3:
        rgb = png.palette[px[..., 0]]
        if png.trns is None:
            return np.ascontiguousarray(rgb[..., ::-1])
        alpha = np.full(256, 255, np.uint8)
        alpha[:len(png.trns)] = np.frombuffer(png.trns, np.uint8)[:256]
        return np.concatenate([rgb[..., ::-1], alpha[px[..., :1]]], -1)
    if png.color == 4:
        return np.concatenate([np.repeat(px[..., :1], 3, -1), px[..., 1:]],
                              -1)
    if png.color == 6:
        return np.ascontiguousarray(px[..., [2, 1, 0, 3]])
    bgr = np.ascontiguousarray(px[..., ::-1])
    if png.trns is None or len(png.trns) < 6:
        return bgr
    key = np.frombuffer(png.trns[:6], '>u2').astype(px.dtype)
    alpha = np.where((px == key).all(-1, keepdims=True), 0, top).astype(
        px.dtype)
    return np.concatenate([bgr, alpha], -1)


def decode(data, mode='color', name='<buffer>'):
    """A whole PNG file's bytes -> (H, W, 3) uint8 RGB (``'color'``), (H, W)
    uint8 (``'gray'``, as ``load_gray``) or the unchanged samples
    (``'unchanged'``, BGR / BGRA order as cv2 gives them). ``name`` names
    the buffer in errors."""
    png = _parse(data, name)
    rows = _rows(png, png.height)
    if mode == 'color':
        return _to_rgb(png, rows, 0, png.width)
    if mode == 'gray':
        return _to_gray(png, rows, 0, png.width)
    if mode == 'unchanged':
        return _to_unchanged(png, rows)
    raise ValueError(f'decode: mode {mode!r} (color, gray, unchanged)')


def buffer_dims(data, name='<buffer>'):
    """(H, W) of a PNG file's bytes, from its header."""
    width, height, _, _, _ = _header(data, name)
    return height, width


def image_dims(path):
    """(H, W) of a PNG file, from its header."""
    with open(path, 'rb') as f:
        return buffer_dims(f.read(33), path)


def load_crop(path, y0, x0, ch, cw, gray=False):
    """The (ch, cw) window at (y0, x0) of a PNG file -> (ch, cw, 3) uint8
    RGB, or (ch, cw) gray with ``gray``. Only the rows above y0 + ch are
    inflated and unfiltered (all of an interlaced file)."""
    png = _parse(_read(path), path)
    if y0 < 0 or x0 < 0 or y0 + ch > png.height or x0 + cw > png.width:
        raise IOError(f'{path}: window ({y0}, {x0}, {ch}, {cw}) outside the '
                      f'{png.height}x{png.width} frame')
    rows = _rows(png, y0 + ch)[y0:]
    return (_to_gray if gray else _to_rgb)(png, rows, x0, x0 + cw)


def load(path):
    """A whole PNG file -> (H, W, 3) uint8 RGB."""
    png = _parse(_read(path), path)
    return _to_rgb(png, _rows(png, png.height), 0, png.width)


def load_gray(path):
    """A whole PNG file -> (H, W) uint8, as cv2.IMREAD_GRAYSCALE reads
    it."""
    png = _parse(_read(path), path)
    return _to_gray(png, _rows(png, png.height), 0, png.width)


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


def load_seq(paths, gray=False):
    """Whole frames of one size, decoded in parallel -> (T, H, W, 3) uint8
    RGB, or (T, H, W) gray with ``gray``; raises IOError where a frame
    cannot be read or differs in size."""
    frames = list(_get_pool().map(load_gray if gray else load, paths))
    for p, f in zip(paths, frames):
        if f.shape != frames[0].shape:
            raise IOError(f'{p}: {f.shape[:2]} differs from the first '
                          f'frame\'s {frames[0].shape[:2]}')
    return np.stack(frames)
