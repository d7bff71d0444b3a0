"""TIFF frames with no image library (what ``cv2.imread`` / ``cv2.imdecode``
do for ``.tif`` files in the JAX package, through libtiff): the stdlib's
zlib, numpy, and a C++ LZW / PackBits codec (``_native/tiff_decode.cpp``,
built by g++ at first use into ``bsvd_tpu_torch/_build/``, standard
library only). Every ``.tif`` frame takes this reader, on every machine
(``data/utils_common.route``).

What it reads: byte orders II and MM; strips and tiles; PlanarConfiguration
1 and 2; compression 1 (none), 5 (LZW, the old bit order too), 8 and 32946
(Deflate) and 32773 (PackBits); predictor 1 and 2 (horizontal
differencing) on 8- and 16-bit samples; 8- and 16-bit unsigned gray
(MinIsBlack), RGB and RGBA. A window crop decodes only the strips or tiles
that hold the window.

Output, by cv2 5.0's rules (found against it; it reads 8-bit images
through libtiff's TIFFRGBAImage):

- ``'color'``: (H, W, 3) uint8 RGB; 16-bit RGB samples to ``round(v /
  257)`` (``(v + 128) // 257``), 16-bit gray to ``v >> 8``; gray
  replicated; the alpha of RGBA dropped, except that unassociated alpha
  (ExtraSamples 2) premultiplies the colours first (``(c * a + 127) //
  255`` on the 8-bit values);
- ``'gray'``: (H, W) uint8: gray as in colour, RGB(A) through cv2's
  14-bit BGR -> gray rule (R 4899, G 9617, B 1868, rounded) on the 8-bit
  colour values;
- ``'unchanged'``: the file's own depth and channels in cv2's order: (H,
  W) gray, BGR, BGRA (8-bit unassociated alpha premultiplied as above;
  16-bit samples as stored).

``decode`` / ``load*`` / ``buffer_dims`` keep the stored pixels. cv2
turns a TIFF by its tag 274 in every mode, IMREAD_UNCHANGED too (unlike
JPEG and PNG); the cv2 routes of ``utils_common`` and ``img_util`` turn it
(``data/orientation``).

Anything else raises ``UnsupportedTIFF`` naming the tag and its value:
compression 7 (JPEG) and every other code, photometric other than 1 / 2
(MinIsWhite, palette, YCbCr, ...), predictor 3, bits other than 8 / 16,
SampleFormat other than 1 (signed, float), SamplesPerPixel other than 1, 3
or 4, FillOrder 2, a page past the first, and PlanarConfiguration 2 of
16-bit samples under ``'unchanged'`` (cv2 reads those planes as if they
were interleaved). Truncated or malformed files raise IOError.
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

SOURCE = Path(__file__).resolve().parent / '_native' / 'tiff_decode.cpp'
GXX_FLAGS = ['-O3', '-shared', '-fPIC']
SIGNATURES = (b'II*\0', b'MM\0*')
# tag numbers
WIDTH, HEIGHT, BITS, COMPRESSION, PHOTOMETRIC = 256, 257, 258, 259, 262
FILL_ORDER, STRIP_OFFSETS, SPP, ROWS_PER_STRIP = 266, 273, 277, 278
STRIP_COUNTS, PLANAR, PREDICTOR = 279, 284, 317
TILE_WIDTH, TILE_LENGTH, TILE_OFFSETS, TILE_COUNTS = 322, 323, 324, 325
EXTRA_SAMPLES, SAMPLE_FORMAT = 338, 339
COMPRESSIONS = {1: 'none', 5: 'LZW', 8: 'Deflate', 32946: 'Deflate',
                32773: 'PackBits'}
# cv2's icvCvt_BGR2Gray_8u_C3C1R: 0.299, 0.587, 0.114 in 14-bit fixed point
_GRAY_R, _GRAY_G, _GRAY_B = 4899, 9617, 1868
# field type -> (struct code, size)
_TYPES = {1: ('B', 1), 2: ('B', 1), 3: ('H', 2), 4: ('I', 4), 6: ('b', 1),
          7: ('B', 1), 8: ('h', 2), 9: ('i', 4)}

_lock = threading.Lock()
_lib = None
_pool = None


class UnsupportedTIFF(IOError, NotImplementedError):
    """A valid TIFF of a kind the reader does not read; the message names
    the tag and its value."""


def build():
    """Compile the codec if this source has no library yet; returns its
    path. Raises RuntimeError with g++'s output on failure."""
    return _gxx.build(SOURCE, 'bsvd_tiff', GXX_FLAGS, [])


def lib():
    """The loaded codec library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            so = ctypes.CDLL(str(build()))
            p = ctypes.c_void_p
            so.bsvd_tiff_decode.restype = ctypes.c_int
            so.bsvd_tiff_decode.argtypes = [ctypes.c_int, ctypes.c_char_p,
                                            ctypes.c_int, p, p, p, p, p]
            so.bsvd_tiff_lzw_encode.restype = ctypes.c_int64
            so.bsvd_tiff_lzw_encode.argtypes = [ctypes.c_char_p,
                                                ctypes.c_int64, p,
                                                ctypes.c_int64]
            _lib = so
        return _lib


class _Tiff:
    """The first image file directory (IFD) of a TIFF file: its fields,
    checked against what the reader reads."""

    def __init__(self, data, name, page=0):
        if len(data) < 8 or data[:4] not in SIGNATURES:
            raise IOError(f'{name}: not a TIFF file (bad signature)')
        self.name = name
        self.end = '<' if data[:2] == b'II' else '>'
        if page:
            raise UnsupportedTIFF(f'{name}: page {page} (the first page '
                                  f'only is read, as cv2.imread reads)')
        ifd = self._u32(data, 4)
        if ifd == 0 or ifd + 2 > len(data):
            raise IOError(f'{name}: truncated TIFF (no IFD)')
        self.tags = self._ifd(data, ifd)
        self._check()

    def _u32(self, data, off):
        if off + 4 > len(data):
            raise IOError(f'{self.name}: truncated TIFF')
        return struct.unpack_from(self.end + 'I', data, off)[0]

    def _ifd(self, data, off):
        """{tag: tuple of values} of the IFD at ``off``."""
        n = struct.unpack_from(self.end + 'H', data, off)[0]
        if off + 2 + 12 * n > len(data):
            raise IOError(f'{self.name}: truncated TIFF directory')
        tags = {}
        for i in range(n):
            e = off + 2 + 12 * i
            tag, typ, count = struct.unpack_from(self.end + 'HHI', data, e)
            if typ not in _TYPES:
                continue                  # rationals, floats: not needed
            code, size = _TYPES[typ]
            at = e + 8 if count * size <= 4 else self._u32(data, e + 8)
            if at + count * size > len(data):
                raise IOError(f'{self.name}: truncated TIFF tag {tag}')
            tags[tag] = struct.unpack_from(f'{self.end}{count}{code}', data,
                                           at)
        return tags

    def _one(self, tag, default=None):
        v = self.tags.get(tag)
        if v is None:
            if default is None:
                raise IOError(f'{self.name}: TIFF without tag {tag}')
            return default
        return v[0]

    def _refuse(self, tag, what, value):
        raise UnsupportedTIFF(f'{self.name}: TIFF tag {tag} ({what}) = '
                              f'{value} is not read')

    def _check(self):
        self.width, self.height = self._one(WIDTH), self._one(HEIGHT)
        if self.width <= 0 or self.height <= 0:
            raise IOError(f'{self.name}: invalid TIFF size '
                          f'{self.width}x{self.height}')
        self.spp = self._one(SPP, 1)
        bits = self.tags.get(BITS, (1,))
        self.compression = self._one(COMPRESSION, 1)
        self.photometric = self._one(PHOTOMETRIC, 1 if self.spp < 3 else 2)
        self.predictor = self._one(PREDICTOR, 1)
        self.planar = self._one(PLANAR, 1)
        formats = self.tags.get(SAMPLE_FORMAT, (1,))
        if self.compression not in COMPRESSIONS:
            self._refuse(COMPRESSION, 'Compression', self.compression)
        if self.photometric not in (1, 2):
            self._refuse(PHOTOMETRIC, 'PhotometricInterpretation',
                         self.photometric)
        if self.spp not in ((1,) if self.photometric == 1 else (3, 4)):
            self._refuse(SPP, 'SamplesPerPixel', self.spp)
        if len(set(bits)) != 1 or bits[0] not in (8, 16):
            self._refuse(BITS, 'BitsPerSample', bits)
        if any(f != 1 for f in formats):
            self._refuse(SAMPLE_FORMAT, 'SampleFormat', formats)
        if self.predictor not in (1, 2):
            self._refuse(PREDICTOR, 'Predictor', self.predictor)
        if self.planar not in (1, 2):
            self._refuse(PLANAR, 'PlanarConfiguration', self.planar)
        if self._one(FILL_ORDER, 1) != 1:
            self._refuse(FILL_ORDER, 'FillOrder', self._one(FILL_ORDER))
        self.bits = bits[0]
        self.dtype = np.dtype(np.uint8 if self.bits == 8 else
                              self.end + 'u2')
        extra = self.tags.get(EXTRA_SAMPLES, ())
        self.unassociated = self.spp == 4 and extra[:1] == (2,)
        self.tiled = TILE_OFFSETS in self.tags
        if self.tiled:
            self.tw, self.th = self._one(TILE_WIDTH), self._one(TILE_LENGTH)
            offsets, counts = self.tags[TILE_OFFSETS], self.tags.get(
                TILE_COUNTS)
        else:
            self.tw = self.width
            self.th = min(self._one(ROWS_PER_STRIP, 2 ** 32 - 1),
                          self.height)
            offsets, counts = self.tags.get(STRIP_OFFSETS), self.tags.get(
                STRIP_COUNTS)
        if self.tw <= 0 or self.th <= 0:
            raise IOError(f'{self.name}: invalid TIFF strip / tile size')
        self.across = -(-self.width // self.tw)
        self.down = -(-self.height // self.th)
        self.planes = self.spp if self.planar == 2 else 1
        need = self.across * self.down * self.planes
        have = min(len(offsets or ()), len(counts or ()))
        if have < need:
            raise IOError(f'{self.name}: TIFF has {have} strips / tiles of '
                          f'the {need} it needs')
        self.offsets, self.counts = offsets, counts


def _chunks(t, y0, x0, ch, cw):
    """The strips / tiles that hold the window: (index, plane, row, column)
    of each, the index into the offsets."""
    rows = range(y0 // t.th, (y0 + ch - 1) // t.th + 1)
    cols = range(x0 // t.tw, (x0 + cw - 1) // t.tw + 1)
    return [(p * t.across * t.down + r * t.across + c, p, r, c)
            for p in range(t.planes) for r in rows for c in cols]


def _decode_chunks(t, data, chunks):
    """The chunks' bytes decoded one after another into one uint8 array,
    and each chunk's (start, shape): (rows, tile width, samples a
    chunk)."""
    n = t.spp // t.planes
    size = t.tw * n * t.dtype.itemsize        # bytes of one chunk row
    shapes, lens = [], []
    for i, _, r, _ in chunks:
        rows = t.th if t.tiled else min(t.th, t.height - r * t.th)
        shapes.append((rows, t.tw, n))
        lens.append(rows * size)
    offs = np.array([t.offsets[i] for i, *_ in chunks], np.int64)
    counts = np.array([t.counts[i] for i, *_ in chunks], np.int64)
    if (offs + counts > len(data)).any():
        raise IOError(f'{t.name}: truncated TIFF (a strip or tile past the '
                      f'end)')
    dst_offs = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    out = np.empty(int(sum(lens)), np.uint8)
    if t.compression == 1:
        # libtiff reads a strip's whole size where the file holds it, a
        # StripByteCounts too small notwithstanding
        for o, d, n_ in zip(offs, dst_offs, lens):
            if o + n_ > len(data):
                raise IOError(f'{t.name}: truncated TIFF strip or tile')
            out[d:d + n_] = np.frombuffer(data, np.uint8, n_, o)
    elif t.compression in (8, 32946):
        for o, c, d, n_ in zip(offs, counts, dst_offs, lens):
            try:
                raw = zlib.decompressobj().decompress(
                    memoryview(data)[o:o + c], n_)
            except zlib.error as e:
                raise IOError(f'{t.name}: corrupt Deflate data ({e})') \
                    from None
            if len(raw) < n_:
                raise IOError(f'{t.name}: not enough Deflate data '
                              f'({len(raw)} of {n_} bytes)')
            out[d:d + n_] = np.frombuffer(raw, np.uint8)
    else:
        lens_a = np.array(lens, np.int64)
        rc = lib().bsvd_tiff_decode(
            t.compression, data, len(chunks), offs.ctypes.data,
            counts.ctypes.data, out.ctypes.data, dst_offs.ctypes.data,
            lens_a.ctypes.data)
        if rc:
            raise IOError(f'{t.name}: corrupt or short '
                          f'{COMPRESSIONS[t.compression]} data in strip / '
                          f'tile {chunks[-rc - 1][0]}')
    return out, list(zip(dst_offs, shapes))


def _samples(t, raw, shape):
    """Decoded bytes -> (rows, width, n) samples in native order, the
    predictor (per row) undone."""
    s = raw.view(t.dtype).reshape(shape).astype(t.dtype.newbyteorder('='))
    if t.predictor == 2:
        s = np.cumsum(s, axis=1, dtype=s.dtype)
    return s


def _window(t, data, y0, x0, ch, cw):
    """(ch, cw, spp) stored samples of the window, uint8 or uint16."""
    if y0 < 0 or x0 < 0 or y0 + ch > t.height or x0 + cw > t.width:
        raise IOError(f'{t.name}: window ({y0}, {x0}, {ch}, {cw}) outside '
                      f'the {t.height}x{t.width} frame')
    chunks = _chunks(t, y0, x0, ch, cw)
    out, parts = _decode_chunks(t, data, chunks)
    if not t.tiled and t.planes == 1:
        # interleaved strips: the decoded bytes are whole rows in order
        ya = chunks[0][2] * t.th
        s = _samples(t, out, (-1, t.width, t.spp))
        return s[y0 - ya:y0 - ya + ch, x0:x0 + cw]
    n = t.spp // t.planes
    win = np.empty((ch, cw, t.spp), t.dtype.newbyteorder('='))
    for (_, p, r, c), (d, shape) in zip(chunks, parts):
        s = _samples(t, out[d:d + int(np.prod(shape)) * t.dtype.itemsize],
                     shape)
        ya, xa = r * t.th, c * t.tw                 # the chunk's origin
        y1, y2 = max(y0, ya), min(y0 + ch, ya + s.shape[0])
        x1, x2 = max(x0, xa), min(x0 + cw, xa + t.tw)
        win[y1 - y0:y2 - y0, x1 - x0:x2 - x0, p * n:(p + 1) * n] = \
            s[y1 - ya:y2 - ya, x1 - xa:x2 - xa]
    return win


def _to8(t, s):
    """Samples -> 8-bit colour values as TIFFRGBAImage gives them (16-bit
    gray ``v >> 8``, 16-bit colour ``(v + 128) // 257``; unassociated
    alpha premultiplied)."""
    if t.bits == 16:
        v = s.astype(np.uint32)
        s = (v >> 8 if t.spp == 1 else (v + 128) // 257).astype(np.uint8)
    if t.unassociated:
        a = s[..., 3:].astype(np.uint32)
        rgb = (s[..., :3].astype(np.uint32) * a + 127) // 255
        s = np.concatenate([rgb.astype(np.uint8), s[..., 3:]], -1)
    return s


def _rgb(t, s):
    s = _to8(t, s)
    if t.spp == 1:
        return np.repeat(s, 3, axis=-1)
    return np.ascontiguousarray(s[..., :3])


def _gray(t, s):
    s = _to8(t, s)
    if t.spp == 1:
        return np.ascontiguousarray(s[..., 0])
    r, g, b = np.moveaxis(s[..., :3].astype(np.int32), -1, 0)
    return ((r * _GRAY_R + g * _GRAY_G + b * _GRAY_B + (1 << 13))
            >> 14).astype(np.uint8)


def _unchanged(t, s):
    if t.bits == 8:
        s = _to8(t, s)
    if t.spp == 1:
        return np.ascontiguousarray(s[..., 0])
    order = [2, 1, 0] + ([3] if t.spp == 4 else [])
    return np.ascontiguousarray(s[..., order])


_MODES = {'color': _rgb, 'gray': _gray, 'unchanged': _unchanged}


def decode(data, mode='color', name='<buffer>', page=0):
    """A whole TIFF file's bytes -> (H, W, 3) uint8 RGB (``'color'``),
    (H, W) uint8 (``'gray'``) or cv2's IMREAD_UNCHANGED image
    (``'unchanged'``), the stored pixels (not turned by tag 274). ``page``
    past 0 raises UnsupportedTIFF; ``name`` names the buffer in errors."""
    if mode not in _MODES:
        raise ValueError(f'decode: mode {mode!r} (color, gray, unchanged)')
    data = bytes(data)
    t = _Tiff(data, name, page)
    if mode == 'unchanged' and t.bits == 16 and t.planar == 2:
        # cv2 reads these planes as if interleaved (found against it)
        t._refuse(PLANAR, 'PlanarConfiguration, 16-bit, unchanged', 2)
    return _MODES[mode](t, _window(t, data, 0, 0, t.height, t.width))


def buffer_dims(data, name='<buffer>'):
    """(H, W) of a TIFF file's bytes, from its first IFD."""
    t = _Tiff(bytes(data), name)
    return t.height, t.width


def _read(path):
    with open(path, 'rb') as f:
        return f.read()


def image_dims(path):
    """(H, W) of a TIFF file, from its first IFD."""
    return buffer_dims(_read(path), path)


def load_crop(path, y0, x0, ch, cw, gray=False):
    """The (ch, cw) window at (y0, x0) of a TIFF file -> (ch, cw, 3) uint8
    RGB, or (ch, cw) gray with ``gray``; only the strips or tiles that
    hold the window are decoded."""
    data = _read(path)
    t = _Tiff(data, path)
    return (_gray if gray else _rgb)(t, _window(t, data, y0, x0, ch, cw))


def load(path):
    """A whole TIFF file -> (H, W, 3) uint8 RGB."""
    return decode(_read(path), name=path)


def load_gray(path):
    """A whole TIFF file -> (H, W) uint8, as cv2.IMREAD_GRAYSCALE reads
    it (before its orientation)."""
    return decode(_read(path), 'gray', path)


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
                                       thread_name_prefix='tiff_decode')
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


def lzw_encode(raw):
    """TIFF LZW (new style) of ``raw`` bytes, by the native codec."""
    raw = bytes(raw)
    cap = len(raw) * 2 + 64
    out = np.empty(cap, np.uint8)
    n = lib().bsvd_tiff_lzw_encode(raw, len(raw), out.ctypes.data, cap)
    if n < 0:
        raise RuntimeError('LZW output past its buffer')
    return out[:n].tobytes()
