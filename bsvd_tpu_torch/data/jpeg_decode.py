"""JPEG frames with no image library (counterpart of the JPEG half of the
JAX package's native decoder and of ``cv2.imread`` on ``.jpg`` files):
``_native/jpeg_decode.cpp``, standard C++ only, built by g++ at first use
(never at import) into ``bsvd_tpu_torch/_build/bsvd_jpeg-<hash>/`` and
bound with ctypes. Every ``.jpg`` / ``.jpeg`` frame takes this reader, on
every machine (``data/utils_common.route``).

It reads sequential and progressive Huffman-coded 8-bit JPEG (gray, or
YCbCr at 4:4:4, 4:2:2, 4:4:0 or 4:2:0, restart intervals, any size) and
gives (H, W, 3) uint8 RGB equal bit for bit to libjpeg-turbo's default
decode: the accurate integer IDCT, fancy upsampling, its YCbCr -> RGB
tables; gray gives R = G = B. ``load_gray`` gives (H, W) uint8, the Y
plane alone, as libjpeg's ``JCS_GRAYSCALE`` output (cv2's
``IMREAD_GRAYSCALE``): the chroma is never transformed. A window (``load_crop_seq``) equals the crop
of the whole decode: only the blocks it touches are transformed, and the
entropy decoder stops after the last MCU row it needs.

Valid files of a kind not read here (arithmetic coding, 12-bit, lossless,
CMYK / YCCK, other sampling factors) raise ``UnsupportedJPEG`` (an
IOError that is also a NotImplementedError), naming the marker; truncated
or corrupt streams raise IOError (libjpeg warns and fills with zeros).

Every function is thread-safe: the ctypes call releases the GIL, and
``load_seq`` / ``load_crop_seq`` decode their frames on the library's own
thread pool.
"""

import ctypes
import os
import threading
from pathlib import Path

import numpy as np

from bsvd_tpu_torch.data import _gxx

_PKG = _gxx.PKG
SOURCE = Path(__file__).resolve().parent / '_native' / 'jpeg_decode.cpp'
GXX_FLAGS = ['-O3', '-shared', '-fPIC']
LIBS = ['-pthread']
_ERRLEN = 512

_lock = threading.Lock()
_lib = None
_loader = None


class UnsupportedJPEG(IOError, NotImplementedError):
    """A valid JPEG of a kind the reader does not read (arithmetic coding,
    12-bit, lossless, CMYK / YCCK, other sampling factors)."""


def build():
    """Compile the decoder if this source has no library yet; returns its
    path. Raises RuntimeError with g++'s output on failure."""
    return _gxx.build(SOURCE, 'bsvd_jpeg', GXX_FLAGS, LIBS, pkg=_PKG)


def lib():
    """The loaded library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            so = ctypes.CDLL(str(build()))
            so.bsvd_jpeg_loader_create.restype = ctypes.c_void_p
            so.bsvd_jpeg_loader_create.argtypes = [ctypes.c_int]
            so.bsvd_jpeg_load_crop_seq.restype = ctypes.c_int
            so.bsvd_jpeg_load_crop_seq.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, ctypes.c_int]
            so.bsvd_jpeg_buffer_dims.restype = ctypes.c_int
            so.bsvd_jpeg_buffer_dims.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, ctypes.c_int]
            so.bsvd_jpeg_decode_buffer.restype = ctypes.c_int
            so.bsvd_jpeg_decode_buffer.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
            so.bsvd_jpeg_image_dims.restype = ctypes.c_int
            so.bsvd_jpeg_image_dims.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, ctypes.c_int]
            _lib = so
        return _lib


def _get_loader():
    """The decoder's thread pool, one per process (lives until exit)."""
    global _loader
    so = lib()
    with _lock:
        if _loader is None:
            _loader = so.bsvd_jpeg_loader_create(min(8, os.cpu_count() or 4))
        return _loader


def _raise(kind, where, err):
    msg = f'{where}: {err.value.decode(errors="replace")}'
    raise (UnsupportedJPEG if kind == 2 else IOError)(msg)


def image_dims(path):
    """(H, W) of a JPEG file, from its markers up to the frame header."""
    h, w = ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(_ERRLEN)
    kind = lib().bsvd_jpeg_image_dims(str(path).encode(), ctypes.byref(h),
                                      ctypes.byref(w), err, _ERRLEN)
    if kind:
        _raise(kind, path, err)
    return h.value, w.value


def load_crop_seq(paths, y0, x0, ch, cw, gray=False):
    """The (ch, cw) window at (y0, x0) of each frame, decoded in parallel
    -> (T, ch, cw, 3) uint8 RGB, or (T, ch, cw) Y with ``gray``; y0 = x0
    = -1 takes whole frames of exactly (ch, cw)."""
    paths = [str(p) for p in paths]
    out = np.empty((len(paths), ch, cw) + (() if gray else (3,)), np.uint8)
    c_paths = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
    kind = ctypes.c_int()
    err = ctypes.create_string_buffer(_ERRLEN)
    bad = lib().bsvd_jpeg_load_crop_seq(
        c_paths, len(paths), y0, x0, ch, cw, int(gray), out.ctypes.data,
        _get_loader(), ctypes.byref(kind), err, _ERRLEN)
    if bad:
        _raise(kind.value, paths[bad - 1], err)
    return out


def load(path):
    """A whole JPEG file -> (H, W, 3) uint8 RGB."""
    return load_seq([path])[0]


def load_seq(paths, gray=False):
    """Whole frames of one size, decoded in parallel -> (T, H, W, 3) uint8
    RGB, or (T, H, W) Y with ``gray``; raises IOError where a frame cannot
    be read or differs in size."""
    h, w = image_dims(paths[0])
    return load_crop_seq(paths, -1, -1, h, w, gray)


def load_gray(path):
    """A whole JPEG file -> (H, W) uint8 Y."""
    return load_seq([path], gray=True)[0]


def _buffer_header(data, name):
    """(H, W, components) of a JPEG file's bytes, from its markers up to
    the frame header."""
    h, w, comps = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(_ERRLEN)
    kind = lib().bsvd_jpeg_buffer_dims(data, len(data), ctypes.byref(h),
                                       ctypes.byref(w), ctypes.byref(comps),
                                       err, _ERRLEN)
    if kind:
        _raise(kind, name, err)
    return h.value, w.value, comps.value


def buffer_dims(data, name='<buffer>'):
    """(H, W) of a JPEG file's bytes, from its frame header."""
    return _buffer_header(bytes(data), name)[:2]


def decode(data, mode='color', name='<buffer>'):
    """A whole JPEG file's bytes, decoded in the calling thread -> (H, W, 3)
    uint8 RGB (``'color'``), (H, W) Y (``'gray'``), or what cv2's
    IMREAD_UNCHANGED gives (``'unchanged'``: a one-component file's Y,
    else BGR). ``name`` names the buffer in errors."""
    if mode not in ('color', 'gray', 'unchanged'):
        raise ValueError(f'decode: mode {mode!r} (color, gray, unchanged)')
    data = bytes(data)
    h, w, comps = _buffer_header(data, name)
    gray = mode == 'gray' or (mode == 'unchanged' and comps == 1)
    out = np.empty((h, w) + (() if gray else (3,)), np.uint8)
    err = ctypes.create_string_buffer(_ERRLEN)
    kind = lib().bsvd_jpeg_decode_buffer(data, len(data), h, w, int(gray),
                                         out.ctypes.data, err, _ERRLEN)
    if kind:
        _raise(kind, name, err)
    if mode == 'unchanged' and not gray:
        return np.ascontiguousarray(out[..., ::-1])
    return out
