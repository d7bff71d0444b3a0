"""ctypes binding of the port's native JPEG decoder (``_native/
decoder.cpp``, the JPEG half of the JAX package's; counterpart of
bsvd_tpu/data/native_decode.py). ``.jpg`` / ``.jpeg`` / ``.bmp`` /
``.tif`` frames take this route (``data/utils_common.route``); PNG frames
take ``data/png_decode``, on every machine.

The library is built by g++ with libjpeg at first use, never at import,
into ``bsvd_tpu_torch/_build/bsvd_decode-<hash>/`` (listed in
``.gitignore``). Where g++ or libjpeg's headers are missing the build
raises with the compiler's output: there is no other route to JPEG frames
(the port has no cv2). The decoder reads JPEG only: a ``.bmp`` or ``.tif``
frame raises IOError.
"""

import ctypes
import os
import threading
from pathlib import Path

import numpy as np

from bsvd_tpu_torch.data import _gxx

_PKG = _gxx.PKG
SOURCE = Path(__file__).resolve().parent / '_native' / 'decoder.cpp'
GXX_FLAGS = ['-O3', '-shared', '-fPIC']
LIBS = ['-ljpeg', '-pthread']

_lock = threading.Lock()
_lib = None
_loader = None


def build():
    """Compile the decoder if this source hash has no library yet; returns
    the library path. Raises RuntimeError with g++'s output on failure."""
    return _gxx.build(SOURCE, 'bsvd_decode', GXX_FLAGS, LIBS, pkg=_PKG)


def lib():
    """The loaded library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            so = ctypes.CDLL(str(build()))
            so.bsvd_loader_create.restype = ctypes.c_void_p
            so.bsvd_loader_create.argtypes = [ctypes.c_int]
            so.bsvd_load_crop_seq.restype = ctypes.c_int
            so.bsvd_load_crop_seq.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_ubyte), ctypes.c_void_p]
            so.bsvd_image_dims.restype = ctypes.c_int
            so.bsvd_image_dims.argtypes = [ctypes.c_char_p,
                                           ctypes.POINTER(ctypes.c_int),
                                           ctypes.POINTER(ctypes.c_int)]
            _lib = so
        return _lib


def _get_loader():
    """The decoder's thread pool, one per process (lives until exit)."""
    global _loader
    so = lib()
    with _lock:
        if _loader is None:
            _loader = so.bsvd_loader_create(min(8, os.cpu_count() or 4))
        return _loader


def image_dims(path):
    """(H, W) of a JPEG file; raises IOError where it cannot be read."""
    h, w = ctypes.c_int(), ctypes.c_int()
    if lib().bsvd_image_dims(str(path).encode(), ctypes.byref(h),
                             ctypes.byref(w)) != 0:
        raise IOError(f'cannot read image {path}')
    return h.value, w.value


def load_crop_seq(paths, y0, x0, ch, cw):
    """The (ch, cw) window at (y0, x0) of each frame, decoded in parallel
    -> (T, ch, cw, 3) uint8 RGB; y0 = x0 = -1 takes whole frames of
    exactly (ch, cw). Raises IOError where a frame cannot be decoded or
    is smaller than the window."""
    paths = [str(p) for p in paths]
    out = np.empty((len(paths), ch, cw, 3), np.uint8)
    c_paths = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
    rc = lib().bsvd_load_crop_seq(
        c_paths, len(paths), y0, x0, ch, cw,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), _get_loader())
    if rc != 0:
        raise IOError(f'native decoder failed on {paths[rc - 1]} (frame '
                      f'{rc} of {len(paths)})')
    return out


def load_seq(paths):
    """Decode frames of one size in parallel -> (T, H, W, 3) uint8 RGB;
    raises IOError where a frame cannot be decoded or differs in size."""
    h, w = image_dims(paths[0])
    return load_crop_seq(paths, -1, -1, h, w)
