"""A baseline JPEG writer with no image library (what ``cv2.imwrite`` does
for ``.jpg`` in the JAX package): ``data/_native/jpeg_encode.cpp``,
standard C++ only, built by g++ at first use (never at import) into
``bsvd_tpu_torch/_build/bsvd_jpeg_enc-<hash>/`` and bound with ctypes.

It writes the coefficients libjpeg-turbo writes with cv2's defaults
(quality 95, 4:2:0, JFIF, the standard tables of ITU T.81 Annex K), so any
decoder reads the same pixels from its file as from cv2's.
"""

import ctypes
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / 'data' / '_native' / \
    'jpeg_encode.cpp'
GXX_FLAGS = ['-O3', '-shared', '-fPIC']
# luma sampling factors (h, v) by name; chroma is 1x1
SAMPLING = {'4:4:4': (1, 1), '4:2:2': (2, 1), '4:4:0': (1, 2),
            '4:2:0': (2, 2)}

_lock = threading.Lock()
_lib = None


def build():
    """Compile the writer if this source has no library yet; returns its
    path. Raises RuntimeError with g++'s output on failure."""
    # read here: the data package's datasets import this module
    from bsvd_tpu_torch.data import _gxx
    return _gxx.build(SOURCE, 'bsvd_jpeg_enc', GXX_FLAGS, [])


def lib():
    """The loaded library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            so = ctypes.CDLL(str(build()))
            so.bsvd_jpeg_encode.restype = ctypes.c_size_t
            so.bsvd_jpeg_encode.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_ubyte))]
            so.bsvd_jpeg_free.argtypes = [ctypes.c_void_p]
            _lib = so
        return _lib


def encode_jpeg(img, quality=95, sampling='4:2:0'):
    """uint8 (H, W) gray or (H, W, 3) RGB -> baseline JPEG bytes at
    ``quality`` (1-100) with ``sampling`` (a key of SAMPLING; gray ignores
    it)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f'JPEG writer takes uint8, got {img.dtype}')
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f'JPEG writer takes (H, W) or (H, W, 3), got '
                         f'{img.shape}')
    if sampling not in SAMPLING:
        raise ValueError(f'sampling {sampling!r}: one of {sorted(SAMPLING)}')
    if not 1 <= int(quality) <= 100:
        raise ValueError(f'quality {quality}: 1-100')
    img = np.ascontiguousarray(img)
    h, w = img.shape[:2]
    hs, vs = SAMPLING[sampling]
    out = ctypes.POINTER(ctypes.c_ubyte)()
    so = lib()
    n = so.bsvd_jpeg_encode(img.ctypes.data, h, w,
                            1 if img.ndim == 2 else 3, int(quality), hs, vs,
                            ctypes.byref(out))
    if not n:
        raise ValueError(f'JPEG writer cannot write a {img.shape} image '
                         f'(at most 65535 x 65535)')
    try:
        return ctypes.string_at(out, n)
    finally:
        so.bsvd_jpeg_free(out)
