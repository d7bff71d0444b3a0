"""ctypes binding of the port's native frame decoder (``_native/
decoder.cpp``, a copy of the JAX package's; counterpart of bsvd_tpu/data/
native_decode.py).

The library is built by g++ (libpng, libjpeg) at first use, never at
import, into ``bsvd_tpu_torch/_build/decode-<hash>/`` (listed in
``.gitignore``), keyed on the source's hash. Where g++, libpng or libjpeg
is missing the build raises with the compiler's output: there is no
other route to the frames (the port has no cv2).
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = Path(__file__).resolve().parent / '_native' / 'decoder.cpp'
GXX_FLAGS = ['-O3', '-shared', '-fPIC']
LIBS = ['-lpng', '-ljpeg', '-pthread']

_lock = threading.Lock()
_lib = None
_loader = None


def build():
    """Compile the decoder if this source hash has no library yet; returns
    the library path. Raises RuntimeError with g++'s output on failure."""
    h = hashlib.sha256(' '.join(GXX_FLAGS + LIBS).encode())
    h.update(SOURCE.read_bytes())
    out = _PKG / '_build' / f'decode-{h.hexdigest()[:16]}' / \
        'libbsvd_decode.so'
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
    cmd = ['g++', *GXX_FLAGS, str(SOURCE), '-o', str(tmp), *LIBS]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f'native decoder: g++ not found ({e}); frames '
                           f'cannot be read without it') from e
    if res.returncode != 0:
        raise RuntimeError(f'native decoder build failed ({" ".join(cmd)}):'
                           f'\n{res.stdout}{res.stderr}')
    os.replace(tmp, out)           # atomic: concurrent processes agree
    return out


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
    """(H, W) of an image file; raises IOError where it cannot be read."""
    h, w = ctypes.c_int(), ctypes.c_int()
    if lib().bsvd_image_dims(str(path).encode(), ctypes.byref(h),
                             ctypes.byref(w)) != 0:
        raise IOError(f'cannot read image {path}')
    return h.value, w.value


def load_seq(paths):
    """Decode frames of one size in parallel -> (T, H, W, 3) uint8 RGB;
    raises IOError where a frame cannot be decoded or differs in size."""
    paths = [str(p) for p in paths]
    h, w = image_dims(paths[0])
    out = np.empty((len(paths), h, w, 3), np.uint8)
    c_paths = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
    rc = lib().bsvd_load_crop_seq(
        c_paths, len(paths), -1, -1, h, w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), _get_loader())
    if rc != 0:
        raise IOError(f'native decoder failed ({rc}) on {len(paths)} frames '
                      f'from {os.path.dirname(paths[0])}')
    return out
