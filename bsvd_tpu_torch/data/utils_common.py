"""Reading clips from folders of frames (counterpart of bsvd_tpu/data/
utils_common.py get_imagenames / open_sequence): digit-sorted file names,
RGB (C, H, W) float32 in [0, 1].

Each frame takes a route by its file type, never by what failed to build:
``.png`` the port's zlib reader (``png_decode``), ``.jpg`` / ``.jpeg`` /
``.bmp`` / ``.tif`` the native JPEG decoder (``native_decode``, which
needs libjpeg's headers where it is built). A folder of frames of several
types raises. ``ROUTES`` counts the frames each route read in this
process."""

import collections
import glob
import os
import threading

import numpy as np

from bsvd_tpu_torch.data import native_decode, png_decode
from bsvd_tpu_torch.utils.misc import digit_sort_key

IMAGETYPES = ('*.bmp', '*.png', '*.jpg', '*.jpeg', '*.tif')
_MODULES = {'png_decode': png_decode, 'native_decode': native_decode}
ROUTES = collections.Counter()
_routes_lock = threading.Lock()


def get_imagenames(seq_dir, pattern=None):
    """Image file names in a folder, ordered by the digits they hold."""
    files = []
    for typ in IMAGETYPES:
        files.extend(glob.glob(os.path.join(seq_dir, typ)))
    if pattern is not None:
        files = [f for f in files if pattern in os.path.split(f)[-1]]
    files.sort(key=digit_sort_key)
    return files


def route(path):
    """The reader of a frame file by its type: 'png_decode' or
    'native_decode'."""
    return 'png_decode' if str(path).lower().endswith('.png') \
        else 'native_decode'


def _reader(paths):
    """The reader module of a run of frames, by the first file's type;
    frames of several types raise IOError."""
    r = route(paths[0])
    if any(route(p) != r for p in paths[1:]):
        raise IOError(f'frames of several file types in '
                      f'{os.path.dirname(paths[0])}')
    with _routes_lock:
        ROUTES[r] += len(paths)
    return _MODULES[r]


def image_dims(path):
    """(H, W) of a frame file, by its route."""
    return _MODULES[route(path)].image_dims(path)


def load_seq(paths):
    """Whole frames of one size -> (T, H, W, 3) uint8 RGB."""
    return _reader(paths).load_seq(paths)


def load_crop_seq(paths, y0, x0, ch, cw):
    """The (ch, cw) window at (y0, x0) of each frame -> (T, ch, cw, 3)
    uint8 RGB."""
    return _reader(paths).load_crop_seq(paths, y0, x0, ch, cw)


def open_sequence(seq_dir, gray_mode=False, max_num_fr=100):
    """The first ``max_num_fr`` frames of a folder -> (T, 3, H, W) float32
    in [0, 1]; gray frames are not ported."""
    if gray_mode:
        raise NotImplementedError('open_sequence(gray_mode=True): the '
                                  'readers give RGB only')
    files = get_imagenames(seq_dir)[:max_num_fr]
    if not files:
        raise IOError(f'no images found in {seq_dir}')
    seq = load_seq(files)                               # (T, H, W, 3) uint8
    return np.transpose(seq, (0, 3, 1, 2)).astype(np.float32) / 255.
