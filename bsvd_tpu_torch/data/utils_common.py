"""Reading clips from folders of frames (counterpart of bsvd_tpu/data/
utils_common.py get_imagenames / open_image / open_sequence): digit-sorted
file names, RGB (3, H, W) or gray (1, H, W) float32 in [0, 1], odd sizes
optionally expanded by their last row and column. Gray frames are what
``cv2.imread(path, cv2.IMREAD_GRAYSCALE)`` gives, bit for bit, by each
reader's ``load_gray``.

Each frame takes a route by its file type, never by what failed to build:
``.png`` the zlib reader (``png_decode``), ``.jpg`` / ``.jpeg`` the
standard-C++ JPEG decoder (``jpeg_decode``), ``.bmp`` the BMP reader
(``bmp_decode``), ``.tif`` / ``.tiff`` the TIFF reader (``tiff_decode``);
other types raise NotImplementedError. A folder of frames of several
types raises. ``ROUTES`` counts the frames each route read in this
process.

Where the JAX package reads through cv2 (``open_image``, and
``open_sequence`` in gray or expand mode, or of TIFF frames, which its
native decoder does not read), a frame is turned by its orientation (EXIF,
or TIFF's tag 274) as cv2 turns it (``data/orientation``); where it takes
its native decoder (``open_sequence`` of PNG / JPEG / BMP by default; the
train loader's ``load_crop_seq``) the stored pixels are kept, as there."""

import collections
import glob
import os
import threading

import numpy as np

from bsvd_tpu_torch.data import (bmp_decode, jpeg_decode, orientation,
                                 png_decode, tiff_decode)
from bsvd_tpu_torch.utils.misc import digit_sort_key

IMAGETYPES = ('*.bmp', '*.png', '*.jpg', '*.jpeg', '*.tif')
_MODULES = {'png_decode': png_decode, 'jpeg_decode': jpeg_decode,
            'bmp_decode': bmp_decode, 'tiff_decode': tiff_decode}
_BY_EXT = {'.png': 'png_decode', '.jpg': 'jpeg_decode',
           '.jpeg': 'jpeg_decode', '.bmp': 'bmp_decode',
           '.tif': 'tiff_decode', '.tiff': 'tiff_decode'}
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
    """The reader of a frame file by its type: 'png_decode', 'jpeg_decode',
    'bmp_decode' or 'tiff_decode'. Other types raise
    NotImplementedError."""
    ext = os.path.splitext(str(path))[1].lower()
    if ext not in _BY_EXT:
        raise NotImplementedError(
            f'{path}: {ext or "extensionless"} frames are not read (PNG, '
            f'JPEG, BMP and TIFF)')
    return _BY_EXT[ext]


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


def open_image_dims(path):
    """(H, W) of the frame ``open_image`` reads from ``path`` (before any
    expansion), from the file's headers: its stored size, turned by its
    EXIF orientation."""
    h, w = image_dims(path)
    return orientation.oriented_dims(h, w, orientation.file_orientation(path))


def load_seq(paths, gray=False):
    """Whole frames of one size -> (T, H, W, 3) uint8 RGB, or (T, H, W)
    uint8 gray with ``gray``."""
    return _reader(paths).load_seq(paths, gray)


def load_crop_seq(paths, y0, x0, ch, cw):
    """The (ch, cw) window at (y0, x0) of each frame -> (T, ch, cw, 3)
    uint8 RGB."""
    return _reader(paths).load_crop_seq(paths, y0, x0, ch, cw)


def _expand(img, expand_if_needed):
    """(..., H, W): repeat the last row / column of an odd size; returns
    (img, expanded_h, expanded_w) as the JAX package's open_image."""
    expanded_h = expanded_w = False
    if expand_if_needed:
        if img.shape[-2] % 2 == 1:
            expanded_h = True
            img = np.concatenate([img, img[..., -1:, :]], axis=-2)
        if img.shape[-1] % 2 == 1:
            expanded_w = True
            img = np.concatenate([img, img[..., -1:]], axis=-1)
    return img, expanded_h, expanded_w


def _oriented_seq(files, gray):
    """Whole frames turned by their EXIF orientation, as cv2.imread gives
    them -> (T, H, W, 3) uint8 RGB, or (T, H, W) gray."""
    seq = load_seq(files, gray)
    turns = [orientation.file_orientation(f) for f in files]
    if all(o == 1 for o in turns):
        return seq
    return np.stack([orientation.orient(img, o)
                     for img, o in zip(seq, turns)])


def open_image(fpath, gray_mode=False, expand_if_needed=False,
               normalize_data=True):
    """One frame, turned by its EXIF orientation as cv2.imread turns it ->
    ((3, H, W) RGB or, with ``gray_mode``, (1, H, W) gray, expanded_h,
    expanded_w): float32 in [0, 1], or uint8 with
    ``normalize_data=False``; an odd H or W gains a copy of its last row
    or column with ``expand_if_needed``."""
    img = _oriented_seq([fpath], gray_mode)[0]
    img = img[None] if gray_mode else np.transpose(img, (2, 0, 1))
    img, expanded_h, expanded_w = _expand(img, expand_if_needed)
    if normalize_data:
        img = np.float32(img / 255.)
    return img, expanded_h, expanded_w


def open_sequence(seq_dir, gray_mode=False, expand_if_needed=False,
                  max_num_fr=100):
    """The first ``max_num_fr`` frames of a folder -> ((T, 3, H, W), or
    (T, 1, H, W) with ``gray_mode``, float32 in [0, 1], expanded_h,
    expanded_w), the frames expanded as ``open_image`` expands them. In
    gray or expand mode, and for TIFF frames, the frames are turned by
    their orientation (the JAX package reads them with cv2.imread there);
    otherwise they are not (its native decoder)."""
    files = get_imagenames(seq_dir)[:max_num_fr]
    if not files:
        raise IOError(f'no images found in {seq_dir}')
    if gray_mode or expand_if_needed or route(files[0]) == 'tiff_decode':
        seq = _oriented_seq(files, gray_mode)          # uint8
    else:
        seq = load_seq(files, gray_mode)
    seq = seq[:, None] if gray_mode else np.transpose(seq, (0, 3, 1, 2))
    seq, expanded_h, expanded_w = _expand(seq, expand_if_needed)
    return seq.astype(np.float32) / 255., expanded_h, expanded_w
