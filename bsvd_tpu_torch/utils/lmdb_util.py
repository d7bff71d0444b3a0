"""lmdb stores of image folders (counterpart of bsvd_tpu/utils/
lmdb_util.py, BasicSR's utils/lmdb_util): ``make_lmdb_from_imgs`` and
BasicSR's ``LmdbMaker``, with BasicSR's layout, ``data.mdb`` beside
``meta_info.txt`` whose lines are ``<key>.png (h,w,c) <compress_level>``.

The store is the real ``lmdb`` package's where it imports, else the
record log of ``utils/_lmdb_compat`` (``lmdb_package``). Frames are read
as cv2's IMREAD_UNCHANGED reads them and stored as PNG, both with the
port's own codecs (``utils/img_util``), not cv2: the PNG bytes may
differ from cv2's, the decoded pixels and ``meta_info.txt`` do not.
"""

import os
import sys


def lmdb_package():
    """The ``lmdb`` package where it imports, else the port's record log."""
    try:
        import lmdb
    except ImportError:
        from bsvd_tpu_torch.utils import _lmdb_compat as lmdb
    return lmdb


def _read(path):
    from bsvd_tpu_torch.utils.img_util import imfrombytes
    with open(path, 'rb') as f:
        return imfrombytes(f.read(), 'unchanged')


def _encode(img, compress_level):
    from bsvd_tpu_torch.utils.img_util import encode_png
    return encode_png(img, level=compress_level)


def _hwc(img):
    return (*img.shape[:2], 1 if img.ndim == 2 else img.shape[2])


def _check_new(lmdb_path):
    """ValueError without the ``.lmdb`` suffix; exit (1) where the path
    exists, as BasicSR's tools do."""
    if not lmdb_path.endswith('.lmdb'):
        raise ValueError("lmdb_path must end with '.lmdb'.")
    if os.path.exists(lmdb_path):
        print(f'Folder {lmdb_path} already exists. Exit.')
        sys.exit(1)


class LmdbMaker:
    """Puts of encoded images into a new store, a commit every ``batch``
    puts, each put's line in ``meta_info.txt``; ``close`` commits the
    rest. A path without the ``.lmdb`` suffix raises ValueError; an
    existing one exits (``sys.exit(1)``), as BasicSR's."""

    def __init__(self, lmdb_path, map_size=1024 ** 4, batch=5000,
                 compress_level=1):
        _check_new(lmdb_path)
        self.batch = batch
        self.compress_level = compress_level
        self.env = lmdb_package().open(lmdb_path, map_size=map_size)
        self.txn = self.env.begin(write=True)
        self.meta = open(os.path.join(lmdb_path, 'meta_info.txt'), 'w')
        self.counter = 0

    def put(self, img_byte, key, img_shape):
        self.counter += 1
        self.txn.put(key.encode('ascii'), bytes(img_byte))
        h, w, c = img_shape
        self.meta.write(f'{key}.png ({h},{w},{c}) {self.compress_level}\n')
        if self.counter % self.batch == 0:
            self.txn.commit()
            self.txn = self.env.begin(write=True)

    def close(self):
        self.txn.commit()
        self.env.close()
        self.meta.close()


def make_lmdb_from_imgs(data_path, lmdb_path, img_path_list, keys,
                        batch=5000, compress_level=1, map_size=None):
    """Each ``data_path/<img_path_list[i]>`` stored under ``keys[i]`` as a
    PNG of zlib level ``compress_level``; ``map_size`` (the lmdb
    package's) by default ten times the first image's PNG size times the
    count, as the JAX package's."""
    assert len(img_path_list) == len(keys)
    print(f'Create lmdb for {data_path}, save to {lmdb_path}...')
    _check_new(lmdb_path)
    if map_size is None:
        first = _read(os.path.join(data_path, img_path_list[0]))
        map_size = len(_encode(first, compress_level)) * len(
            img_path_list) * 10
    maker = LmdbMaker(lmdb_path, map_size, batch, compress_level)
    for path, key in zip(img_path_list, keys):
        img = _read(os.path.join(data_path, path))
        maker.put(_encode(img, compress_level), key, _hwc(img))
    maker.close()
    print('Finish writing lmdb.')
