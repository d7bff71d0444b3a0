"""An lmdb store of an image folder (counterpart of the JAX repo's
scripts/data_preparation/create_lmdb.py, BasicSR's create_lmdb).

    python -m bsvd_tpu_torch.scripts.data_preparation.create_lmdb \\
        --input <img_folder> --output <name>.lmdb [--suffix png]

Every ``*.<suffix>`` file under the folder (recursively, sorted) is stored
under its relative path without the extension (a Vimeo90K ``sequences``
folder gives ``<clip>/<seq>/im<i>``), as a PNG of zlib level 1, through
``utils/lmdb_util.make_lmdb_from_imgs``: the ``lmdb`` package's store
where it imports, else the port's record log.
"""

import argparse
import os

from bsvd_tpu_torch.utils.lmdb_util import make_lmdb_from_imgs
from bsvd_tpu_torch.utils.misc import scandir


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--input', required=True, help='input image folder')
    ap.add_argument('--output', required=True, help='output .lmdb path')
    ap.add_argument('--suffix', default='png')
    a = ap.parse_args(argv)
    img_list = sorted(scandir(a.input, suffix=a.suffix, recursive=True))
    keys = [os.path.splitext(p)[0] for p in img_list]
    make_lmdb_from_imgs(a.input, a.output, img_list, keys)


if __name__ == '__main__':
    main()
