"""What the inference scripts share: the input folder's images, read by
the port's own decoders."""

import glob
import os

from bsvd_tpu_torch.utils.img_util import imfrombytes, img2tensor


def folder_images(folder):
    """(index, name without extension, float32 (3, H, W) RGB in [0, 1]) of
    every file of ``folder`` in sorted order, decoded as ``cv2.imread(path,
    IMREAD_COLOR)`` would (the JAX scripts' read) and through
    ``img2tensor``."""
    for idx, path in enumerate(sorted(glob.glob(os.path.join(folder, '*')))):
        name = os.path.splitext(os.path.basename(path))[0]
        with open(path, 'rb') as f:
            yield idx, name, img2tensor(imfrombytes(f.read(), 'color'))
