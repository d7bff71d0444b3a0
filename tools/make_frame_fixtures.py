"""Write the gray-mode and Adam7 fixtures of the port's frame readers:
small PNG and BMP files of each kind (Adam7-interlaced PNGs of every
colour type, with tRNS and sizes under 8 pixels where passes are empty;
colour, palette and 16-bit PNGs and 8 / 24 / 32-bit BMPs for gray mode),
and ``decoded.npz`` with cv2's decodes: ``<stem>`` the RGB decode,
``<stem>_gray`` the ``IMREAD_GRAYSCALE`` one, and ``jpeg_<stem>_gray``
for each file of ``tests/fixtures/jpeg``. The card's machine has no cv2:
there the readers are held to the ``.npz``.

    python tools/make_frame_fixtures.py [--out tests/fixtures/frames]
"""

import argparse
import glob
import os
import sys

import cv2
import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, 'tests'))

from png_util import make_png  # noqa: E402

# name -> (H, W, depth, colour type, interlaced, palette size, tRNS bytes)
PNGS = {
    'adam7_rgb8': (13, 17, 8, 2, True, 0, None),
    'adam7_rgba16': (11, 9, 16, 6, True, 0, None),
    'adam7_gray1_5x3': (5, 3, 1, 0, True, 0, None),
    'adam7_gray16': (9, 10, 16, 0, True, 0, None),
    'adam7_ga8': (7, 12, 8, 4, True, 0, None),
    'adam7_pal4_trns': (10, 6, 4, 3, True, 14, b'\x00\x80\xff'),
    'adam7_pal8_1x1': (1, 1, 8, 3, True, 3, None),
    'rgb16': (12, 15, 16, 2, False, 0, None),
    'pal8_trns': (9, 14, 8, 3, False, 200, bytes(range(0, 250, 25))),
    'gray4': (6, 11, 4, 0, False, 0, None),
}
# name -> (H, W, channels cv2 writes)
BMPS = {'bmp24': (9, 13, 3), 'bmp32': (8, 11, 4), 'bmp8': (7, 10, 1)}


def main(out):
    os.makedirs(out, exist_ok=True)
    rng = np.random.default_rng(2026)
    decoded = {}

    def record(name, path):
        decoded[name] = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
        decoded[f'{name}_gray'] = cv2.imread(path, cv2.IMREAD_GRAYSCALE)

    for name, (h, w, depth, color, inter, npal, trns) in PNGS.items():
        ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
        top = npal + 2 if color == 3 else 1 << depth
        samples = rng.integers(0, min(top, 1 << depth), (h, w, ch))
        palette = (rng.integers(0, 256, (npal, 3)) if color == 3 else None)
        path = os.path.join(out, f'{name}.png')
        with open(path, 'wb') as f:
            f.write(make_png(samples if ch > 1 else samples[..., 0], depth,
                             color, palette=palette, trns=trns,
                             filters=rng.integers(0, 5, h),
                             interlace=inter))
        record(name, path)
    for name, (h, w, ch) in BMPS.items():
        img = rng.integers(0, 256, (h, w, ch), dtype=np.uint8)
        path = os.path.join(out, f'{name}.bmp')
        if not cv2.imwrite(path, img if ch > 1 else img[..., 0]):
            raise IOError(f'cv2 could not write {path}')
        record(name, path)
    for path in sorted(glob.glob(os.path.join(ROOT, 'tests', 'fixtures',
                                              'jpeg', '*.jpg'))):
        stem = os.path.splitext(os.path.basename(path))[0]
        decoded[f'jpeg_{stem}_gray'] = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    np.savez_compressed(os.path.join(out, 'decoded.npz'), **decoded)


if __name__ == '__main__':
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--out', default=os.path.join(ROOT, 'tests', 'fixtures',
                                                 'frames'))
    main(p.parse_args().out)
