"""Write the JPEG fixtures of the port's decoder tests: small files from
cv2's encoder (libjpeg-turbo), one of each kind the decoder reads, and
``decoded.npz`` with cv2's RGB decode of each (key: the file's stem). The
card's machine has no cv2: there the decoder is held to the ``.npz``.

    python tools/make_jpeg_fixtures.py [--out tests/fixtures/jpeg]
"""

import argparse
import os

import cv2
import numpy as np

# name -> (H, W, imwrite flags, gray)
KINDS = {
    's444_q95': (37, 53, [cv2.IMWRITE_JPEG_QUALITY, 95,
                          cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                          cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444], False),
    's422_q90': (24, 61, [cv2.IMWRITE_JPEG_QUALITY, 90,
                          cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                          cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422], False),
    's440_q75': (33, 24, [cv2.IMWRITE_JPEG_QUALITY, 75,
                          cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                          cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440], False),
    's420_q95': (64, 96, [cv2.IMWRITE_JPEG_QUALITY, 95], False),
    'gray_q50': (29, 45, [cv2.IMWRITE_JPEG_QUALITY, 50], True),
    'progressive_s420': (31, 50, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1], False),
    'restart3_s420': (19, 67, [cv2.IMWRITE_JPEG_RST_INTERVAL, 3], False),
    'optimized_s422': (25, 39, [cv2.IMWRITE_JPEG_OPTIMIZE, 1,
                                cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422],
                       False),
}


def frame(rng, h, w):
    """Smooth colour waves plus a little texture, uint8 BGR (h, w, 3)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    freq = rng.uniform(0.05, 0.4, (3, 2))
    phase = rng.uniform(0, 2 * np.pi, 3)
    wave = np.stack([np.sin(freq[c, 0] * yy + freq[c, 1] * xx + phase[c])
                     for c in range(3)], axis=-1)
    tex = rng.uniform(-4, 4, (h, w, 3))
    return np.clip(128 + 100 * wave + tex, 0, 255).astype(np.uint8)


def main(out):
    os.makedirs(out, exist_ok=True)
    rng = np.random.default_rng(2026)
    decoded = {}
    for name, (h, w, flags, gray) in KINDS.items():
        img = frame(rng, h, w)
        if gray:
            img = img[..., 1]
        path = os.path.join(out, f'{name}.jpg')
        if not cv2.imwrite(path, img, flags):
            raise IOError(f'cv2 could not write {path}')
        decoded[name] = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
    np.savez_compressed(os.path.join(out, 'decoded.npz'), **decoded)


if __name__ == '__main__':
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--out', default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        'tests', 'fixtures', 'jpeg'))
    main(p.parse_args().out)
