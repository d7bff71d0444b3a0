"""A PNG writer for the PNG reader's tests: any colour type and bit depth,
a palette and tRNS, a filter type per row, several IDAT chunks and Adam7
interlacing, built on the port's row filter (utils/img_util.filter_rows)."""

import struct
import zlib

import numpy as np

from bsvd_tpu_torch.utils.img_util import filter_rows

CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# Adam7 passes: (x0, y0, dx, dy)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def chunk(tag, data):
    return (struct.pack('>I', len(data)) + tag + data
            + struct.pack('>I', zlib.crc32(tag + data)))


def pack_rows(samples, depth):
    """(H, W, C) or (H, W) samples -> (H, rowbytes) uint8 scanlines."""
    s = np.asarray(samples)
    if s.ndim == 2:
        s = s[..., None]
    h = s.shape[0]
    if depth == 16:
        return s.astype('>u2').view(np.uint8).reshape(h, -1)
    if depth == 8:
        return s.astype(np.uint8).reshape(h, -1)
    bits = (s.reshape(h, -1, 1).astype(np.uint8)
            >> np.arange(depth - 1, -1, -1, dtype=np.uint8)) & 1
    return np.packbits(bits.reshape(h, -1), axis=1)


def make_png(samples, depth, color, palette=None, trns=None, filters=None,
             idat_chunks=1, interlace=False, level=6):
    """PNG bytes of ``samples`` ((H, W, C) or (H, W) integers) at ``depth``
    and colour type ``color``; ``filters``: one filter type per row (or an
    int for every row; default 0), ``trns``: the tRNS chunk's payload."""
    s = np.asarray(samples)
    h, w = s.shape[:2]
    bpp = max(1, CHANNELS[color] * depth // 8)

    def filtered(sub):
        rows = pack_rows(sub, depth)
        f = np.zeros(len(rows), np.int64) if filters is None else \
            np.resize(np.asarray(filters, np.int64), len(rows))
        return filter_rows(rows, bpp, f).tobytes()

    if interlace:
        raw = b''.join(filtered(s[y0::dy, x0::dx])
                       for x0, y0, dx, dy in ADAM7
                       if s[y0::dy, x0::dx].size)
    else:
        raw = filtered(s)
    data = zlib.compress(raw, level)
    step = -(-len(data) // idat_chunks)
    out = b'\x89PNG\r\n\x1a\n' + chunk(b'IHDR', struct.pack(
        '>IIBBBBB', w, h, depth, color, 0, 0, int(interlace)))
    if palette is not None:
        out += chunk(b'PLTE', np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += chunk(b'tRNS', trns)
    for i in range(0, len(data), step):
        out += chunk(b'IDAT', data[i:i + step])
    return out + chunk(b'IEND', b'')
