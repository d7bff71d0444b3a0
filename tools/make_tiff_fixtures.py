"""Write the TIFF fixtures of the port's TIFF reader tests under
``tests/fixtures/tiff/``: files from cv2's writer (libtiff) with each
compression it writes (1 none, 5 LZW, 8 and 32946 Deflate, 32773
PackBits), 8- and 16-bit, gray, RGB and RGBA; and files this module
builds by hand for what cv2 does not write (tiles, byte order MM, tag 274
at every value, PlanarConfiguration 2, the old LZW bit order). The tests
hold the port's reader to cv2 on each; ``write_tiff`` also builds the
files of the raising cases at run time.

    python tools/make_tiff_fixtures.py [--out tests/fixtures/tiff]

cv2 is needed to write the cv2 files; ``write_tiff`` needs numpy only.
"""

import argparse
import os
import struct
import zlib

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# TIFF field types: BYTE, ASCII, SHORT, LONG, RATIONAL
_TYPES = {1: ('B', 1), 2: ('s', 1), 3: ('H', 2), 4: ('I', 4), 5: ('II', 8)}


def lzw_encode(data, compat=False):
    """TIFF LZW (specification 6.0, section 13) of ``data``: codes MSB
    first, the code width grown one code early; ``compat``: the old
    libtiff bit order (LSB first, grown at the power of two)."""
    out, acc, nacc = bytearray(), 0, 0
    nbits = 9

    def put(code):
        nonlocal acc, nacc
        if compat:
            acc |= code << nacc
            nacc += nbits
            while nacc >= 8:
                out.append(acc & 0xFF)
                acc >>= 8
                nacc -= 8
        else:
            acc = (acc << nbits) | code
            nacc += nbits
            while nacc >= 8:
                out.append((acc >> (nacc - 8)) & 0xFF)
                nacc -= 8
            acc &= (1 << nacc) - 1

    table = {bytes([i]): i for i in range(256)}
    nxt = 258
    put(256)
    w = b''
    early = 0 if compat else 1

    def grow():
        nonlocal nbits
        if nxt + early > (1 << nbits) and nbits < 12:
            nbits += 1

    for c in bytes(data):
        wc = w + bytes([c])
        if wc in table:
            w = wc
            continue
        put(table[w])
        table[wc] = nxt
        nxt += 1
        if nxt + early >= 4095:
            put(256)
            table = {bytes([i]): i for i in range(256)}
            nxt, nbits = 258, 9
        else:
            grow()
        w = bytes([c])
    if w:
        put(table[w])
        nxt += 1
        grow()
    put(257)
    if nacc:
        out.append((acc << (8 - nacc)) & 0xFF if not compat else acc & 0xFF)
    return bytes(out)


def packbits_encode(data):
    """PackBits (TIFF 6.0, section 9): runs of 3-128 equal bytes as one,
    the rest as literal runs of up to 128."""
    data, out, i = bytes(data), bytearray(), 0
    while i < len(data):
        j = i
        while j + 1 < len(data) and data[j + 1] == data[i] and j - i < 127:
            j += 1
        if j - i >= 2:
            out += bytes([257 - (j - i + 1), data[i]])
            i = j + 1
            continue
        j = i
        while j < len(data) and j - i < 128 and not (
                j + 2 < len(data) and data[j] == data[j + 1] == data[j + 2]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def _predict(block, spp, width):
    """Horizontal differencing (predictor 2) of (rows, width * spp)
    samples, in their own type (wrapping)."""
    rows = block.reshape(-1, width, spp)
    diff = rows.copy()
    diff[:, 1:] = rows[:, 1:] - rows[:, :-1]
    return diff.reshape(block.shape)


def _compress(raw, compression):
    if compression == 1:
        return raw
    if compression == 5:
        return lzw_encode(raw)
    if compression == 6:                   # old LZW bit order, code 5
        return lzw_encode(raw, compat=True)
    if compression in (8, 32946):
        return zlib.compress(raw, 6)
    if compression == 32773:
        return packbits_encode(raw)
    return raw                             # a code the reader must refuse


def write_tiff(img, order='II', compression=1, predictor=1, planar=1,
               tile=None, rows_per_strip=None, orientation=None,
               extra_samples=None, photometric=None, tags=None,
               pages=1, lzw_compat=False):
    """TIFF bytes of ``img``, (H, W) or (H, W, C) uint8 / uint16 samples in
    storage order (RGB[A]): ``order`` II or MM; strips of
    ``rows_per_strip`` rows (one strip by default) or ``tile`` (th, tw)
    tiles (multiples of 16); ``planar`` 1 (interleaved) or 2 (a plane a
    sample); ``orientation`` tag 274; ``extra_samples`` tag 338's value
    for a fourth sample; ``photometric`` tag 262 (1 gray, 2 RGB by
    default); ``tags``: {tag: (type, values)} added or replacing;
    ``pages`` > 1 chains that many IFDs of the same image; ``lzw_compat``
    codes compression 5 in the old bit order."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    h, w, spp = img.shape
    bits = img.dtype.itemsize * 8
    end = '<' if order == 'II' else '>'
    samples = img.astype(img.dtype.newbyteorder(end))
    code = 6 if compression == 5 and lzw_compat else compression

    def chunk_bytes(block, width):
        """One strip or tile ((rows, width, n) samples) compressed."""
        if predictor == 2:
            block = _predict(block, block.shape[-1], width)
        return _compress(np.ascontiguousarray(block).tobytes(), code)

    planes = ([samples] if planar == 1 else
              [samples[..., s:s + 1] for s in range(spp)])
    chunks = []
    if tile is None:
        rps = rows_per_strip or h
        for plane in planes:
            for y in range(0, h, rps):
                chunks.append(chunk_bytes(plane[y:y + rps], w))
    else:
        th, tw = tile
        for plane in planes:
            for y in range(0, h, th):
                for x in range(0, w, tw):
                    t = np.zeros((th, tw, plane.shape[-1]), plane.dtype)
                    part = plane[y:y + th, x:x + tw]
                    t[:part.shape[0], :part.shape[1]] = part
                    chunks.append(chunk_bytes(t, tw))
    entries = {
        256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp),
        259: (3, [compression]),
        262: (3, [photometric if photometric is not None
                  else (1 if spp < 3 else 2)]),
        277: (3, [spp]), 284: (3, [planar]),
    }
    if predictor != 1:
        entries[317] = (3, [predictor])
    if orientation is not None:
        entries[274] = (3, [orientation])
    if extra_samples is not None:
        entries[338] = (3, [extra_samples])
    if tile is None:
        entries[278] = (4, [rows_per_strip or h])
    else:
        entries[322], entries[323] = (3, [tile[1]]), (3, [tile[0]])
    entries.update(tags or {})
    # layout: header, pixel data, then each page's IFD and its arrays
    data = bytearray(struct.pack(end + '2sHI', order.encode(), 42, 0))
    offsets = []
    for c in chunks:
        offsets.append(len(data))
        data += c
        if len(data) % 2:
            data += b'\0'
    counts = [len(c) for c in chunks]
    off_tag, cnt_tag = (324, 325) if tile is not None else (273, 279)
    entries[off_tag], entries[cnt_tag] = (4, offsets), (4, counts)
    ifd_at = []
    for _ in range(pages):
        ifd_at.append(len(data))
        n = len(entries)
        body = bytearray()
        blob_at = len(data) + 2 + 12 * n + 4
        blobs = bytearray()
        for tag in sorted(entries):
            typ, values = entries[tag]
            fmt, size = _TYPES[typ]
            if typ == 2:
                raw = bytes(values) + b'\0'
                count = len(raw)
            elif typ == 5:
                raw = b''.join(struct.pack(end + 'II', *v) for v in values)
                count = len(values)
            else:
                raw = struct.pack(end + fmt * len(values), *values)
                count = len(values)
            if len(raw) <= 4:
                field = raw.ljust(4, b'\0')
            else:
                field = struct.pack(end + 'I', blob_at + len(blobs))
                blobs += raw
                if len(blobs) % 2:
                    blobs += b'\0'
            body += struct.pack(end + 'HHI', tag, typ, count) + field
        data += struct.pack(end + 'H', n) + body + b'\0\0\0\0' + blobs
    struct.pack_into(end + 'I', data, 4, ifd_at[0])
    for a, b in zip(ifd_at, ifd_at[1:]):
        n = struct.unpack_from(end + 'H', data, a)[0]
        struct.pack_into(end + 'I', data, a + 2 + 12 * n, b)
    return bytes(data)


def samples(rng, h, w, ch, bits):
    """Random samples (h, w[, ch]) of ``bits`` 8 or 16, with runs (so that
    PackBits and LZW both meet repeats and literals)."""
    top = 1 << bits
    dt = np.uint8 if bits == 8 else np.uint16
    img = rng.integers(0, top, (h, w, ch)).astype(dt)
    img[:, w // 3: w // 2] = img[:, w // 3: w // 3 + 1]
    return img if ch > 1 else img[..., 0]


# cv2-written files: name -> (H, W, channels, bits, compression)
CV2_FILES = {
    'cv2_rgb8_lzw': (23, 37, 3, 8, 5),
    'cv2_rgb8_none': (17, 29, 3, 8, 1),
    'cv2_rgb8_deflate': (19, 31, 3, 8, 8),
    'cv2_rgb8_adobe': (21, 26, 3, 8, 32946),
    'cv2_rgb8_packbits': (18, 40, 3, 8, 32773),
    'cv2_gray8_lzw': (25, 33, 1, 8, 5),
    'cv2_gray8_packbits': (14, 22, 1, 8, 32773),
    'cv2_rgba8_lzw': (16, 21, 4, 8, 5),
    'cv2_rgba8_deflate': (13, 19, 4, 8, 8),
    'cv2_rgb16_lzw': (15, 27, 3, 16, 5),
    'cv2_rgb16_deflate': (12, 17, 3, 16, 8),
    'cv2_gray16_lzw': (19, 23, 1, 16, 5),
    'cv2_rgba16_none': (11, 14, 4, 16, 1),
    'cv2_rgb8_strips_lzw': (48, 400, 3, 8, 5),    # 8 strips of 6 rows
}

# hand-built files: name -> (H, W, channels, bits, write_tiff keywords)
HAND_FILES = {
    'tiles_rgb8_lzw_pred': (37, 45, 3, 8, dict(compression=5, predictor=2,
                                               tile=(16, 32))),
    # whole tiles: cv2 drops pixels of a partial 16-bit gray tile
    'tiles_gray16_deflate': (32, 48, 1, 16, dict(compression=8,
                                                 tile=(16, 16))),
    'tiles_rgba8_adobe': (20, 35, 4, 8, dict(compression=32946,
                                             tile=(16, 16),
                                             extra_samples=2)),
    'mm_rgb16_lzw_pred': (13, 22, 3, 16, dict(order='MM', compression=5,
                                              predictor=2,
                                              rows_per_strip=4)),
    'mm_rgb8_packbits': (15, 19, 3, 8, dict(order='MM', compression=32773,
                                            rows_per_strip=5)),
    'mm_gray8_deflate_pred': (12, 25, 1, 8, dict(order='MM', compression=8,
                                                 predictor=2)),
    'planar2_rgb8_lzw': (14, 27, 3, 8, dict(planar=2, compression=5,
                                            rows_per_strip=6)),
    'planar2_rgb16_deflate_pred': (11, 16, 3, 16, dict(
        planar=2, compression=32946, predictor=2, rows_per_strip=4)),
    'planar2_tiles_rgb8': (18, 33, 3, 8, dict(planar=2, compression=8,
                                              tile=(16, 16))),
    'lzw_compat_rgb8': (16, 23, 3, 8, dict(compression=5, lzw_compat=True,
                                           rows_per_strip=7)),
    'rgba8_assoc': (9, 13, 4, 8, dict(extra_samples=1)),
    'rgba8_unspecified': (9, 13, 4, 8, dict(extra_samples=0)),
}
# tag 274 at 6 x 9 (cv2.imread refuses 5-8 on a frame that is not square;
# cv2.imdecode turns it) and at 8 x 8 (both read it)
ORIENTED = {f'orient{o}_rgb8': o for o in range(1, 9)}
ORIENTED_16 = {f'orient{o}_rgb16': o for o in (3, 6)}
ORIENTED_SQUARE = {f'orient{o}_square_rgb8': o for o in range(5, 9)}


def main(out):
    import cv2
    os.makedirs(out, exist_ok=True)
    rng = np.random.default_rng(2027)
    for name, (h, w, ch, bits, comp) in CV2_FILES.items():
        img = samples(rng, h, w, ch, bits)
        if ch >= 3:                       # cv2 takes BGR[A]
            img = img[..., [2, 1, 0] + ([3] if ch == 4 else [])]
        path = os.path.join(out, f'{name}.tif')
        if not cv2.imwrite(path, img, [cv2.IMWRITE_TIFF_COMPRESSION, comp]):
            raise IOError(f'cv2 could not write {path}')
    for name, (h, w, ch, bits, kw) in HAND_FILES.items():
        with open(os.path.join(out, f'{name}.tif'), 'wb') as f:
            f.write(write_tiff(samples(rng, h, w, ch, bits), **kw))
    for table, bits, (h, w) in ((ORIENTED, 8, (6, 9)),
                                (ORIENTED_16, 16, (6, 9)),
                                (ORIENTED_SQUARE, 8, (8, 8))):
        for name, o in table.items():
            img = samples(rng, h, w, 3, bits)
            with open(os.path.join(out, f'{name}.tif'), 'wb') as f:
                f.write(write_tiff(img, orientation=o, compression=5,
                                   predictor=2))


if __name__ == '__main__':
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--out', default=os.path.join(ROOT, 'tests', 'fixtures',
                                                 'tiff'))
    main(p.parse_args().out)
