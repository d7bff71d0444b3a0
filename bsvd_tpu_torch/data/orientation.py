"""EXIF orientation as cv2 5.0 reads and applies it, with no image
library: the JAX package reads frames through ``cv2.imread`` /
``cv2.imdecode``, which turn an image by its orientation tag (IMREAD_COLOR
and IMREAD_GRAYSCALE; not IMREAD_UNCHANGED), while its native decoder and
its train loader keep the stored pixels. The port's readers keep the
stored pixels; the cv2 routes (``data/utils_common.open_image``,
``open_sequence`` in gray or expand mode, ``utils/img_util.imfrombytes``
in colour or gray, ``imsize``) turn them here.

Where the tag is (found against cv2 5.0):

- JPEG: the first APP1 segment before SOS whose data start with
  ``Exif\\0\\0``; a TIFF structure follows;
- PNG: the first ``eXIf`` chunk, anywhere before IEND, holding the TIFF
  structure itself (it must start with ``II`` or ``MM``, else libpng drops
  it);
- TIFF: the file is the TIFF structure, its IFD0's tag 274 read by the
  same walk (cv2 turns a TIFF in every mode, IMREAD_UNCHANGED too);
- BMP: none.

The TIFF walk is cv2's ``ExifReader``: byte order ``II`` (little endian),
anything else big endian; the mark 42; IFD0 at the offset in bytes 4-8;
its entries read in order, the value of tag 0x0112 the 16-bit word at the
entry's byte 8 whatever its type, the first such entry kept. cv2 also
reads the values of some other tags (``_WORDS``, ``_STRINGS``,
``_RATIONALS``), and a read past the end, in any of them or in an entry,
stops the walk and keeps what it found: so malformed or truncated Exif
reads as orientation 1 (unless a whole 0x0112 entry came before the
fault), and values outside 1-8 leave the image as it is.
"""

import io
import struct

import numpy as np

EXIF_PREFIX = b'Exif\0\0'
ORIENTATION_TAG = 0x0112
_PNG_SIGNATURE = b'\x89PNG\r\n\x1a\n'
# JPEG markers with no length field: TEM, RST0-7, SOI
_STANDALONE = frozenset([0x01, 0xD8] + list(range(0xD0, 0xD8)))
_SOS, _EOI, _APP1 = 0xDA, 0xD9, 0xE1
# IFD0 tags whose values cv2's ExifReader reads (found against cv2 5.0):
# a 16-bit word at the entry's byte 8 (orientation, resolution unit,
# YCbCr positioning); a string of the count at byte 4, at the offset at
# byte 8 when longer than 4 bytes, else at byte 8 of the TIFF data
# (description, make, model, software, date, copyright); n unsigned
# rationals at the offset at byte 8 (resolutions, white point,
# chromaticities, YCbCr coefficients, reference black / white)
_WORDS = frozenset((ORIENTATION_TAG, 0x0128, 0x0213))
_STRINGS = frozenset((0x010E, 0x010F, 0x0110, 0x0131, 0x0132, 0x8298))
_RATIONALS = {0x011A: 1, 0x011B: 1, 0x013E: 2, 0x013F: 6, 0x0211: 3,
              0x0214: 6}


def tiff_orientation(tiff):
    """The orientation (1-8; other values as stored) in a TIFF structure's
    IFD0, read as cv2's ExifReader reads it; 1 where it has none."""
    tiff = bytes(tiff)
    end = '<' if tiff[:2] == b'II' else '>'

    def read(fmt, off):
        if off + struct.calcsize(fmt) > len(tiff):
            raise IndexError(off)
        return struct.unpack_from(end + fmt, tiff, off)[0]

    found = None
    try:
        if read('H', 2) != 42:
            return 1
        off = read('I', 4)
        for i in range(read('H', off)):
            entry = off + 2 + 12 * i
            tag = read('H', entry)
            if tag in _WORDS:
                value = read('H', entry + 8)
                if tag == ORIENTATION_TAG and found is None:
                    found = value
            elif tag in _STRINGS:
                size = read('I', entry + 4)
                start = read('I', entry + 8) if size > 4 else 8
                if start + size > len(tiff):
                    raise IndexError(start)
            elif tag in _RATIONALS:
                read('I', read('I', entry + 8) + 8 * _RATIONALS[tag] - 4)
    except IndexError:
        pass
    return 1 if found is None else found


def _read(f, n):
    data = f.read(n)
    if len(data) != n:
        raise EOFError
    return data


def _jpeg_exif(f):
    """The TIFF data of a JPEG stream's first ``Exif`` APP1 segment, or
    None (``f`` just past SOI)."""
    while True:
        if _read(f, 1) != b'\xff':
            return None
        marker = _read(f, 1)[0]
        while marker == 0xFF:                 # fill bytes
            marker = _read(f, 1)[0]
        if marker in _STANDALONE:
            continue
        if marker in (_SOS, _EOI):
            return None
        length = struct.unpack('>H', _read(f, 2))[0]
        if length < 2:
            return None
        if marker == _APP1:
            data = f.read(length - 2)
            if data.startswith(EXIF_PREFIX):
                return data[len(EXIF_PREFIX):]
        else:
            f.seek(length - 2, io.SEEK_CUR)


def _png_exif(f):
    """The data of a PNG stream's first ``eXIf`` chunk, or None (``f``
    just past the signature); the pixel data are skipped, not read."""
    while True:
        length, ctype = struct.unpack('>I4s', _read(f, 8))
        if ctype == b'eXIf':
            data = f.read(length)
            return data if data[:2] in (b'II', b'MM') else None
        if ctype == b'IEND':
            return None
        f.seek(length + 4, io.SEEK_CUR)


def stream_orientation(f):
    """The orientation of the image file open as ``f`` (at its start): 1
    for BMP and for files with no (readable) tag."""
    try:
        head = f.read(8)
        if head[:4] in (b'II*\0', b'MM\0*'):
            return tiff_orientation(head + f.read())
        if head[:2] == b'\xff\xd8':
            f.seek(2)
            tiff = _jpeg_exif(f)
        elif head == _PNG_SIGNATURE:
            tiff = _png_exif(f)
        else:
            return 1
    except (EOFError, struct.error):
        return 1
    return 1 if tiff is None else tiff_orientation(tiff)


def file_orientation(path):
    """The orientation of an image file."""
    with open(path, 'rb') as f:
        return stream_orientation(f)


def buffer_orientation(data):
    """The orientation of an image file's bytes."""
    return stream_orientation(io.BytesIO(bytes(data)))


def orient(img, orientation):
    """An (H, W) or (H, W, C) image turned as cv2's ``ExifTransform``
    turns it: 2 flips left-right, 3 both ways, 4 up-down; 5 transposes,
    6 transposes and flips left-right, 7 transposes and flips both ways,
    8 transposes and flips up-down; other values leave it. Returns a
    contiguous array (the input itself for 1)."""
    if orientation not in range(2, 9):
        return img
    if orientation >= 5:
        img = np.swapaxes(img, 0, 1)
    if orientation in (2, 3, 6, 7):
        img = img[:, ::-1]
    if orientation in (3, 4, 7, 8):
        img = img[::-1]
    return np.ascontiguousarray(img)


def oriented_dims(h, w, orientation):
    """The (H, W) of an (h, w) image once ``orient`` has turned it."""
    return (w, h) if orientation in range(5, 9) else (h, w)
