"""Orientation-tagged files for the orientation tests: a TIFF structure
holding IFD0 entries, put into a JPEG as an APP1 ``Exif`` segment after
SOI or into a PNG as an ``eXIf`` chunk after IHDR (or before IEND)."""

import struct
import zlib

ORIENTATION = 0x0112


def tiff(orientation=1, order='II', entries=None, count=None):
    """TIFF bytes: header (``order`` II or MM, mark 42, IFD0 at 8), IFD0
    with ``entries`` ((tag, type, count, 16-bit value) each; by default
    one SHORT orientation entry), the entry count ``count`` (default
    their number), a zero next-IFD offset."""
    end = '<' if order == 'II' else '>'
    if entries is None:
        entries = [(ORIENTATION, 3, 1, orientation)]
    body = struct.pack(end + 'H', len(entries) if count is None else count)
    for tag, typ, cnt, val in entries:
        body += struct.pack(end + 'HHIH', tag, typ, cnt, val) + b'\0\0'
    return (order.encode() + struct.pack(end + 'HI', 42, 8) + body
            + b'\0\0\0\0')


def jpeg_with(jpeg, data, prefix=b'Exif\0\0'):
    """``jpeg`` with an APP1 segment of ``prefix + data`` after SOI."""
    seg = prefix + data
    return (jpeg[:2] + b'\xff\xe1' + struct.pack('>H', len(seg) + 2) + seg
            + jpeg[2:])


def png_with(png, data, after_idat=False):
    """``png`` with an ``eXIf`` chunk of ``data`` after IHDR, or just
    before IEND with ``after_idat``."""
    chunk = (struct.pack('>I', len(data)) + b'eXIf' + data
             + struct.pack('>I', zlib.crc32(b'eXIf' + data)))
    at = png.rfind(b'IEND') - 4 if after_idat else 33
    return png[:at] + chunk + png[at:]
