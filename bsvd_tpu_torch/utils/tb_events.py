"""TensorBoard event files with no package: the TFRecord framing (masked
CRC-32C), hand-encoded ``Event`` / ``Summary`` protobuf messages, and a
reader that checks every CRC.

A scalar is written as the JAX package's ``tf.summary.scalar`` writes it
(bsvd_tpu/utils/logger.py ``TBLogger``): a ``tensor`` of dtype DT_FLOAT
with an empty shape and its 4 little-endian bytes in ``tensor_content``,
and metadata ``plugin_data { plugin_name: "scalars" }``. TensorBoard's
``EventAccumulator`` files such values under ``tensors``. The file's
first record carries ``file_version: "brain.Event:2"`` and a
``source_metadata`` writer; its name is
``events.out.tfevents.<time>.<host>.<pid>.<n>.v2``.
"""

import glob
import itertools
import os
import socket
import struct
import threading
import time

FILE_VERSION = b'brain.Event:2'
WRITER = b'bsvd_tpu_torch.utils.tb_events'
PLUGIN = b'scalars'
DT_FLOAT = 1
_MASK_DELTA = 0xA282EAD8
_files = itertools.count()
_files_lock = threading.Lock()


def _crc_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc_table()


def crc32c(data):
    """CRC-32C (Castagnoli) of bytes, as TFRecord frames use it."""
    c = 0xFFFFFFFF
    for b in data:
        c = _CRC_TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def masked_crc(data):
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + _MASK_DELTA) & 0xFFFFFFFF


def frame(record):
    """One TFRecord: length, its masked CRC, the data, its masked CRC."""
    head = struct.pack('<Q', len(record))
    return (head + struct.pack('<I', masked_crc(head)) + record
            + struct.pack('<I', masked_crc(record)))


# ---------------------------------------------------------------------------
# protobuf encoding: (field number, wire type) keys, varints, lengths
# ---------------------------------------------------------------------------

def _varint(v):
    v &= 0xFFFFFFFFFFFFFFFF
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field, wire):
    return _varint(field << 3 | wire)


def _bytes(field, data):
    return _key(field, 2) + _varint(len(data)) + data


def _double(field, v):
    return _key(field, 1) + struct.pack('<d', v)


def _int(field, v):
    return _key(field, 0) + _varint(v) if v else b''


def scalar_event(tag, value, step, wall_time):
    """Event bytes of one scalar, in the field order tf.summary writes."""
    tensor = (_int(1, DT_FLOAT) + _bytes(2, b'')
              + _bytes(4, struct.pack('<f', value)))
    metadata = _bytes(1, _bytes(1, PLUGIN))
    summary_value = (_bytes(1, tag.encode()) + _bytes(8, tensor)
                     + _bytes(9, metadata))
    return (_double(1, wall_time) + _int(2, step)
            + _bytes(5, _bytes(1, summary_value)))


def version_event(wall_time):
    """The first record of a file."""
    return (_double(1, wall_time) + _bytes(3, FILE_VERSION)
            + _bytes(10, _bytes(1, WRITER)))


class EventWriter:
    """Appends scalar events to a new event file under ``log_dir``."""

    def __init__(self, log_dir):
        os.makedirs(log_dir, exist_ok=True)
        with _files_lock:
            n = next(_files)
        now = time.time()
        self.path = os.path.join(
            log_dir, f'events.out.tfevents.{int(now)}.{socket.gethostname()}'
                     f'.{os.getpid()}.{n}.v2')
        self._f = open(self.path, 'wb')
        self._f.write(frame(version_event(now)))
        self._f.flush()

    def add_scalar(self, tag, value, step):
        self._f.write(frame(scalar_event(tag, float(value), int(step),
                                         time.time())))
        self._f.flush()

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------

def _fields(data):
    """(field, wire, value) of a message: ints for varints, bytes for
    lengths and fixed widths."""
    pos = 0
    while pos < len(data):
        key, pos = _read_varint(data, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, pos = _read_varint(data, pos)
        elif wire == 1:
            v, pos = data[pos:pos + 8], pos + 8
        elif wire == 2:
            n, pos = _read_varint(data, pos)
            v, pos = data[pos:pos + n], pos + n
        elif wire == 5:
            v, pos = data[pos:pos + 4], pos + 4
        else:
            raise IOError(f'protobuf wire type {wire} not read')
        yield field, wire, v


def _read_varint(data, pos):
    shift = v = 0
    while True:
        if pos >= len(data):
            raise IOError('truncated protobuf varint')
        b = data[pos]
        pos += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, pos
        shift += 7


def records(path):
    """The records of a TFRecord file; raises IOError on a bad CRC or a
    truncated record."""
    with open(path, 'rb') as f:
        data = f.read()
    pos, out = 0, []
    while pos < len(data):
        if pos + 12 > len(data):
            raise IOError(f'{path}: truncated record header at {pos}')
        head = data[pos:pos + 8]
        (n,), (crc,) = struct.unpack('<Q', head), struct.unpack_from(
            '<I', data, pos + 8)
        if masked_crc(head) != crc:
            raise IOError(f'{path}: bad length CRC at {pos}')
        rec = data[pos + 12:pos + 12 + n]
        if len(rec) < n or pos + 16 + n > len(data):
            raise IOError(f'{path}: truncated record at {pos}')
        if masked_crc(rec) != struct.unpack_from('<I', data, pos + 12 + n)[0]:
            raise IOError(f'{path}: bad data CRC at {pos}')
        out.append(rec)
        pos += 16 + n
    return out


def _value(msg):
    """(tag, float) of a Summary.Value: its tensor (DT_FLOAT) or its
    simple_value; None where it holds neither."""
    tag, val = None, None
    for field, _, v in _fields(msg):
        if field == 1:
            tag = v.decode()
        elif field == 2:
            val = struct.unpack('<f', v)[0]
        elif field == 8:
            t = dict((f, x) for f, _, x in _fields(v))
            if t.get(1) == DT_FLOAT and len(t.get(4, b'')) == 4:
                val = struct.unpack('<f', t[4])[0]
    return None if val is None else (tag, val)


def read_scalars(path):
    """``(wall_time, step, tag, value)`` of every scalar in an event file,
    each record's CRCs checked."""
    out = []
    for rec in records(path):
        wall, step, values = 0.0, 0, []
        for field, _, v in _fields(rec):
            if field == 1:
                wall = struct.unpack('<d', v)[0]
            elif field == 2:
                step = v - (1 << 64) if v >> 63 else v
            elif field == 5:
                values += [x for f, _, m in _fields(v) if f == 1
                           for x in [_value(m)] if x is not None]
        out += [(wall, step, tag, val) for tag, val in values]
    return out


def read_dir(log_dir):
    """The scalars of every event file under ``log_dir``, file by file in
    name order."""
    out = []
    for path in sorted(glob.glob(os.path.join(log_dir,
                                              'events.out.tfevents.*'))):
        out += read_scalars(path)
    return out
