"""The record-log store the lmdb tooling writes where the ``lmdb`` package
is missing (counterpart of bsvd_tpu/utils/_lmdb_compat.py, the same bytes
on disk): the small part of the ``lmdb`` package's API that
``utils/lmdb_util`` and the FileClient's lmdb backend call.

When the real ``lmdb`` package imports, those callers use it instead. The
file is not an LMDB B-tree but an append-only log::

    <name>.lmdb/data.mdb = b'BSVDKV01' then, per put,
                           [u32 klen][key][u64 vlen][value]  (little-endian)

beside BasicSR's ``meta_info.txt``. The same puts in the same order give
the same ``data.mdb`` as the JAX package's, so a store written by either
package reads in the other. A real LMDB file does not open here (its
first bytes are not the magic: ValueError naming the ``lmdb`` package),
and a readonly open of a missing store creates nothing
(FileNotFoundError), as real lmdb does.
"""

import io
import os
import struct
import threading

_MAGIC = b'BSVDKV01'


class _Txn:
    """A transaction: puts buffered until ``commit``, reads straight from
    the store; ``with env.begin() as txn`` commits on a clean exit."""

    def __init__(self, env, write):
        self._env = env
        self._write = write
        self._pending = []

    def put(self, key, value):
        assert self._write, 'read-only transaction'
        self._pending.append((bytes(key), bytes(value)))
        return True

    def get(self, key):
        return self._env._get(bytes(key))

    def commit(self):
        if self._write and self._pending:
            self._env._append(self._pending)
            self._pending = []

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.commit()
        return False


class Environment:
    """One store: the index of every key's (offset, length) in
    ``data.mdb``, read when it opens; a later put of a key wins."""

    def __init__(self, path, readonly=False):
        self.path = path
        self.readonly = readonly
        self._lock = threading.Lock()
        self._data_path = os.path.join(path, 'data.mdb')
        self._index = {}
        if os.path.exists(self._data_path):
            self._load_index()
        elif readonly:
            raise FileNotFoundError(f'no data.mdb under {path}')
        else:
            os.makedirs(path, exist_ok=True)
            with io.open(self._data_path, 'wb') as f:
                f.write(_MAGIC)

    def _load_index(self):
        with io.open(self._data_path, 'rb') as f:
            if f.read(len(_MAGIC)) != _MAGIC:
                raise ValueError(
                    f'{self._data_path} is not a bsvd-kv log (a real LMDB '
                    'file? install the lmdb package to read it)')
            while True:
                hdr = f.read(4)
                if len(hdr) < 4:
                    break
                key = f.read(struct.unpack('<I', hdr)[0])
                vlen = struct.unpack('<Q', f.read(8))[0]
                self._index[key] = (f.tell(), vlen)
                f.seek(vlen, os.SEEK_CUR)

    def _append(self, items):
        with self._lock, io.open(self._data_path, 'ab') as f:
            for key, value in items:
                f.write(struct.pack('<I', len(key)) + key
                        + struct.pack('<Q', len(value)))
                self._index[key] = (f.tell(), len(value))
                f.write(value)

    def _get(self, key):
        entry = self._index.get(key)
        if entry is None:
            return None
        off, vlen = entry
        with self._lock, io.open(self._data_path, 'rb') as f:
            f.seek(off)
            return f.read(vlen)

    def begin(self, write=False):
        if write and self.readonly:
            raise PermissionError('environment opened readonly')
        return _Txn(self, write)

    def stat(self):
        return {'entries': len(self._index)}

    def close(self):
        pass


def open(path, map_size=None, readonly=False, lock=False, readahead=False,
         **kwargs):  # noqa: A001 - the lmdb package's name
    """``lmdb.open``'s signature; only ``path`` and ``readonly`` act."""
    del map_size, lock, readahead, kwargs
    return Environment(path, readonly=readonly)
