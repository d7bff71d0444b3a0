"""Storage backends of the datasets' file reads (counterpart of
bsvd_tpu/utils/file_client.py): ``FileClient`` in front of a backend by
name, 'disk', 'lmdb' or 'memcached'."""

import os
import socket
from abc import ABCMeta, abstractmethod


class BaseStorageBackend(metaclass=ABCMeta):

    @abstractmethod
    def get(self, filepath):
        pass

    @abstractmethod
    def get_text(self, filepath):
        pass


class HardDiskBackend(BaseStorageBackend):
    """Whole files from the local file system."""

    def get(self, filepath):
        with open(str(filepath), 'rb') as f:
            return f.read()

    def get_text(self, filepath):
        with open(str(filepath), 'r') as f:
            return f.read()


class LmdbBackend(BaseStorageBackend):
    """Values by key from one or more lmdb stores, each opened under its
    client key (``db_paths`` and ``client_keys``, a path and 'default' by
    default), through the ``lmdb`` package where it imports, else the
    port's record log (``utils/lmdb_util.lmdb_package``); ``readonly``,
    ``lock``, ``readahead`` and the rest go to its ``open``. Keys are
    ASCII; a missing key gives None. Nothing is read from disk in place
    of a store."""

    def __init__(self, db_paths, client_keys='default', readonly=True,
                 lock=False, readahead=False, **kwargs):
        from bsvd_tpu_torch.utils.lmdb_util import lmdb_package
        lmdb = lmdb_package()
        if isinstance(client_keys, str):
            client_keys = [client_keys]
        if isinstance(db_paths, list):
            self.db_paths = [str(v) for v in db_paths]
        else:
            self.db_paths = [str(db_paths)]
        assert len(client_keys) == len(self.db_paths)
        self._client = {}
        for client, path in zip(client_keys, self.db_paths):
            self._client[client] = lmdb.open(path, readonly=readonly,
                                             lock=lock, readahead=readahead,
                                             **kwargs)

    def get(self, filepath, client_key='default'):
        assert client_key in self._client, \
            f'client_key {client_key} not in lmdb clients'
        with self._client[client_key].begin(write=False) as txn:
            return txn.get(str(filepath).encode('ascii'))

    def get_text(self, filepath):
        raise NotImplementedError


class MemcachedBackend(BaseStorageBackend):
    """Values from a memcached server on its text protocol over a socket
    (no client package). ``server_list_cfg``: ``host:port``, or the path
    of a file whose first line that is neither blank nor a ``#`` comment
    is ``host:port`` (mmcv's server-list file); ``client_cfg`` and
    ``sys_path`` are taken for the signature and unused. A miss (``END``)
    gives None; a key with whitespace or over 250 bytes raises
    ValueError; an error reply (``ERROR``, ``CLIENT_ERROR``,
    ``SERVER_ERROR``, anything not ``VALUE``) drops the connection and
    raises ConnectionError, as does a connection closed mid-reply."""

    def __init__(self, server_list_cfg, client_cfg=None, sys_path=None):
        del client_cfg, sys_path
        addr = server_list_cfg
        if isinstance(addr, str) and os.path.exists(addr):
            with open(addr) as f:
                addr = [ln.strip() for ln in f
                        if ln.strip() and not ln.startswith('#')][0]
        host, _, port = str(addr).rpartition(':')
        self._addr = (host or 'localhost', int(port))
        self._sock = None

    def _connect(self):
        if self._sock is None:
            self._sock = socket.create_connection(self._addr, timeout=10)
        return self._sock

    @staticmethod
    def _readline(sock):
        buf = b''
        while not buf.endswith(b'\r\n'):
            ch = sock.recv(1)
            if not ch:
                raise ConnectionError('memcached connection closed')
            buf += ch
        return buf[:-2]

    def get(self, filepath):
        key = str(filepath)
        if ' ' in key or '\r' in key or '\n' in key or len(key) > 250:
            raise ValueError(f'invalid memcached key: {key!r} (no '
                             'whitespace/control chars, max 250 bytes)')
        sock = self._connect()
        sock.sendall(f'get {key}\r\n'.encode())
        header = self._readline(sock)
        if header == b'END':
            return None
        parts = header.split()
        if not parts or parts[0] != b'VALUE' or len(parts) < 4:
            self._sock.close()
            self._sock = None
            raise ConnectionError(f'memcached error for key {key!r}: '
                                  f'{header.decode(errors="replace")}')
        nbytes = int(parts[3])
        data = b''
        while len(data) < nbytes:
            chunk = sock.recv(nbytes - len(data))
            if not chunk:
                raise ConnectionError('memcached connection closed '
                                      'mid-value')
            data += chunk
        assert self._readline(sock) == b''        # the value's CRLF
        assert self._readline(sock) == b'END'
        return data

    def get_text(self, filepath):
        value = self.get(filepath)
        return None if value is None else value.decode()


class FileClient:
    """A storage backend by name: 'disk', 'lmdb' or 'memcached'; the
    keyword arguments go to the backend."""

    _backends = {
        'disk': HardDiskBackend,
        'lmdb': LmdbBackend,
        'memcached': MemcachedBackend,
    }

    def __init__(self, backend='disk', **kwargs):
        if backend not in self._backends:
            raise ValueError(f'Backend {backend} is not supported. '
                             f'Currently supported ones are '
                             f'{list(self._backends)}')
        self.backend = backend
        self.client = self._backends[backend](**kwargs)

    def get(self, filepath, client_key='default'):
        if self.backend == 'lmdb':
            return self.client.get(filepath, client_key)
        return self.client.get(filepath)

    def get_text(self, filepath):
        return self.client.get_text(filepath)
