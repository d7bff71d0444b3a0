"""Storage backends of the datasets' file reads (counterpart of
bsvd_tpu/utils/file_client.py): ``FileClient`` in front of a backend by
name. The port reads from disk; the ``lmdb`` and ``memcached`` backends
raise NotImplementedError (ROADMAP.md Queue 1, the zoo's lmdb slice)."""

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


class _NotPorted(BaseStorageBackend):
    name = None

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            f'FileClient backend {self.name!r} is not ported (ROADMAP.md '
            f'Queue 1: lmdb with utils/lmdb_util and _lmdb_compat)')

    def get(self, filepath):
        raise NotImplementedError

    def get_text(self, filepath):
        raise NotImplementedError


class LmdbBackend(_NotPorted):
    name = 'lmdb'


class MemcachedBackend(_NotPorted):
    name = 'memcached'


class FileClient:
    """A storage backend by name: 'disk' (also 'lmdb' and 'memcached',
    which raise)."""

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
