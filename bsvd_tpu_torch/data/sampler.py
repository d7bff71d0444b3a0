"""The sampler and batch loader of map-style datasets (counterpart of
bsvd_tpu/data/sampler.py).

``EnlargedSampler``: an epoch-seeded permutation (numpy's
``default_rng(epoch)``, as the JAX package draws it, so the indices are
equal), virtually enlarged by ``ratio``; ``num_replicas`` / ``rank`` take
every n-th index.

``BatchLoader``: a producer thread reads the sampler's indices, calls
``dataset[i]`` and stacks each batch's arrays (numpy; other values become
lists) into a bounded queue. Items are read one after another on that
thread unless the dataset sets ``supports_parallel_read`` and
``num_workers`` > 1 (then a thread pool reads each batch's items): a
dataset that draws from one shared RNG must read serially to stay
reproducible. Errors of the dataset are raised in the consumer.

On ``num_ranks`` ranks each batch of ``batch_size`` indices is the global
batch, and the loader of ``rank`` reads its own block of
``batch_size // num_ranks`` rows only. The other rows are passed to the
dataset's ``skip(i)`` where it has one, in batch order: a dataset whose
items draw from one shared RNG makes item i's draws there without reading
it, so the rows read are those of the global batch bit for bit."""

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np


class EnlargedSampler:

    def __init__(self, dataset, num_replicas=1, rank=0, ratio=1):
        self.dataset = dataset
        self.num_replicas = num_replicas
        self.rank = rank
        self.epoch = 0
        self.num_samples = int(np.ceil(len(dataset) * ratio / num_replicas))
        self.total_size = self.num_samples * self.num_replicas

    def __iter__(self):
        rng = np.random.default_rng(self.epoch)
        indices = []
        dataset_size = len(self.dataset)
        while len(indices) < self.total_size:
            indices.extend(rng.permutation(self.total_size).tolist())
        indices = [i % dataset_size for i in indices[:self.total_size]]
        indices = indices[self.rank:self.total_size:self.num_replicas]
        return iter(indices[:self.num_samples])

    def __len__(self):
        return self.num_samples

    def set_epoch(self, epoch):
        self.epoch = epoch


class BatchLoader:
    """Batches of a map-style dataset by the sampler's indices (or in
    order, shuffled by ``seed`` + epoch with ``shuffle``); each pass is one
    epoch, after which the sampler's epoch advances."""

    def __init__(self, dataset, batch_size, sampler=None, shuffle=False,
                 num_workers=4, drop_last=True, prefetch=4, seed=None,
                 rank=0, num_ranks=1):
        if batch_size % num_ranks or not 0 <= rank < num_ranks:
            raise ValueError(f'BatchLoader: rank {rank} of {num_ranks} in a '
                             f'global batch of {batch_size}')
        self.rank, self.num_ranks = rank, num_ranks
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.seed = seed
        self.epoch = 0

    def __len__(self):
        n = len(self.sampler) if self.sampler is not None else \
            len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _indices(self):
        if self.sampler is not None:
            return list(iter(self.sampler))
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng((self.seed or 0) + self.epoch).shuffle(idx)
        return idx.tolist()

    def __iter__(self):
        indices = self._indices()
        bs = self.batch_size
        if self.drop_last:
            indices = indices[:len(indices) // bs * bs]
        n_batches = (len(indices) + bs - 1) // bs
        out_q = queue.Queue(maxsize=self.prefetch)
        parallel = (self.num_workers > 1
                    and getattr(self.dataset, 'supports_parallel_read',
                                False))
        pool = ThreadPoolExecutor(self.num_workers) if parallel else None
        stop = threading.Event()
        rows = bs // self.num_ranks
        lo, hi = self.rank * rows, (self.rank + 1) * rows
        skip = getattr(self.dataset, 'skip', lambda i: None)

        def put(item):
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for b in range(n_batches):
                    chunk = indices[b * bs:(b + 1) * bs]
                    for i in chunk[:lo]:
                        skip(i)
                    own = chunk[lo:hi]
                    samples = (list(pool.map(self.dataset.__getitem__, own))
                               if pool is not None
                               else [self.dataset[i] for i in own])
                    for i in chunk[hi:]:
                        skip(i)
                    batch = {}
                    for key in samples[0]:
                        vals = [s[key] for s in samples]
                        batch[key] = (np.stack(vals)
                                      if isinstance(vals[0], np.ndarray)
                                      else vals)
                    if not put(batch):
                        return
                put(None)
            except BaseException as e:   # noqa: BLE001 — raised below
                put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            t.join()
            if pool is not None:
                pool.shutdown(wait=False)
        self.epoch += 1
        if self.sampler is not None:
            self.sampler.set_epoch(self.epoch)
