"""The datasets and loaders of the port (counterpart of bsvd_tpu/data/
__init__.py): every ``*_dataset`` / ``*_loader`` module registers itself,
``build_dataset`` makes one from its options, ``build_dataloader`` wraps
it for its phase."""

import importlib
import pkgutil

from bsvd_tpu_torch.utils.registry import DATASET_REGISTRY

for _m in pkgutil.iter_modules(__path__):
    if _m.name.endswith('_dataset') or _m.name.endswith('_loader'):
        importlib.import_module(f'bsvd_tpu_torch.data.{_m.name}')


def build_dataset(dataset_opt):
    """A registered dataset from its options dict (``type``)."""
    dataset_opt = dict(dataset_opt)
    return DATASET_REGISTRY.get(dataset_opt['type'])(dataset_opt)


class SimpleLoader:
    """Sequential loader over an indexable dataset (validation indexes the
    dataset itself; this carries it through the pipeline)."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self):
        return len(self.dataset)

    def __iter__(self):
        for i in range(len(self.dataset)):
            yield self.dataset[i]


def build_dataloader(dataset, dataset_opt, num_gpu=1, dist=False,
                     sampler=None, seed=None):
    """The loader of a phase (bsvd_tpu/data/__init__.py:41):

    - a self-iterating train loader (the video loader) passes through;
      with ``dist`` it must have been made for this rank (``num_devices``
      and ``rank`` in its options: its batches are this rank's rows of the
      global batch); a ``sampler`` raises, it takes none;
    - a map-style train dataset gets a ``BatchLoader`` of the global batch
      (``batch_size_per_gpu`` x ``num_gpu``) over ``sampler``, by default
      an ``EnlargedSampler`` by ``dataset_enlarge_ratio``, with
      ``num_worker_per_gpu`` workers (default 4) and ``seed``, as the JAX
      package builds it; with ``dist`` its batches are this rank's rows
      of the global batch, the only rows it decodes;
    - val / test datasets get a SimpleLoader (a ``sampler`` raises)."""
    phase = dataset_opt.get('phase', 'val')
    if hasattr(dataset, '__next__') or phase != 'train':
        if sampler is not None:
            raise NotImplementedError(
                f'build_dataloader: sampler {type(sampler).__name__}: '
                f'{type(dataset).__name__} '
                + ('iterates itself' if hasattr(dataset, '__next__')
                   else 'is read in order by a SimpleLoader'))
    if hasattr(dataset, '__next__'):
        if dist:
            from bsvd_tpu_torch.parallel.mesh import world
            rank, size = world()
            got = (getattr(dataset, 'rank', 0),
                   getattr(dataset, 'num_devices', 1))
            if got != (rank, size) or num_gpu not in (None, 'auto', size):
                raise ValueError(
                    f'build_dataloader(dist=True): {type(dataset).__name__} '
                    f'made for rank {got[0]} of {got[1]}, num_gpu {num_gpu}; '
                    f'this is rank {rank} of {size}: set its options\' '
                    f'num_devices and rank')
        return dataset
    if phase == 'train':
        from bsvd_tpu_torch.data.sampler import BatchLoader, EnlargedSampler
        from bsvd_tpu_torch.parallel.mesh import world
        if sampler is None:
            sampler = EnlargedSampler(
                dataset, ratio=dataset_opt.get('dataset_enlarge_ratio', 1))
        rank, ranks = world() if dist else (0, 1)
        n = num_gpu if isinstance(num_gpu, int) else ranks
        if dist and n != ranks:
            raise ValueError(f'build_dataloader(dist=True): num_gpu {n} on '
                             f'{ranks} ranks')
        return BatchLoader(dataset,
                           dataset_opt.get('batch_size_per_gpu', 1)
                           * max(n, 1), sampler=sampler,
                           num_workers=dataset_opt.get('num_worker_per_gpu',
                                                       4), seed=seed,
                           rank=rank, num_ranks=ranks)
    return SimpleLoader(dataset)
