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
    """The loader of a phase (bsvd_tpu/data/__init__.py:41): a
    self-iterating train loader (the video loader) passes through; val /
    test datasets get a SimpleLoader. A map-style train dataset raises:
    only the zoo's datasets are map-style, and their sampler and batch
    loader come with the zoo (ROADMAP Queue 1 item 9). ``seed`` seeds that
    batch loader in the JAX package; the loaders here draw nothing (the
    video loader is seeded by its options' ``manual_seed``). ``num_gpu``
    is the mesh's ranks; with ``dist`` a train loader must have been made
    for this rank of them (``num_devices`` and ``rank`` in its options:
    its batches are this rank's rows of the global batch), and a val
    dataset is read whole by every rank. A ``sampler`` raises: no loader
    here takes one."""
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
    if dataset_opt.get('phase', 'val') == 'train':
        raise NotImplementedError(
            f'build_dataloader: map-style train dataset '
            f'{type(dataset).__name__}: its sampler and batch loader come '
            f'with the zoo (ROADMAP Queue 1 item 9)')
    return SimpleLoader(dataset)
