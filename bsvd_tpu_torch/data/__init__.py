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
    above 1, ``dist`` and a ``sampler`` raise: one card, one process, and
    no loader here takes a sampler."""
    if num_gpu is not None and num_gpu != 'auto' and int(num_gpu) > 1:
        raise NotImplementedError(
            f'build_dataloader: num_gpu {num_gpu}: the port runs on one '
            f'card (parallel/: ROADMAP Queue 1 item 5)')
    if dist:
        raise NotImplementedError('build_dataloader: dist=True: the port '
                                  'runs one process (ROADMAP Queue 1 item 5)')
    if sampler is not None:
        raise NotImplementedError(
            f'build_dataloader: sampler {type(sampler).__name__}: '
            f'{type(dataset).__name__} '
            + ('iterates itself' if hasattr(dataset, '__next__')
               else 'is read in order by a SimpleLoader'))
    if hasattr(dataset, '__next__'):
        return dataset
    if dataset_opt.get('phase', 'val') == 'train':
        raise NotImplementedError(
            f'build_dataloader: map-style train dataset '
            f'{type(dataset).__name__}: its sampler and batch loader come '
            f'with the zoo (ROADMAP Queue 1 item 9)')
    return SimpleLoader(dataset)
