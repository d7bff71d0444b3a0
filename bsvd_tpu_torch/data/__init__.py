"""Host-side data of the port (numpy): the train batch's augmentation and
noise synthesis, a seeded synthetic clip source, and the validation
datasets (counterpart of bsvd_tpu/data/__init__.py build_dataset /
build_dataloader for the val phases)."""

from bsvd_tpu_torch.data import val_folder_dataset  # noqa: F401  registers
from bsvd_tpu_torch.utils.registry import DATASET_REGISTRY


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


def build_dataloader(dataset, dataset_opt):
    """The loader of a val / test phase: a SimpleLoader. The train phase
    takes the caller's own loader (``train.train_pipeline``'s
    ``train_loader``)."""
    if dataset_opt.get('phase', 'val') == 'train':
        raise NotImplementedError('build_dataloader: the train phase takes '
                                  "the caller's loader (train_pipeline's "
                                  'train_loader)')
    return SimpleLoader(dataset)
