"""Loss registry + factory of the port (counterpart of
bsvd_tpu/losses/__init__.py build_loss; pixel losses only: the perceptual
(VGG) loss comes with the zoo)."""

from copy import deepcopy

from bsvd_tpu_torch.losses.losses import (CharbonnierLoss, L1Loss,  # noqa: F401
                                          MSELoss)
from bsvd_tpu_torch.utils.registry import LOSS_REGISTRY


def build_loss(opt):
    """A registered loss from an options dict ({'type': Name, ...})."""
    opt = deepcopy(dict(opt))
    return LOSS_REGISTRY.get(opt.pop('type'))(**opt)
