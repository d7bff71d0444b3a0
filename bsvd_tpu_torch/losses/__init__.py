"""Loss registry + factory of the port (counterpart of
bsvd_tpu/losses/__init__.py build_loss): the pixel, TV, PSNR and VGG
perceptual losses and the GAN losses."""

from copy import deepcopy

from bsvd_tpu_torch.losses import gan_loss  # noqa: F401  registers losses
from bsvd_tpu_torch.losses.gan_loss import (GANFeatLoss, GANLoss,  # noqa: F401
                                            MultiScaleGANLoss,
                                            g_path_regularize,
                                            gradient_penalty_loss,
                                            r1_penalty)
from bsvd_tpu_torch.losses.losses import (  # noqa: F401
    CharbonnierLoss, L1Loss, MSELoss, PerceptualLoss, PSNRLoss,
    WeightedTVLoss)
from bsvd_tpu_torch.utils.registry import LOSS_REGISTRY


def build_loss(opt):
    """A registered loss from an options dict ({'type': Name, ...})."""
    opt = deepcopy(dict(opt))
    return LOSS_REGISTRY.get(opt.pop('type'))(**opt)
