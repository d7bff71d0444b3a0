"""Metrics of the port (counterpart of bsvd_tpu/metrics/__init__.py):
PSNR, SSIM, float PSNR and NIQE, registered in METRIC_REGISTRY and dispatched
by an options dict's ``type``."""

from bsvd_tpu_torch.metrics.niqe import calculate_niqe  # noqa: F401
from bsvd_tpu_torch.metrics.psnr_ssim import (calculate_psnr,  # noqa: F401
                                              calculate_psnr_float,
                                              calculate_ssim)
from bsvd_tpu_torch.utils.registry import METRIC_REGISTRY

__all__ = ['calculate_metric', 'calculate_psnr', 'calculate_ssim',
           'calculate_psnr_float', 'calculate_niqe']


def calculate_metric(data, opt):
    """Dispatch by opt['type']; the other keys of ``opt`` are kwargs."""
    opt = dict(opt)
    return METRIC_REGISTRY.get(opt.pop('type'))(**data, **opt)
