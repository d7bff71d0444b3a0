"""NIQE, the no-reference quality metric (counterpart of
bsvd_tpu/metrics/niqe.py; MATLAB's algorithm after BasicSR's niqe.py).

The metric needs the pristine MVG parameters (``mu_pris_param``,
``cov_pris_param``), found as in JAX: the ``niqe_pris_params`` kwarg,
then ``$BSVD_NIQE_PARAMS``, then ``niqe_pris_params.npz`` next to this
module. None is in the repository.

The image work runs on ``device`` (the input tensor's, else the card when
there is one): the 7 x 7 Gaussian local statistics (scipy's
``convolve(mode='nearest')`` in JAX), the 96 x 96 blocks' AGGD fits,
vectorised over the blocks, MATLAB's imresize to the second scale
(``utils/matlab_functions``) and the Mahalanobis distance. The first
scale keeps JAX's float32 maps (its convolutions return the image's
float32); the fits and the second scale are float64. The gamma-function
tables of the fit depend on nothing but constants and are made on the
host with scipy, as JAX's.
"""

import math
import os

import numpy as np
import torch
import torch.nn.functional as F
from scipy.special import gamma

from bsvd_tpu_torch.utils import cv2_ops
from bsvd_tpu_torch.utils.matlab_functions import imresize
from bsvd_tpu_torch.utils.registry import METRIC_REGISTRY

_PARAM_SEARCH = (
    os.path.join(os.path.dirname(os.path.abspath(__file__)),
                 'niqe_pris_params.npz'),
)

# the AGGD fit's shape grid and its gamma-function ratios
_GAM = np.arange(0.2, 10.001, 0.001)
_R_GAM = (np.square(gamma(2 / _GAM)) / (gamma(1 / _GAM) * gamma(3 / _GAM)))
_BETA_RATIO = np.sqrt(gamma(1 / _GAM) / gamma(3 / _GAM))
_MEAN_RATIO = gamma(2 / _GAM) / gamma(1 / _GAM)


def _gaussian_window():
    """fspecial('gaussian', 7, 7/6), normalised to unit sum."""
    g = cv2_ops.get_gaussian_kernel(7, 7 / 6)
    w = np.outer(g, g.T)
    return w / w.sum()


def _load_pris_params(path=None):
    candidates = ([path] if path else []) + \
        ([os.environ['BSVD_NIQE_PARAMS']]
         if 'BSVD_NIQE_PARAMS' in os.environ else []) + list(_PARAM_SEARCH)
    for cand in candidates:
        if cand and os.path.isfile(cand):
            z = np.load(cand)
            return z['mu_pris_param'], z['cov_pris_param']
    raise FileNotFoundError(
        'niqe_pris_params.npz not found; set BSVD_NIQE_PARAMS or pass '
        'niqe_pris_params=<path> (the pristine MVG parameters are data, not '
        'code, and must be provided).')


def _aggd(blocks):
    """Asymmetric generalised Gaussian fit of each row of (B, n) ->
    (alpha, beta_l, beta_r, table position) per row (the NIQE paper's
    Eq. 7)."""
    sq = blocks * blocks
    neg, pos = blocks < 0, blocks > 0
    left_std = torch.sqrt((sq * neg).sum(1) / neg.sum(1))
    right_std = torch.sqrt((sq * pos).sum(1) / pos.sum(1))
    gammahat = left_std / right_std
    rhat = blocks.abs().mean(1) ** 2 / sq.mean(1)
    rhatnorm = (rhat * (gammahat ** 3 + 1) * (gammahat + 1)) / \
        ((gammahat ** 2 + 1) ** 2)
    r_gam = torch.as_tensor(_R_GAM, device=blocks.device)
    idx = torch.argmin((r_gam[None] - rhatnorm[:, None]) ** 2, dim=1)
    ratio = torch.as_tensor(_BETA_RATIO, device=blocks.device)[idx]
    alpha = torch.as_tensor(_GAM, device=blocks.device)[idx]
    return alpha, left_std * ratio, right_std * ratio, idx


def _features(blocks):
    """The 18 features of each (B, h, w) normalised block (Eq. 8)."""
    b = blocks.shape[0]
    flat = blocks.reshape(b, -1)
    alpha, bl, br, _ = _aggd(flat)
    feat = [alpha, (bl + br) / 2]
    for shift in ((0, 1), (1, 0), (1, 1), (1, -1)):
        shifted = torch.roll(blocks, shift, dims=(1, 2))
        alpha, bl, br, idx = _aggd((blocks * shifted).reshape(b, -1))
        mean = (br - bl) * torch.as_tensor(_MEAN_RATIO,
                                           device=blocks.device)[idx]
        feat += [alpha, mean, bl, br]
    return torch.stack(feat, 1)


def _local_stats(img, window):
    """(mu, sigma) of the 7 x 7 window, edge pixels repeated."""
    x = F.pad(img[None, None], (3, 3, 3, 3), mode='replicate')
    mu = F.conv2d(x, window)[0, 0]
    sq = F.conv2d(x * x, window)[0, 0]
    return mu, sq


def niqe_core(img, mu_pris_param, cov_pris_param, gaussian_window,
              block_size_h=96, block_size_w=96):
    """NIQE of a 2-D tensor (float32 values in [0, 255])."""
    assert img.ndim == 2
    h, w = img.shape
    num_block_h = math.floor(h / block_size_h)
    num_block_w = math.floor(w / block_size_w)
    if num_block_h == 0 or num_block_w == 0:
        raise ValueError(
            f'NIQE needs images of at least {block_size_h}x{block_size_w} '
            f'(after border crop); got {h}x{w}.')
    img = img[0:num_block_h * block_size_h, 0:num_block_w * block_size_w]
    dev = img.device
    window = torch.as_tensor(gaussian_window, device=dev)[None, None]

    distparam = []
    for scale in (1, 2):
        dtype = img.dtype
        x = img.double()
        mu, sq = _local_stats(x, window)
        # JAX's convolve returns the image's dtype (float32 at scale 1)
        mu, sq = mu.to(dtype), sq.to(dtype)
        sigma = torch.sqrt(torch.abs(sq - mu * mu))
        norm = ((img - mu) / (sigma + 1)).double()
        bh, bw = block_size_h // scale, block_size_w // scale
        blocks = norm[:num_block_h * bh, :num_block_w * bw].reshape(
            num_block_h, bh, num_block_w, bw).permute(2, 0, 1, 3).reshape(
            -1, bh, bw)
        distparam.append(_features(blocks))
        if scale == 1:
            img = imresize(img.double() / 255., scale=0.5,
                           antialiasing=True) * 255.

    distparam = torch.cat(distparam, 1)
    mu_distparam = torch.nanmean(distparam, 0)
    rows = distparam[~torch.isnan(distparam).any(1)]
    cov_distparam = torch.cov(rows.T)
    cov_pris = torch.as_tensor(cov_pris_param, dtype=torch.float64,
                               device=dev)
    mu_pris = torch.as_tensor(mu_pris_param, dtype=torch.float64, device=dev)
    invcov = torch.linalg.pinv((cov_pris + cov_distparam) / 2)
    diff = mu_pris.reshape(-1) - mu_distparam
    return float(torch.sqrt(diff @ invcov @ diff))


@METRIC_REGISTRY.register()
def calculate_niqe(img, crop_border, input_order='HWC', convert_to='y',
                   niqe_pris_params=None, device=None, **kwargs):
    """NIQE of a BGR uint8 / float image in [0, 255]: an array, which goes
    to ``device`` (else the card where there is one), or a tensor, which
    stays on its device."""
    del kwargs
    mu_pris, cov_pris = _load_pris_params(niqe_pris_params)
    window = _gaussian_window()
    if not torch.is_tensor(img):
        if device is None:
            device = 'cuda' if torch.cuda.is_available() else 'cpu'
        img = torch.from_numpy(np.ascontiguousarray(img)).to(device)
    img = img.float()
    if input_order != 'HW':
        if input_order not in ('HWC', 'CHW'):
            raise ValueError(f"Wrong input_order {input_order}; use 'HWC' "
                             f"or 'CHW'")
        if img.ndim == 2:
            img = img[..., None]
        elif input_order == 'CHW':
            img = img.permute(1, 2, 0)
        if convert_to == 'y' and img.shape[2] == 3:
            # to_y_channel: BT.601 Y through the [0, 1] round trip
            wts = torch.tensor([24.966, 128.553, 65.481], device=img.device)
            img = ((img / 255.) * wts).sum(-1, keepdim=True) + 16.0
            img = img / 255. * 255.
        elif convert_to == 'y':
            img = img / 255. * 255.
        elif convert_to == 'gray':
            img = cv2_ops.cvt_color(img / 255., cv2_ops.COLOR_BGR2GRAY) * 255.
        img = img.squeeze()
    if crop_border != 0:
        img = img[crop_border:-crop_border, crop_border:-crop_border]
    return niqe_core(img.round(), mu_pris, cov_pris, window)
