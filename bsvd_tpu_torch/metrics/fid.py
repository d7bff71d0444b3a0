"""Frechet Inception Distance (counterpart of bsvd_tpu/metrics/fid.py).

The features are the port's TF-FID InceptionV3 (``archs/inception_arch``)
on the caller's device; the distance itself is host numpy / scipy, as in
the JAX package: one O(2048^3) ``sqrtm`` an evaluation, not a hot op.
``calculate_fid`` is JAX's, but for ``sqrtm``'s ``disp`` argument, which
SciPy 1.18 removed (JAX's copy raises TypeError there).
"""

import numpy as np
import torch
from scipy import linalg

from bsvd_tpu_torch.archs.inception_arch import (InceptionV3,
                                                 load_torch_inception)

__all__ = ['load_patched_inception_v3', 'extract_inception_features',
           'calculate_fid']


def load_patched_inception_v3(resize_input=True, normalize_input=False,
                              pretrain_path=None, device='cuda'):
    """The pool3 InceptionV3 with the TF-FID weights on ``device``, in the
    configuration BasicSR's FID uses: resize on, normalize off (callers
    feed [-1, 1]). Raises FileNotFoundError without the weight file."""
    state = load_torch_inception(pretrain_path)
    net = InceptionV3((3,), resize_input, normalize_input)
    net.load_state_dict(state, strict=False)
    return net.to(device).eval()


def extract_inception_features(data_generator, inception,
                               len_generator=None):
    """Every batch of ``data_generator`` through ``inception``; returns the
    (N, 2048) float32 features as a numpy array.

    A batch is an array or tensor (N, 3, H, W) or (N, H, W, 3), read by the
    JAX package's rule: NCHW where dim 1 is 3 and the last dim is not,
    else NHWC. It is moved to the net's device.
    """
    del len_generator
    device = next(inception.parameters()).device
    feats = []
    with torch.no_grad():
        for data in data_generator:
            x = torch.as_tensor(data, dtype=torch.float32).to(device)
            if not (x.ndim == 4 and x.shape[1] == 3 and x.shape[-1] != 3):
                x = x.permute(0, 3, 1, 2)
            feat = inception(x)[0]
            feats.append(feat.reshape(feat.shape[0], -1).cpu().numpy())
    return np.concatenate(feats, axis=0)


def calculate_fid(mu1, sigma1, mu2, sigma2, eps=1e-6):
    """Frechet distance between N(mu1, sigma1) and N(mu2, sigma2):
    ||mu1-mu2||^2 + Tr(C1 + C2 - 2 sqrt(C1 C2)), with the Dougal Sutherland
    stabilization (reference fid.py:50-93)."""
    mu1, mu2 = np.asarray(mu1), np.asarray(mu2)
    sigma1, sigma2 = np.asarray(sigma1), np.asarray(sigma2)
    assert mu1.shape == mu2.shape, 'Two mean vectors have different lengths'
    assert sigma1.shape == sigma2.shape, \
        'Two covariances have different dimensions'

    # no ``disp``: SciPy 1.18 removed the argument JAX's copy passes
    cov_sqrt = linalg.sqrtm(sigma1 @ sigma2)
    if not np.isfinite(cov_sqrt).all():
        print(f'Product of cov matrices is singular; adding {eps} to the '
              'diagonals')
        offset = np.eye(sigma1.shape[0]) * eps
        cov_sqrt = linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(cov_sqrt):
        if not np.allclose(np.diagonal(cov_sqrt).imag, 0, atol=1e-3):
            m = np.max(np.abs(cov_sqrt.imag))
            raise ValueError(f'Imaginary component {m}')
        cov_sqrt = cov_sqrt.real

    mean_diff = mu1 - mu2
    return (mean_diff @ mean_diff + np.trace(sigma1) + np.trace(sigma2)
            - 2 * np.trace(cov_sqrt))
