"""Degradation synthesis: blur kernels, Gaussian / Poisson noise, JPEG
(counterpart of bsvd_tpu/data/degradations.py, BasicSR's Real-ESRGAN
toolbox). The kernel generators and the ``add_*`` noise functions are
numpy on the host with the JAX package's draws (``rng``, a numpy
Generator); ``add_gaussian_noise_torch`` is the batched form of JAX's
``add_gaussian_noise_jax`` on (N, H, W, C) tensors with a
``torch.Generator`` (or a given noise tensor); the JPEG round trip is the
port's writer and decoder.
"""

import math

import numpy as np
import torch
from scipy import special
from scipy.stats import multivariate_normal

from bsvd_tpu_torch.utils import cv2_ops


# ---------------------------------------------------------------------------
# blur kernels
# ---------------------------------------------------------------------------

def sigma_matrix2(sig_x, sig_y, theta):
    """Rotated 2D covariance matrix."""
    d = np.array([[sig_x**2, 0], [0, sig_y**2]])
    u = np.array([[np.cos(theta), -np.sin(theta)],
                  [np.sin(theta), np.cos(theta)]])
    return u @ d @ u.T


def mesh_grid(kernel_size):
    """Zero-centred (K, K, 2) grid and its xx / yy."""
    ax = np.arange(-kernel_size // 2 + 1., kernel_size // 2 + 1.)
    xx, yy = np.meshgrid(ax, ax)
    xy = np.stack([xx, yy], axis=-1)
    return xy, xx, yy


def pdf2(sigma_matrix, grid):
    inv = np.linalg.inv(sigma_matrix)
    return np.exp(-0.5 * np.sum((grid @ inv) * grid, 2))


def cdf2(d_matrix, grid):
    rv = multivariate_normal([0, 0], [[1, 0], [0, 1]])
    return rv.cdf(grid @ d_matrix)


def _sigma(sig_x, sig_y, theta, isotropic):
    if isotropic:
        return np.array([[sig_x**2, 0], [0, sig_x**2]])
    return sigma_matrix2(sig_x, sig_y, theta)


def bivariate_Gaussian(kernel_size, sig_x, sig_y, theta, grid=None,
                       isotropic=True):
    if grid is None:
        grid, _, _ = mesh_grid(kernel_size)
    kernel = pdf2(_sigma(sig_x, sig_y, theta, isotropic), grid)
    return kernel / np.sum(kernel)


def bivariate_generalized_Gaussian(kernel_size, sig_x, sig_y, theta, beta,
                                   grid=None, isotropic=True):
    """exp(-(x^T S^-1 x / 2)^beta), normalised."""
    if grid is None:
        grid, _, _ = mesh_grid(kernel_size)
    inv = np.linalg.inv(_sigma(sig_x, sig_y, theta, isotropic))
    kernel = np.exp(-0.5 * np.power(np.sum((grid @ inv) * grid, 2), beta))
    return kernel / np.sum(kernel)


def bivariate_plateau(kernel_size, sig_x, sig_y, theta, beta, grid=None,
                      isotropic=True):
    """1 / (1 + (x^T S^-1 x)^beta), normalised."""
    if grid is None:
        grid, _, _ = mesh_grid(kernel_size)
    inv = np.linalg.inv(_sigma(sig_x, sig_y, theta, isotropic))
    kernel = np.reciprocal(np.power(np.sum((grid @ inv) * grid, 2), beta) + 1)
    return kernel / np.sum(kernel)


def _rand_params(rng, kernel_size, sigma_x_range, sigma_y_range,
                 rotation_range, isotropic):
    assert kernel_size % 2 == 1, 'Kernel size must be an odd number.'
    sigma_x = rng.uniform(sigma_x_range[0], sigma_x_range[1])
    if isotropic:
        sigma_y, rotation = sigma_x, 0.0
    else:
        sigma_y = rng.uniform(sigma_y_range[0], sigma_y_range[1])
        rotation = rng.uniform(rotation_range[0], rotation_range[1])
    return sigma_x, sigma_y, rotation


def _beta(rng, beta_range):
    if rng.uniform() < 0.5:
        return rng.uniform(beta_range[0], 1)
    return rng.uniform(1, beta_range[1])


def _noisy(kernel, noise_range, rng):
    if noise_range is not None:
        kernel = kernel * rng.uniform(noise_range[0], noise_range[1],
                                      kernel.shape)
    return kernel / np.sum(kernel)


def random_bivariate_Gaussian(kernel_size, sigma_x_range, sigma_y_range,
                              rotation_range, noise_range=None,
                              isotropic=True, rng=None):
    rng = rng or np.random.default_rng()
    sx, sy, rot = _rand_params(rng, kernel_size, sigma_x_range,
                               sigma_y_range, rotation_range, isotropic)
    kernel = bivariate_Gaussian(kernel_size, sx, sy, rot,
                                isotropic=isotropic)
    return _noisy(kernel, noise_range, rng)


def random_bivariate_generalized_Gaussian(kernel_size, sigma_x_range,
                                          sigma_y_range, rotation_range,
                                          beta_range, noise_range=None,
                                          isotropic=True, rng=None):
    rng = rng or np.random.default_rng()
    sx, sy, rot = _rand_params(rng, kernel_size, sigma_x_range,
                               sigma_y_range, rotation_range, isotropic)
    beta = _beta(rng, beta_range)
    kernel = bivariate_generalized_Gaussian(kernel_size, sx, sy, rot, beta,
                                            isotropic=isotropic)
    return _noisy(kernel, noise_range, rng)


def random_bivariate_plateau(kernel_size, sigma_x_range, sigma_y_range,
                             rotation_range, beta_range, noise_range=None,
                             isotropic=True, rng=None):
    rng = rng or np.random.default_rng()
    sx, sy, rot = _rand_params(rng, kernel_size, sigma_x_range,
                               sigma_y_range, rotation_range, isotropic)
    beta = _beta(rng, beta_range)
    kernel = bivariate_plateau(kernel_size, sx, sy, rot, beta,
                               isotropic=isotropic)
    return _noisy(kernel, noise_range, rng)


def random_mixed_kernels(kernel_list, kernel_prob, kernel_size=21,
                         sigma_x_range=(0.6, 5), sigma_y_range=(0.6, 5),
                         rotation_range=(-math.pi, math.pi),
                         betag_range=(0.5, 8), betap_range=(0.5, 8),
                         noise_range=None, rng=None):
    """One kernel from the weighted mix of families (iso / aniso x
    gaussian / generalized / plateau)."""
    rng = rng or np.random.default_rng()
    kernel_type = rng.choice(kernel_list, p=kernel_prob)
    common = dict(noise_range=noise_range, rng=rng)
    iso = not kernel_type.endswith('aniso')
    if kernel_type in ('iso', 'aniso'):
        return random_bivariate_Gaussian(kernel_size, sigma_x_range,
                                         sigma_y_range, rotation_range,
                                         isotropic=iso, **common)
    if kernel_type in ('generalized_iso', 'generalized_aniso'):
        return random_bivariate_generalized_Gaussian(
            kernel_size, sigma_x_range, sigma_y_range, rotation_range,
            betag_range, isotropic=iso, **common)
    if kernel_type in ('plateau_iso', 'plateau_aniso'):
        return random_bivariate_plateau(kernel_size, sigma_x_range,
                                        sigma_y_range, rotation_range,
                                        betap_range, isotropic=iso, **common)
    raise ValueError(f'unknown kernel type {kernel_type}')


def circular_lowpass_kernel(cutoff, kernel_size, pad_to=0):
    """2D sinc filter (ideal circular lowpass), MATLAB-faithful."""
    assert kernel_size % 2 == 1, 'Kernel size must be an odd number.'
    kernel = np.fromfunction(
        lambda x, y: cutoff * special.j1(
            cutoff * np.sqrt((x - (kernel_size - 1) / 2)**2 +
                             (y - (kernel_size - 1) / 2)**2)) /
        (2 * np.pi * np.sqrt((x - (kernel_size - 1) / 2)**2 +
                             (y - (kernel_size - 1) / 2)**2)),
        [kernel_size, kernel_size])
    kernel[(kernel_size - 1) // 2, (kernel_size - 1) // 2] = \
        cutoff**2 / (4 * np.pi)
    kernel = kernel / np.sum(kernel)
    if pad_to > kernel_size:
        pad = (pad_to - kernel_size) // 2
        kernel = np.pad(kernel, ((pad, pad), (pad, pad)))
    return kernel


# ---------------------------------------------------------------------------
# noise (numpy, HWC [0, 1])
# ---------------------------------------------------------------------------

def _finish(out, clip, rounds):
    if clip and rounds:
        return np.clip((out * 255.0).round(), 0, 255) / 255.
    if clip:
        return np.clip(out, 0, 1)
    if rounds:
        return (out * 255.0).round() / 255.
    return out


def generate_gaussian_noise(img, sigma=10, gray_noise=False, rng=None):
    rng = rng or np.random.default_rng()
    if gray_noise:
        noise = rng.normal(0, sigma / 255., img.shape[0:2]).astype(np.float32)
        noise = noise[..., None].repeat(3, axis=2) if img.ndim == 3 else noise
    else:
        noise = rng.normal(0, sigma / 255., img.shape).astype(np.float32)
    return noise


def add_gaussian_noise(img, sigma=10, clip=True, rounds=False,
                       gray_noise=False, rng=None):
    return _finish(img + generate_gaussian_noise(img, sigma, gray_noise, rng),
                   clip, rounds)


def random_add_gaussian_noise(img, sigma_range=(0, 1.0), gray_prob=0,
                              clip=True, rounds=False, rng=None):
    rng = rng or np.random.default_rng()
    sigma = rng.uniform(sigma_range[0], sigma_range[1])
    gray = rng.uniform() < gray_prob
    return add_gaussian_noise(img, sigma, clip, rounds, gray, rng)


def _poisson_rate(img, gray_noise=False):
    """The quantised rate image and ``vals`` of the Poisson noise: gray is
    taken of the float image, then quantised."""
    if gray_noise:
        base = cv2_ops.cvt_color(torch.from_numpy(np.ascontiguousarray(
            img, np.float32)), cv2_ops.COLOR_BGR2GRAY).numpy()
    else:
        base = img
    base = np.clip((base * 255.0).round(), 0, 255) / 255.
    vals = len(np.unique(base))
    vals = 2**np.ceil(np.log2(vals))
    return base, vals


def generate_poisson_noise(img, scale=1.0, gray_noise=False, rng=None):
    """Poisson (shot) noise; ``vals`` follows the unique-value rule."""
    rng = rng or np.random.default_rng()
    base, vals = _poisson_rate(img, gray_noise)
    out = np.float32(rng.poisson(base * vals) / float(vals))
    noise = out - base
    if gray_noise and img.ndim == 3:
        noise = noise[..., None].repeat(3, axis=2)
    return noise * scale


def add_poisson_noise(img, scale=1.0, clip=True, rounds=False,
                      gray_noise=False, rng=None):
    return _finish(img + generate_poisson_noise(img, scale, gray_noise, rng),
                   clip, rounds)


def random_add_poisson_noise(img, scale_range=(0, 1.0), gray_prob=0,
                             clip=True, rounds=False, rng=None):
    rng = rng or np.random.default_rng()
    scale = rng.uniform(scale_range[0], scale_range[1])
    gray = rng.uniform() < gray_prob
    return add_poisson_noise(img, scale, clip, rounds, gray, rng)


# ---------------------------------------------------------------------------
# noise (torch batched, NHWC [0, 1])
# ---------------------------------------------------------------------------

def add_gaussian_noise_torch(img, sigma, gray_noise=None, clip=True,
                             rounds=False, generator=None, noise=None,
                             gray=None):
    """img (N, H, W, C); sigma (N,) in [0, 255] units; gray_noise (N,) in
    {0, 1} or None. The unit normal draws come from ``generator`` (a
    torch.Generator on img's device), or are given: ``noise`` of img's
    shape and ``gray`` of (N, H, W, 1) (JAX's ``add_gaussian_noise_jax``
    draws them from its key)."""
    n = img.shape[0]
    sig = torch.as_tensor(sigma, dtype=img.dtype,
                          device=img.device).reshape(n, 1, 1, 1) / 255.
    if noise is None:
        noise = torch.randn(img.shape, generator=generator, dtype=img.dtype,
                            device=img.device)
    noise = noise * sig
    if gray_noise is not None:
        if gray is None:
            gray = torch.randn(img.shape[:3] + (1,), generator=generator,
                               dtype=img.dtype, device=img.device)
        g = gray * sig
        mask = torch.as_tensor(gray_noise, dtype=img.dtype,
                               device=img.device).reshape(n, 1, 1, 1)
        noise = mask * g + (1 - mask) * noise
    out = img + noise
    if clip and rounds:
        out = torch.clamp(torch.round(out * 255.), 0, 255) / 255.
    elif clip:
        out = torch.clamp(out, 0, 1)
    elif rounds:
        out = torch.round(out * 255.) / 255.
    return out


# ---------------------------------------------------------------------------
# JPEG (the port's codec)
# ---------------------------------------------------------------------------

def add_jpg_compression(img, quality=90):
    """A float [0, 1] BGR image through the JPEG writer and decoder at
    ``quality`` (truncated to an int, as cv2's parameter list)."""
    from bsvd_tpu_torch.data import jpeg_decode
    from bsvd_tpu_torch.utils.jpeg_encode import encode_jpeg
    img = np.clip(img, 0, 1)
    u8 = (img * 255.).astype(np.uint8)
    if u8.ndim == 3:
        u8 = u8[..., ::-1]
    data = encode_jpeg(np.ascontiguousarray(u8), int(quality))
    rgb = jpeg_decode.decode(data)
    return np.float32(rgb[..., ::-1]) / 255.


def random_add_jpg_compression(img, quality_range=(90, 100), rng=None):
    rng = rng or np.random.default_rng()
    quality = rng.uniform(quality_range[0], quality_range[1])
    return add_jpg_compression(img, quality)
