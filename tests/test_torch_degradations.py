"""The port's degradations, matlab_functions, img_process_util, NIQE and
the metric scripts against the JAX package on the CPU, on the same seeded
inputs: MATLAB imresize in float64 (1e-12), the kernel generators and the
numpy noise with the same draws (equal), the batched Gaussian noise on
JAX's own normals (1e-6), the JPEG round trip (equal), USM in both forms
(1e-5), and NIQE on a synthetic parameter file (a seeded mean and a
positive-definite covariance of the real shapes; the repository has no
niqe_pris_params.npz): 2e-5 relative (JAX fits the first scale's blocks
in float32 numpy, the port in float64: the 36 features part by ~1e-7
relative, the score by up to ~5e-6)."""

import contextlib
import importlib.util
import io
import math
import os
import sys
import types

import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401

cv2 = pytest.importorskip('cv2')
jnp = pytest.importorskip('jax.numpy')

from bsvd_tpu_torch.data import degradations as port_deg  # noqa: E402
from bsvd_tpu_torch.utils import matlab_functions as port_mf  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------- matlab_functions
@pytest.mark.parametrize('scale', [0.5, 0.25, 1 / 3, 0.75, 2, 1.5])
def test_imresize_matches_jax_in_float64(scale):
    from bsvd_tpu.utils import matlab_functions as jmf
    rng = np.random.default_rng(0)
    for img in (rng.random((37, 45, 3)), rng.random((24, 30)),
                rng.integers(0, 256, (20, 26, 3)).astype(np.uint8)):
        ref = jmf.imresize(img, scale)
        got = port_mf.imresize(img, scale)
        assert got.dtype == np.float64 and got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
        t = port_mf.imresize(torch.from_numpy(np.ascontiguousarray(img)),
                             scale)
        np.testing.assert_allclose(t.numpy(), ref, rtol=0, atol=1e-12)
    x = np.linspace(-3, 3, 101)
    np.testing.assert_array_equal(port_mf.cubic(x), jmf.cubic(x))


def test_ycbcr_conversions_match_jax():
    from bsvd_tpu.utils import matlab_functions as jmf
    rng = np.random.default_rng(1)
    for img in (rng.integers(0, 256, (9, 11, 3)).astype(np.uint8),
                rng.random((9, 11, 3)).astype(np.float32)):
        for name in ('rgb2ycbcr', 'bgr2ycbcr'):
            for y_only in (False, True):
                np.testing.assert_array_equal(
                    getattr(port_mf, name)(img, y_only),
                    getattr(jmf, name)(img, y_only))
        for name in ('ycbcr2rgb', 'ycbcr2bgr'):
            np.testing.assert_array_equal(getattr(port_mf, name)(img),
                                          getattr(jmf, name)(img))
    with pytest.raises(TypeError):
        port_mf.rgb2ycbcr(np.zeros((2, 2, 3), np.int32))


# ------------------------------------------------------------ degradations
KERNELS = ['iso', 'aniso', 'generalized_iso', 'generalized_aniso',
           'plateau_iso', 'plateau_aniso']


@pytest.mark.parametrize('kind', KERNELS)
def test_random_mixed_kernels_same_draws(kind):
    from bsvd_tpu.data import degradations as jdeg
    for seed in range(3):
        for noise in (None, (0.75, 1.25)):
            r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
            a = port_deg.random_mixed_kernels([kind], [1.0], 21,
                                              noise_range=noise, rng=r1)
            b = jdeg.random_mixed_kernels([kind], [1.0], 21,
                                          noise_range=noise, rng=r2)
            np.testing.assert_array_equal(a, b)
            assert r1.random() == r2.random()
    r1, r2 = np.random.default_rng(9), np.random.default_rng(9)
    np.testing.assert_array_equal(
        port_deg.random_mixed_kernels(KERNELS, [1 / 6] * 6, 7, rng=r1),
        jdeg.random_mixed_kernels(KERNELS, [1 / 6] * 6, 7, rng=r2))


def test_fixed_kernels_match_jax():
    from bsvd_tpu.data import degradations as jdeg
    for cutoff, k, pad in ((np.pi / 3, 13, 0), (1.1, 21, 0), (2.0, 7, 21)):
        np.testing.assert_array_equal(
            port_deg.circular_lowpass_kernel(cutoff, k, pad),
            jdeg.circular_lowpass_kernel(cutoff, k, pad))
    grid, _, _ = port_deg.mesh_grid(9)
    np.testing.assert_array_equal(grid, jdeg.mesh_grid(9)[0])
    d = port_deg.sigma_matrix2(1.5, 0.7, 0.3)
    np.testing.assert_array_equal(d, jdeg.sigma_matrix2(1.5, 0.7, 0.3))
    np.testing.assert_array_equal(port_deg.cdf2(d, grid),
                                  jdeg.cdf2(d, grid))
    np.testing.assert_array_equal(
        port_deg.bivariate_plateau(9, 1.2, 2.0, 0.4, 1.5, isotropic=False),
        jdeg.bivariate_plateau(9, 1.2, 2.0, 0.4, 1.5, isotropic=False))


@pytest.mark.parametrize('gray', [False, True])
def test_numpy_noise_same_draws(gray):
    from bsvd_tpu.data import degradations as jdeg
    img = np.random.default_rng(2).random((20, 24, 3)).astype(np.float32)
    for fn, kw in (('add_gaussian_noise', dict(sigma=12, gray_noise=gray)),
                   ('add_poisson_noise', dict(scale=0.8, gray_noise=gray)),
                   ('random_add_gaussian_noise',
                    dict(sigma_range=(1, 30), gray_prob=0.5 * gray)),
                   ('random_add_poisson_noise',
                    dict(scale_range=(0.05, 3), gray_prob=0.5 * gray))):
        for clip, rounds in ((True, False), (True, True), (False, True),
                             (False, False)):
            r1, r2 = np.random.default_rng(3), np.random.default_rng(3)
            a = getattr(port_deg, fn)(img, clip=clip, rounds=rounds, rng=r1,
                                      **kw)
            b = getattr(jdeg, fn)(img, clip=clip, rounds=rounds, rng=r2,
                                  **kw)
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6, err_msg=fn)
    base, vals = port_deg._poisson_rate(img, gray)
    rbase, rvals = jdeg._poisson_rate(img, gray)
    np.testing.assert_array_equal(base, rbase)
    assert vals == rvals


@pytest.mark.parametrize('gray', [None, (1, 0, 1)])
@pytest.mark.parametrize('clip,rounds', [(True, False), (True, True),
                                         (False, True), (False, False)])
def test_batched_gaussian_noise_on_jax_normals(gray, clip, rounds):
    """The port draws from a torch.Generator; here both sides add JAX's
    own normals (random bits cannot match across frameworks)."""
    import jax
    from bsvd_tpu.data.degradations import add_gaussian_noise_jax
    img = np.random.default_rng(4).random((3, 10, 12, 3)).astype(np.float32)
    sigma = np.array([5.0, 17.0, 30.0], np.float32)
    key = jax.random.PRNGKey(7)
    ref = np.asarray(add_gaussian_noise_jax(key, jnp.asarray(img), sigma,
                                            gray, clip, rounds))
    noise = np.asarray(jax.random.normal(key, img.shape, jnp.float32))
    kg, _ = jax.random.split(key)
    g = np.asarray(jax.random.normal(kg, img.shape[:3] + (1,), jnp.float32))
    got = port_deg.add_gaussian_noise_torch(
        torch.from_numpy(img), torch.from_numpy(sigma), gray, clip, rounds,
        noise=torch.from_numpy(noise), gray=torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
    gen = torch.Generator().manual_seed(0)
    drawn = port_deg.add_gaussian_noise_torch(torch.from_numpy(img), sigma,
                                              gray, generator=gen)
    assert drawn.shape == img.shape and float(drawn.min()) >= 0


@pytest.mark.parametrize('quality', [15, 30.7, 50, 90, 99.5])
def test_jpg_compression_equals_cv2s(quality):
    from bsvd_tpu.data import degradations as jdeg
    img = cv2.GaussianBlur(np.random.default_rng(5).random(
        (40, 56, 3)).astype(np.float32), (5, 5), 1.5)
    np.testing.assert_array_equal(port_deg.add_jpg_compression(img, quality),
                                  jdeg.add_jpg_compression(img, quality))
    r1, r2 = np.random.default_rng(6), np.random.default_rng(6)
    np.testing.assert_array_equal(
        port_deg.random_add_jpg_compression(img, (20, 95), rng=r1),
        jdeg.random_add_jpg_compression(img, (20, 95), rng=r2))


# -------------------------------------------------------- img_process_util
@pytest.mark.parametrize('radius', [50, 21, 8])
def test_usm_sharp_both_forms(radius):
    from bsvd_tpu.utils import img_process_util as jip
    from bsvd_tpu_torch.utils import img_process_util as pip
    rng = np.random.default_rng(7)
    img = cv2.GaussianBlur(rng.random((60, 70, 3)).astype(np.float32),
                           (3, 3), 0.8)
    np.testing.assert_allclose(
        pip.usm_sharp(torch.from_numpy(img), 0.5, radius).numpy(),
        jip.usm_sharp(img, 0.5, radius), rtol=0, atol=1e-5)
    batch = rng.random((2, 40, 48, 3)).astype(np.float32)
    np.testing.assert_allclose(
        pip.usm_sharp_torch(torch.from_numpy(batch), 0.5, radius + 1).numpy(),
        np.asarray(jip.usm_sharp_jax(jnp.asarray(batch), 0.5, radius + 1)),
        rtol=0, atol=1e-5)


# ------------------------------------------------------------------- NIQE
def _synthetic_params(path, seed=0):
    """A seeded mean (36,) and a positive-definite covariance (36, 36):
    the pristine file's shapes, not its values."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((36, 36))
    cov = a @ a.T / 36 + 0.5 * np.eye(36)
    mu = rng.uniform(0.2, 3.0, 36)
    np.savez(path, mu_pris_param=mu[None], cov_pris_param=cov)
    return str(path)


def _natural(h, w, seed):
    rng = np.random.default_rng(seed)
    img = cv2.resize(rng.integers(0, 256, (h // 8, w // 8, 3),
                                  dtype=np.uint8), (w, h),
                     interpolation=cv2.INTER_CUBIC)
    noise = rng.normal(0, 6, img.shape)
    return np.clip(img + noise, 0, 255).astype(np.uint8)


@pytest.mark.parametrize('convert_to,crop', [('y', 0), ('gray', 4),
                                             ('y', 7)])
def test_niqe_matches_jax(tmp_path, convert_to, crop):
    from bsvd_tpu.metrics.niqe import calculate_niqe as jniqe
    from bsvd_tpu_torch.metrics import calculate_metric
    params = _synthetic_params(tmp_path / 'p.npz')
    img = _natural(200, 296, 1)
    ref = jniqe(img, crop, convert_to=convert_to, niqe_pris_params=params)
    got = calculate_metric({'img': img}, {
        'type': 'calculate_niqe', 'crop_border': crop,
        'convert_to': convert_to, 'niqe_pris_params': params,
        'device': 'cpu'})
    assert math.isfinite(ref)
    assert abs(got - ref) <= 2e-5 * abs(ref), (got, ref)
    tens = torch.from_numpy(img)
    from bsvd_tpu_torch.metrics.niqe import calculate_niqe
    assert calculate_niqe(tens, crop, convert_to=convert_to,
                          niqe_pris_params=params) == got


def test_niqe_params_search_and_errors(tmp_path, monkeypatch):
    from bsvd_tpu_torch.metrics import niqe
    params = _synthetic_params(tmp_path / 'env.npz', seed=3)
    monkeypatch.setenv('BSVD_NIQE_PARAMS', params)
    mu, cov = niqe._load_pris_params()
    assert mu.shape == (1, 36) and cov.shape == (36, 36)
    monkeypatch.delenv('BSVD_NIQE_PARAMS')
    with pytest.raises(FileNotFoundError, match='BSVD_NIQE_PARAMS'):
        niqe._load_pris_params()
    with pytest.raises(ValueError, match='at least 96x96'):
        niqe.calculate_niqe(np.zeros((90, 200, 3), np.uint8), 0,
                            niqe_pris_params=params, device='cpu')


# ----------------------------------------------------------- the scripts
def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f'_t_jax_{name}', os.path.join(ROOT, 'scripts', 'metrics',
                                       f'{name}.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(fn, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(*args)
    return out.getvalue()


def test_metric_scripts_match_jax(tmp_path, monkeypatch):
    from bsvd_tpu_torch.scripts.metrics import calculate_niqe as pniqe
    from bsvd_tpu_torch.scripts.metrics import calculate_psnr_ssim as ppsnr
    gt, res = tmp_path / 'gt', tmp_path / 'res'
    os.makedirs(gt)
    os.makedirs(res)
    for i in range(2):
        img = _natural(200, 200, 10 + i)
        cv2.imwrite(str(gt / f'{i}.png'), img)
        noisy = np.clip(img + np.random.default_rng(i).normal(
            0, 4, img.shape), 0, 255).astype(np.uint8)
        cv2.imwrite(str(res / f'{i}_x.png'), noisy)
    monkeypatch.setattr(sys, 'argv', [
        'x', '--gt', str(gt), '--restored', str(res), '--suffix', '_x',
        '--crop_border', '4', '--test_y_channel'])
    ref = _run(_jax_script('calculate_psnr_ssim').main)
    got = _run(ppsnr.main, ['--gt', str(gt), '--restored', str(res),
                            '--suffix', '_x', '--crop_border', '4',
                            '--test_y_channel'])
    assert got == ref
    monkeypatch.setenv('BSVD_NIQE_PARAMS',
                       _synthetic_params(tmp_path / 'p.npz'))
    ref = _run(_jax_script('calculate_niqe').main,
               types.SimpleNamespace(input=str(gt), crop_border=2))
    got = _run(pniqe.main, ['--input', str(gt), '--crop_border', '2',
                            '--device', 'cpu'])
    ref_scores = [float(l.split('NIQE: ')[1]) for l in ref.splitlines()
                  if 'NIQE: ' in l]
    got_scores = [float(l.split('NIQE: ')[1]) for l in got.splitlines()
                  if 'NIQE: ' in l]
    assert len(got_scores) == len(ref_scores) == 3
    np.testing.assert_allclose(got_scores, ref_scores, rtol=1e-5)
