"""DiffJPEG of the port against the JAX package on the CPU: the round trip
at sizes that need padding to multiples of 16, with one quality per
sample and a scalar quality, in both rounding modes, its gradients
against ``jax.grad``, and the NCHW ``DiffJPEG`` wrapper.

Tolerances, with their reasons: forwards and gradients are compared in
float64 (``jax.enable_x64``), where the two packages quantise the same
coefficients, to 1e-10 x max|ref|. In fp32 a different summation order
may move a coefficient across a .5 boundary of ``blocks / q``: there the
quantised coefficients of the two packages may differ by one step on at
most 1e-4 of them (measured: 0 of 18,432 here), and the port's decode of
JAX's coefficients is held to 1e-5 x max|ref|.
"""

import numpy as np
import pytest
import torch

from bsvd_tpu_torch.utils import diffjpeg as port
from torch_threads import one_torch_thread  # noqa: F401

jax = pytest.importorskip('jax')
jnp = pytest.importorskip('jax.numpy')


def _img(seed, shape, dtype=np.float64):
    """Smooth images with edges (a JPEG's kind of input) in [0, 1]."""
    rng = np.random.default_rng(seed)
    n, h, w, _ = shape
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    out = np.empty(shape)
    for i in range(n):
        for c in range(3):
            f = rng.uniform(1, 6, 2)
            out[i, :, :, c] = 0.5 + 0.35 * np.sin(2 * np.pi * (
                f[0] * yy + f[1] * xx + rng.uniform()))
    out += rng.normal(0, 0.03, shape)
    return np.clip(out, 0, 1).astype(dtype)


def _rel(got, ref, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = float(np.abs(got - ref).max())
    assert err <= tol * float(np.abs(ref).max()), \
        (err, float(np.abs(ref).max()))


QUALITIES = {'per_sample': np.array([30., 49., 75.]), 'scalar': 50.0}


@pytest.mark.parametrize('differentiable', [True, False],
                         ids=['diff_round', 'round'])
@pytest.mark.parametrize('quality', ['per_sample', 'scalar'])
@pytest.mark.parametrize('hw', [(20, 27), (32, 48), (9, 40)])
def test_diff_jpeg_matches_jax_in_float64(hw, quality, differentiable):
    from bsvd_tpu.utils.diffjpeg import diff_jpeg
    x = _img(1, (3,) + hw + (3,))
    q = QUALITIES[quality]
    with jax.enable_x64(True):
        ref = np.asarray(diff_jpeg(jnp.asarray(x), jnp.asarray(q),
                                   differentiable))
    got = port.diff_jpeg(torch.from_numpy(x), torch.as_tensor(q),
                         differentiable)
    assert got.dtype == torch.float64 and got.shape == x.shape
    _rel(got, ref, 1e-10)


@pytest.mark.parametrize('differentiable', [True, False],
                         ids=['diff_round', 'round'])
def test_gradients_match_jax_grad(differentiable):
    """d sum(w * diff_jpeg(x)) / dx against ``jax.grad`` in float64: through
    ``diff_round`` the gradient of round is 3 (x - round x)^2; through
    ``torch.round`` it is 0, as ``jnp.round``'s, so x's gradient is 0."""
    from bsvd_tpu.utils.diffjpeg import diff_jpeg
    x = _img(2, (2, 24, 20, 3))
    w = np.random.default_rng(3).standard_normal(x.shape)
    q = np.array([35., 90.])
    with jax.enable_x64(True):
        ref = np.asarray(jax.grad(lambda v: jnp.sum(
            jnp.asarray(w) * diff_jpeg(v, jnp.asarray(q), differentiable)))(
                jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    (torch.from_numpy(w) * port.diff_jpeg(xt, torch.as_tensor(q),
                                          differentiable)).sum().backward()
    if differentiable:
        _rel(xt.grad, ref, 1e-10)
        assert np.abs(ref).max() > 0
    else:
        assert not xt.grad.any() and not np.any(ref)
    r = torch.tensor([0.3, 1.7, -2.5], dtype=torch.float64,
                     requires_grad=True)
    port.diff_round(r).sum().backward()
    np.testing.assert_allclose(r.grad.numpy(),
                               3 * (np.array([0.3, 1.7, -2.5])
                                    - np.array([0., 2., -2.])) ** 2)


def test_quality_to_factor_and_the_nchw_wrapper():
    from bsvd_tpu.utils import diffjpeg as jdj
    q = np.array([1., 10., 49., 50., 51., 95., 100.], np.float32)
    np.testing.assert_array_equal(
        port.quality_to_factor(torch.from_numpy(q)).numpy(),
        np.asarray(jdj.quality_to_factor(q)))
    x = _img(4, (2, 17, 33, 3))
    xc = np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2)))
    with jax.enable_x64(True):
        ref = np.asarray(jdj.DiffJPEG()(jnp.asarray(xc),
                                        jnp.asarray([60., 80.])))
    got = port.DiffJPEG()(torch.from_numpy(xc), torch.tensor([60., 80.]))
    assert got.shape == xc.shape
    _rel(got, ref, 1e-10)


def test_fp32_coefficient_flips_are_bounded():
    """fp32: the quantised coefficients (``torch.round``) against JAX's
    own helpers' at one step apart on at most 1e-4 of them, and the
    port's decode of JAX's coefficients within 1e-5 x max|ref| of JAX's
    round trip."""
    from bsvd_tpu.utils import diffjpeg as jdj
    x = _img(5, (4, 48, 64, 3), np.float32)
    q = np.array([30., 50., 75., 95.], np.float32)
    factor = jnp.reshape(jdj.quality_to_factor(q), (-1, 1, 1, 1))
    y, cb, cr = jdj._chroma_subsample(jdj._rgb2ycbcr(jnp.asarray(x) * 255.))
    jc = {name: jnp.round(jdj._dct(jdj._block_split(c))
                          / (jnp.asarray(t) * factor))
          for name, c, t in (('y', y, jdj.Y_TABLE), ('cb', cb, jdj.C_TABLE),
                             ('cr', cr, jdj.C_TABLE))}
    pc = port.compress(torch.from_numpy(x), torch.from_numpy(q),
                       torch.round)
    total = flips = 0
    for name in jc:
        d = np.abs(pc[name].numpy() - np.asarray(jc[name]))
        assert d.max() <= 1
        flips += int((d > 0).sum())
        total += d.size
    assert flips <= 1e-4 * total, (flips, total)
    ref = np.asarray(jdj.diff_jpeg(jnp.asarray(x), q, False))
    got = port.decompress({k: torch.from_numpy(np.asarray(v))
                           for k, v in jc.items()}, torch.from_numpy(q),
                          48, 64)
    _rel(got, ref, 1e-5)
