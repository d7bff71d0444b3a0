"""The port's streaming BiBufferConv steps (bsvd_tpu_torch.ops.bibuffer_conv)
on CPU, i.e. their plain PyTorch versions, against the JAX package: its XLA
oracles (``bibuffer_*_reference``) and, once each, its Pallas kernels in
interpret mode with an explicit row block, as tests/test_pallas_kernel.py
runs them.

Inputs come from numpy seeds; weights are HWIO for JAX and OIHW for the
port. fp32 throughout: outputs within 1e-4 absolute and relative
(summation order only); states are pure channel copies and compared
exactly, except the chain's s2', which carries computed conv1 outputs.
On CPU tensors no wrapper launches a kernel.
"""

import numpy as np
import pytest
import torch

from bsvd_tpu_torch.ops.bibuffer_conv import (bibuffer_chain, bibuffer_conv,
                                              bibuffer_multi)
from torch_threads import one_torch_thread  # noqa: F401

jnp = pytest.importorskip('jax.numpy')

TOL = dict(rtol=1e-4, atol=1e-4)
H, W, C, C1, CO = 12, 16, 16, 24, 16


def _conv_np(rng, cin, cout):
    """(HWIO for JAX, OIHW torch tensor, bias numpy, bias torch)."""
    w = (rng.standard_normal((3, 3, cin, cout)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    return (w, torch.from_numpy(np.transpose(w, (3, 2, 0, 1)).copy()), b,
            torch.from_numpy(b))


def _arr(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.fixture(autouse=True)
def _no_launches():
    fns = (bibuffer_conv, bibuffer_multi, bibuffer_chain)
    for f in fns:
        f.launches = 0
    yield
    assert [f.launches for f in fns] == [0, 0, 0]


@pytest.mark.parametrize('act', ['relu6', 'none'])
@pytest.mark.parametrize('causal', [False, True])
def test_bibuffer_conv_matches_jax(causal, act):
    from bsvd_tpu.ops.bibuffer_conv import bibuffer_conv_reference
    rng = np.random.default_rng(51)
    x, st = _arr(rng, (1, H, W, C)), _arr(rng, (1, H, W, C))
    wj, wt, b, bt = _conv_np(rng, C, C1)
    ry, rs = bibuffer_conv_reference(jnp.asarray(x), jnp.asarray(st),
                                     jnp.asarray(wj), jnp.asarray(b),
                                     act=act, causal=causal)
    gy, gs = bibuffer_conv(torch.from_numpy(x), torch.from_numpy(st), wt, bt,
                           act=act, causal=causal)
    np.testing.assert_allclose(gy.numpy(), np.asarray(ry), **TOL)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(rs))


@pytest.mark.parametrize('act', ['relu6', 'none'])
@pytest.mark.parametrize('causal', [False, True])
@pytest.mark.parametrize('nf', [1, 2, 5])
def test_bibuffer_multi_matches_jax(nf, causal, act):
    from bsvd_tpu.ops.bibuffer_conv import bibuffer_multi_reference
    rng = np.random.default_rng(54)
    x, st = _arr(rng, (nf, H, W, C)), _arr(rng, (1, H, W, C))
    wj, wt, b, bt = _conv_np(rng, C, C1)
    ry, rs = bibuffer_multi_reference(jnp.asarray(x), jnp.asarray(st),
                                      jnp.asarray(wj), jnp.asarray(b),
                                      act=act, causal=causal)
    gy, gs = bibuffer_multi(torch.from_numpy(x), torch.from_numpy(st), wt, bt,
                            act=act, causal=causal)
    assert gy.shape == (nf, H, W, C1)
    np.testing.assert_allclose(gy.numpy(), np.asarray(ry), **TOL)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(rs))


@pytest.mark.parametrize('causal', [False, True])
def test_bibuffer_multi_streams_match_jax_per_stream(causal):
    """(F, N, H, W, C) frames of N streams == each stream on its own."""
    from bsvd_tpu.ops.bibuffer_conv import bibuffer_multi_reference
    rng = np.random.default_rng(55)
    nf, n = 3, 2
    x, st = _arr(rng, (nf, n, H, W, C)), _arr(rng, (n, H, W, C))
    wj, wt, b, bt = _conv_np(rng, C, C1)
    gy, gs = bibuffer_multi(torch.from_numpy(x), torch.from_numpy(st), wt, bt,
                            causal=causal)
    assert gy.shape == (nf, n, H, W, C1)
    for k in range(n):
        ry, rs = bibuffer_multi_reference(
            jnp.asarray(x[:, k]), jnp.asarray(st[k:k + 1]), jnp.asarray(wj),
            jnp.asarray(b), causal=causal)
        np.testing.assert_allclose(gy[:, k].numpy(), np.asarray(ry), **TOL)
        np.testing.assert_array_equal(gs[k:k + 1].numpy(), np.asarray(rs))


@pytest.mark.parametrize('act', ['relu6', 'none'])
@pytest.mark.parametrize('causal', [False, True])
def test_bibuffer_chain_matches_jax(causal, act):
    from bsvd_tpu.ops.bibuffer_conv import bibuffer_chain_reference
    rng = np.random.default_rng(53)
    x, s1, s2 = (_arr(rng, (1, H, W, C)), _arr(rng, (1, H, W, C)),
                 _arr(rng, (1, H, W, C1)))
    w1j, w1t, b1, b1t = _conv_np(rng, C, C1)
    w2j, w2t, b2, b2t = _conv_np(rng, C1, CO)
    ry, rs1, rs2 = bibuffer_chain_reference(
        *map(jnp.asarray, (x, s1, s2, w1j, b1, w2j, b2)), act=act, act2=act,
        causal=causal)
    gy, gs1, gs2 = bibuffer_chain(*map(torch.from_numpy, (x, s1, s2)), w1t,
                                  b1t, w2t, b2t, act=act, act2=act,
                                  causal=causal)
    np.testing.assert_allclose(gy.numpy(), np.asarray(ry), **TOL)
    np.testing.assert_array_equal(gs1.numpy(), np.asarray(rs1))
    np.testing.assert_allclose(gs2.numpy(), np.asarray(rs2), **TOL)


@pytest.mark.parametrize('causal', [False, True])
def test_bibuffer_conv_matches_pallas(causal):
    from bsvd_tpu.ops.bibuffer_conv import bibuffer_conv_pallas
    rng = np.random.default_rng(52)
    x, st = _arr(rng, (1, H, W, C)), _arr(rng, (1, H, W, C))
    wj, wt, b, bt = _conv_np(rng, C, C1)
    py, ps = bibuffer_conv_pallas(*map(jnp.asarray, (x, st, wj, b)), bh=4,
                                  causal=causal, interpret=True)
    gy, gs = bibuffer_conv(torch.from_numpy(x), torch.from_numpy(st), wt, bt,
                           causal=causal)
    np.testing.assert_allclose(gy.numpy(), np.asarray(py), **TOL)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ps))


@pytest.mark.parametrize('causal', [False, True])
def test_bibuffer_multi_matches_pallas(causal):
    from bsvd_tpu.ops.bibuffer_conv import bibuffer_multi_pallas
    rng = np.random.default_rng(56)
    x, st = _arr(rng, (5, H, W, C)), _arr(rng, (1, H, W, C))
    wj, wt, b, bt = _conv_np(rng, C, C1)
    py, ps = bibuffer_multi_pallas(*map(jnp.asarray, (x, st, wj, b)), bh=3,
                                   causal=causal, interpret=True)
    gy, gs = bibuffer_multi(torch.from_numpy(x), torch.from_numpy(st), wt, bt,
                            causal=causal)
    np.testing.assert_allclose(gy.numpy(), np.asarray(py), **TOL)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ps))


@pytest.mark.parametrize('causal', [False, True])
def test_bibuffer_chain_matches_pallas(causal):
    from bsvd_tpu.ops.bibuffer_conv import bibuffer_chain_pallas
    rng = np.random.default_rng(57)
    x, s1, s2 = (_arr(rng, (1, H, W, C)), _arr(rng, (1, H, W, C)),
                 _arr(rng, (1, H, W, C1)))
    w1j, w1t, b1, b1t = _conv_np(rng, C, C1)
    w2j, w2t, b2, b2t = _conv_np(rng, C1, CO)
    py, ps1, ps2 = bibuffer_chain_pallas(
        *map(jnp.asarray, (x, s1, s2, w1j, b1, w2j, b2)), bh=4,
        causal=causal, interpret=True)
    gy, gs1, gs2 = bibuffer_chain(*map(torch.from_numpy, (x, s1, s2)), w1t,
                                  b1t, w2t, b2t, causal=causal)
    np.testing.assert_allclose(gy.numpy(), np.asarray(py), **TOL)
    np.testing.assert_array_equal(gs1.numpy(), np.asarray(ps1))
    np.testing.assert_allclose(gs2.numpy(), np.asarray(ps2), **TOL)


# (C, C1, Cout): fold 5 (conv2's 16-channel slices straddle the y1 and s2
# lanes), C1 != C != Cout
_CHAIN_SHAPES = {'fold5': (40, 40, 40), 'c16_c32_c24': (16, 32, 24)}


@pytest.mark.parametrize('causal', [False, True])
@pytest.mark.parametrize('shape', sorted(_CHAIN_SHAPES))
def test_bibuffer_chain_shapes_match_pallas(shape, causal):
    from bsvd_tpu.ops.bibuffer_conv import bibuffer_chain_pallas
    c, c1, co = _CHAIN_SHAPES[shape]
    rng = np.random.default_rng(59)
    x, s1, s2 = (_arr(rng, (1, H, W, c)), _arr(rng, (1, H, W, c)),
                 _arr(rng, (1, H, W, c1)))
    w1j, w1t, b1, b1t = _conv_np(rng, c, c1)
    w2j, w2t, b2, b2t = _conv_np(rng, c1, co)
    py, ps1, ps2 = bibuffer_chain_pallas(
        *map(jnp.asarray, (x, s1, s2, w1j, b1, w2j, b2)), bh=4,
        causal=causal, interpret=True)
    gy, gs1, gs2 = bibuffer_chain(*map(torch.from_numpy, (x, s1, s2)), w1t,
                                  b1t, w2t, b2t, causal=causal)
    assert gy.shape == (1, H, W, co)
    np.testing.assert_allclose(gy.numpy(), np.asarray(py), **TOL)
    np.testing.assert_array_equal(gs1.numpy(), np.asarray(ps1))
    np.testing.assert_allclose(gs2.numpy(), np.asarray(ps2), **TOL)


@pytest.mark.parametrize('causal', [False, True])
def test_conv2_reads_only_the_chain_lanes(causal):
    """The lane rule K6 relies on: y1's lanes [f2:] (bidirectional) or
    [:2f2] (causal) reach s2' but not conv2's output, in JAX's oracle and
    in the port's plain step alike."""
    from bsvd_tpu.ops.bibuffer_conv import bibuffer_conv_reference
    rng = np.random.default_rng(60)
    c1 = 32
    f2 = c1 // 8
    y1, s2 = _arr(rng, (1, H, W, c1)), _arr(rng, (1, H, W, c1))
    wj, wt, b, bt = _conv_np(rng, c1, CO)
    unread = slice(0, 2 * f2) if causal else slice(f2, None)
    y1b = y1.copy()
    y1b[..., unread] = _arr(rng, y1b[..., unread].shape)
    outs = []
    for v in (y1, y1b):
        jy, js = bibuffer_conv_reference(jnp.asarray(v), jnp.asarray(s2),
                                         jnp.asarray(wj), jnp.asarray(b),
                                         causal=causal)
        ty, ts = bibuffer_conv(torch.from_numpy(v), torch.from_numpy(s2), wt,
                               bt, causal=causal)
        outs.append((np.asarray(jy), np.asarray(js), ty.numpy(), ts.numpy()))
    (jy, js, ty, ts), (jy2, js2, ty2, ts2) = outs
    np.testing.assert_array_equal(jy2, jy)
    np.testing.assert_array_equal(ty2, ty)
    assert not np.array_equal(js2, js) and not np.array_equal(ts2, ts)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(ts2, js2)


def test_bibuffer_chain_is_two_steps():
    """The chain's (y, s1', s2') == two single steps of the port."""
    rng = np.random.default_rng(58)
    x, s1, s2 = (torch.from_numpy(_arr(rng, (2, H, W, C))),
                 torch.from_numpy(_arr(rng, (2, H, W, C))),
                 torch.from_numpy(_arr(rng, (2, H, W, C1))))
    _, w1, _, b1 = _conv_np(rng, C, C1)
    _, w2, _, b2 = _conv_np(rng, C1, CO)
    y, n1, n2 = bibuffer_chain(x, s1, s2, w1, b1, w2, b2)
    y1, r1 = bibuffer_conv(x, s1, w1, b1)
    y2, r2 = bibuffer_conv(y1, s2, w2, b2)
    for got, ref in ((y, y2), (n1, r1), (n2, r2)):
        np.testing.assert_array_equal(got.numpy(), ref.numpy())


def test_bibuffer_shape_checks():
    x = torch.zeros((1, 8, 8, 16))
    w = torch.zeros((16, 16, 3, 3))
    with pytest.raises(ValueError):
        bibuffer_conv(x, torch.zeros((1, 8, 8, 8)), w)
    with pytest.raises(ValueError):
        bibuffer_multi(torch.zeros((2, 2, 8, 8, 16)), x, w)
    with pytest.raises(ValueError):
        bibuffer_chain(x, x, torch.zeros((1, 8, 8, 8)), w, None, w, None)
