"""The port's kernel entry points on CPU (their plain PyTorch versions)
against the JAX package: each Pallas kernel in interpret mode with an
explicit small row block, and its XLA oracle.

Inputs come from numpy seeds and go to both frameworks as arrays; weights
are HWIO for JAX and OIHW for the port. Everything is fp32; tolerance
1e-4 absolute and relative (summation order only). On CPU tensors no
wrapper launches a kernel, so every launch counter stays 0.
"""

import numpy as np
import pytest
import torch

from bsvd_tpu_torch.nn.layers import pixel_shuffle, conv_init
from bsvd_tpu_torch.nn.shift import temporal_shift
from bsvd_tpu_torch.ops._pack import ConvWeights
from bsvd_tpu_torch.ops.conv3x3 import (conv3x3, conv3x3_dw,
                                        conv3x3_dw_reference, conv_ps)
from bsvd_tpu_torch.ops.conv_chain import (conv_chain, conv_chain_add2,
                                           conv_chain_add2_res)
from bsvd_tpu_torch.ops.conv_s2 import conv_s2
from bsvd_tpu_torch.ops.shift_conv import shift_conv, shift_conv_add2

jnp = pytest.importorskip('jax.numpy')

TOL = dict(rtol=1e-4, atol=1e-4)


def _arrays(rng, *shapes, scale=1.0):
    return [(rng.standard_normal(s) * scale).astype(np.float32)
            for s in shapes]


def _conv_np(rng, cin, cout):
    """(HWIO for JAX, OIHW torch tensor, bias numpy)."""
    w = (rng.standard_normal((3, 3, cin, cout)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    return w, torch.from_numpy(np.transpose(w, (3, 2, 0, 1)).copy()), b


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _check(got, ref):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), **TOL)


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors run the plain versions: no kernel is ever launched."""
    fns = (conv3x3, conv_ps, conv_chain, conv_s2, conv3x3_dw)
    for f in fns:
        f.launches = 0
    yield
    assert [f.launches for f in fns] == [0] * len(fns)


# ---- K1 conv3x3 ------------------------------------------------------------

@pytest.mark.parametrize('case', ['none', 'tsm', 'causal', 'tsm_x2',
                                  'causal_x2', 'two_clips', 'relu', 'noact'])
def test_conv3x3_matches_pallas(case):
    from bsvd_tpu.ops.conv3x3 import _conv3x3_xla, conv3x3_pallas
    from bsvd_tpu.ops.shift_conv import shift_conv_reference
    rng = np.random.default_rng(11)
    t_len, h, w, c, co = 4, 12, 16, 16, 24
    nt = 8 if case == 'two_clips' else t_len
    shift = ('tsm' if case in ('tsm', 'tsm_x2', 'two_clips', 'relu', 'noact')
             else 'causal' if case.startswith('causal') else 'none')
    act = {'relu': 'relu', 'noact': 'none'}.get(case, 'relu6')
    x, x2 = _arrays(rng, (nt, h, w, c), (nt, h, w, c))
    if not case.endswith('x2'):
        x2 = None
    wj, wt, b = _conv_np(rng, c, co)
    got = conv3x3(_t(x), wt, _t(b), None if x2 is None else _t(x2),
                  t_len=t_len, shift=shift, act=act)
    pallas = conv3x3_pallas(jnp.asarray(x), jnp.asarray(wj), jnp.asarray(b),
                            None if x2 is None else jnp.asarray(x2),
                            t_len=t_len, shift=shift, act=act, bh=4,
                            interpret=True)
    _check(got, pallas)
    xs = x if x2 is None else x + x2
    if shift == 'none':
        oracle = _conv3x3_xla(jnp.asarray(xs), jnp.asarray(wj),
                              jnp.asarray(b), act)
    else:
        oracle = shift_conv_reference(jnp.asarray(xs), jnp.asarray(wj),
                                      jnp.asarray(b), t_len=t_len, act=act,
                                      causal=shift == 'causal')
    _check(got, oracle)


@pytest.mark.parametrize('causal', [False, True])
def test_shift_conv_wrappers(causal):
    from bsvd_tpu.ops.shift_conv import shift_conv_reference
    rng = np.random.default_rng(12)
    x, x2 = _arrays(rng, (6, 8, 8, 16), (6, 8, 8, 16))
    wj, wt, b = _conv_np(rng, 16, 16)
    got = shift_conv(_t(x), wt, _t(b), 3, 8, 'relu6', causal)
    ref = shift_conv_reference(jnp.asarray(x), jnp.asarray(wj),
                               jnp.asarray(b), t_len=3, causal=causal)
    _check(got, ref)
    got2 = shift_conv_add2(_t(x), _t(x2), wt, _t(b), 3, 8, 'relu6', causal)
    ref2 = shift_conv_reference(jnp.asarray(x + x2), jnp.asarray(wj),
                                jnp.asarray(b), t_len=3, causal=causal)
    _check(got2, ref2)


# ---- K4 conv_ps ------------------------------------------------------------

@pytest.mark.parametrize('nt', [1, 2])
def test_conv_ps_matches_pallas(nt):
    from bsvd_tpu.ops.conv3x3 import (_conv_ps_natural_xla,
                                      conv_ps_fold_pallas,
                                      conv_ps_natural_pallas)
    rng = np.random.default_rng(13)
    h, w, c, co = 8, 16, 16, 32
    (x,) = _arrays(rng, (nt, h, w, c))
    wj, wt, b = _conv_np(rng, c, co)
    got = conv_ps(_t(x), wt, _t(b)).numpy()
    assert got.shape == (nt, 2 * h, 2 * w, co // 4)
    xj, wjj, bj = jnp.asarray(x), jnp.asarray(wj), jnp.asarray(b)
    _check(got, conv_ps_natural_pallas(xj, wjj, bj, bh=4, interpret=True))
    folded = conv_ps_fold_pallas(xj, wjj, bj, bh=4, interpret=True)
    _check(got, np.asarray(folded).reshape(nt, 2 * h, 2 * w, co // 4))
    _check(got, _conv_ps_natural_xla(xj, wjj, bj))


@pytest.mark.parametrize('c4', [16, 64, 128])
def test_conv_ps_permuted_pack_matches_pallas(c4):
    """K4's index map in plain PyTorch: a conv with the sub-pixel-major
    packed weights (``order='ps'``), then packed channel block s written
    to sub-pixel (s // 2, s % 2), equals conv_ps_reference and the Pallas
    kernel in interpret mode."""
    from bsvd_tpu.ops.conv3x3 import conv_ps_natural_pallas
    from bsvd_tpu_torch.nn.layers import conv2d
    from bsvd_tpu_torch.ops.conv3x3 import conv_ps_reference
    rng = np.random.default_rng(30 + c4)
    nt, h, w, c, co = 2, 4, 8, 8, 4 * c4
    (x,) = _arrays(rng, (nt, h, w, c))
    wj, wt, b = _conv_np(rng, c, co)
    wp, bp = ConvWeights(wt, _t(b)).packed('cpu', torch.float32, order='ps')
    assert wp.shape == (-(-co // 128) * 128, 3, 3, 16)
    y = conv2d(_t(x), wp[:co, :, :, :c].permute(0, 3, 1, 2), bp[:co])
    got = torch.empty((nt, 2 * h, 2 * w, c4))
    for s in range(4):
        got[:, s // 2::2, s % 2::2] = y[..., s * c4:(s + 1) * c4]
    _check(got, conv_ps_reference(_t(x), wt, _t(b)))
    _check(got, conv_ps_natural_pallas(jnp.asarray(x), jnp.asarray(wj),
                                       jnp.asarray(b), bh=4, interpret=True))


# ---- K3 conv_s2 ------------------------------------------------------------

@pytest.mark.parametrize('act', ['relu6', 'relu', 'none'])
def test_conv_s2_matches_pallas(act):
    from bsvd_tpu.nn.layers import conv2d as jconv2d, get_act
    from bsvd_tpu.ops.conv3x3 import fold_width_stride2_weights
    from bsvd_tpu.ops.conv_s2 import conv_s2_pallas
    rng = np.random.default_rng(14)
    nt, h, w, c, co = 3, 12, 16, 8, 16
    (x,) = _arrays(rng, (nt, h, w, c))
    wj, wt, b = _conv_np(rng, c, co)
    got = conv_s2(_t(x), wt, _t(b), act=act)
    assert tuple(got.shape) == (nt, h // 2, w // 2, co)
    w2, b2 = fold_width_stride2_weights(jnp.asarray(wj), jnp.asarray(b))
    xf = jnp.asarray(x).reshape(nt, h, w // 2, 2 * c)
    _check(got, conv_s2_pallas(xf, w2, b2, act=act, bh=2, interpret=True))
    oracle = get_act(act)(jconv2d({'w': jnp.asarray(wj), 'b': jnp.asarray(b)},
                                  jnp.asarray(x), stride=2))
    _check(got, oracle)


def test_conv_s2_odd_size_matches_xla():
    from bsvd_tpu.nn.layers import conv2d as jconv2d
    rng = np.random.default_rng(15)
    (x,) = _arrays(rng, (2, 9, 11, 4))
    wj, wt, b = _conv_np(rng, 4, 8)
    got = conv_s2(_t(x), wt, _t(b), act='none')
    ref = jconv2d({'w': jnp.asarray(wj), 'b': jnp.asarray(b)},
                  jnp.asarray(x), stride=2)
    _check(got, ref)


# ---- K2 conv_chain ---------------------------------------------------------

@pytest.mark.parametrize('case', ['plain', 'add2', 'relu_both'])
def test_conv_chain_matches_pallas(case):
    from bsvd_tpu.ops.conv_chain import _chain_xla, conv_chain_pallas
    rng = np.random.default_rng(16)
    nt, h, w, c, c1, co = 3, 12, 16, 16, 24, 8
    act2 = 'relu6' if case == 'relu_both' else 'none'
    x, x2 = _arrays(rng, (nt, h, w, c), (nt, h, w, c))
    w1j, w1t, b1 = _conv_np(rng, c, c1)
    w2j, w2t, b2 = _conv_np(rng, c1, co)
    if case == 'add2':
        got = conv_chain_add2(_t(x), _t(x2), w1t, _t(b1), w2t, _t(b2),
                              'relu6', act2)
    else:
        x2 = None
        got = conv_chain(_t(x), w1t, _t(b1), w2t, _t(b2), 'relu6', act2)
    j = [jnp.asarray(a) for a in (x, w1j, b1, w2j, b2)]
    x2j = None if x2 is None else jnp.asarray(x2)
    _check(got, conv_chain_pallas(*j, x2j, act1='relu6', act2=act2, bh=4,
                                  interpret=True))
    _check(got, _chain_xla(*j, 'relu6', act2, x2=x2j))


def test_conv_chain_res_matches_folded_pallas():
    """Natural residual rule (first rc channels become x_res - y) == the
    TPU kernel's folded lane rule (lane % (cout/2) < rc) after unfolding,
    when x_res has the output's channel count."""
    from bsvd_tpu.ops.conv3x3 import fold_width_weights
    from bsvd_tpu.ops.conv_chain import conv_chain_pallas
    rng = np.random.default_rng(17)
    nt, h, w, c, c1, co, rc = 2, 8, 16, 8, 16, 8, 3
    x, x2, xr = _arrays(rng, (nt, h, w, c), (nt, h, w, c), (nt, h, w, co))
    w1j, w1t, b1 = _conv_np(rng, c, c1)
    w2j, w2t, b2 = _conv_np(rng, c1, co)
    got = conv_chain_add2_res(_t(x), _t(x2), _t(xr), w1t, _t(b1), w2t,
                              _t(b2), 'relu6', 'none', rc)
    w1f, b1f = fold_width_weights(jnp.asarray(w1j), jnp.asarray(b1))
    w2f, b2f = fold_width_weights(jnp.asarray(w2j), jnp.asarray(b2))

    def fold(a):
        return jnp.asarray(a).reshape(nt, h, w // 2, 2 * a.shape[-1])
    folded = conv_chain_pallas(fold(x), w1f, b1f, w2f, b2f, fold(x2),
                               fold(xr), act1='relu6', act2='none',
                               res_ch=rc, bh=4, folded=True, interpret=True)
    _check(got, np.asarray(folded).reshape(nt, h, w, co))


@pytest.mark.parametrize('cres', [4, 16])
def test_conv_chain_res_matches_natural_stage(cres):
    """x_res with its own channel count (the stage input: 4 or 64 in
    BSVD-c64): out[..., :rc] = x_res[..., :rc] - y[..., :rc], as the JAX
    natural _stage_apply computes it."""
    from bsvd_tpu.ops.conv_chain import _chain_xla
    rng = np.random.default_rng(18)
    nt, h, w, c, c1, co, rc = 2, 8, 12, 16, 16, 3, 3
    x, x2, xr = _arrays(rng, (nt, h, w, c), (nt, h, w, c), (nt, h, w, cres))
    w1j, w1t, b1 = _conv_np(rng, c, c1)
    w2j, w2t, b2 = _conv_np(rng, c1, co)
    got = conv_chain_add2_res(_t(x), _t(x2), _t(xr), w1t, _t(b1), w2t,
                              _t(b2), 'relu6', 'none', rc)
    y = _chain_xla(*[jnp.asarray(a) for a in (x, w1j, b1, w2j, b2)],
                   'relu6', 'none', x2=jnp.asarray(x2))
    ref = jnp.concatenate([jnp.asarray(xr)[..., :rc] - y[..., :rc],
                           y[..., rc:]], axis=-1)
    _check(got, ref)


# ---- plain layers ------------------------------------------------------------

@pytest.mark.parametrize('shift_type', ['TSM', 'TSM_toFutureOnly'])
def test_temporal_shift_matches_jax(shift_type):
    from bsvd_tpu.nn.shift import temporal_shift as jshift
    rng = np.random.default_rng(19)
    (x,) = _arrays(rng, (2, 5, 4, 4, 16))
    got = temporal_shift(_t(x), 8, shift_type)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jshift(jnp.asarray(x), 8,
                                                    shift_type)))


def test_pixel_shuffle_matches_torch_and_jax():
    from bsvd_tpu.nn.layers import pixel_shuffle as jps
    rng = np.random.default_rng(20)
    (x,) = _arrays(rng, (2, 5, 7, 12))
    got = pixel_shuffle(_t(x), 2)
    ref = torch.nn.PixelShuffle(2)(_t(x).permute(0, 3, 1, 2)).permute(
        0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), ref.numpy())
    np.testing.assert_array_equal(got.numpy(), np.asarray(jps(jnp.asarray(x))))


def test_conv_init_statistics():
    """Kaiming-normal fan-in weights and uniform +-1/sqrt(fan_in) bias."""
    g = torch.Generator().manual_seed(0)
    p = conv_init(64, 128, generator=g)
    assert p['w'].shape == (128, 64, 3, 3)
    fan_in = 64 * 9
    std = (2 / fan_in) ** 0.5
    assert abs(p['w'].std().item() - std) < 0.05 * std
    assert p['b'].abs().max().item() <= fan_in ** -0.5


def test_conv_weights_packing():
    """Kernel layout (CoutP, 3, 3, CinP): zero padded to 64 / 16."""
    rng = np.random.default_rng(21)
    _, wt, b = _conv_np(rng, 4, 3)
    wp, bp = ConvWeights(wt, _t(b)).packed('cpu', torch.float32)
    assert wp.shape == (64, 3, 3, 16) and bp.shape == (64,)
    np.testing.assert_array_equal(wp[:3, :, :, :4].numpy(),
                                  wt.permute(0, 2, 3, 1).numpy())
    assert wp[3:].abs().sum() == 0 and wp[:, :, :, 4:].abs().sum() == 0
    np.testing.assert_array_equal(bp[:3].numpy(), b)
    assert bp[3:].abs().sum() == 0


# ---- K7 conv3x3_dw ---------------------------------------------------------

@pytest.mark.parametrize('nt,bh', [(1, 4), (3, 6)])
def test_conv3x3_dw_matches_pallas_and_xla(nt, bh):
    """The weight gradient's plain version (OIHW) against the JAX Pallas
    kernel in interpret mode and the JAX XLA path (both HWIO)."""
    from bsvd_tpu.ops.conv3x3 import conv3x3_dw as jdw, conv3x3_dw_pallas
    rng = np.random.default_rng(70 + nt)
    x, dz = _arrays(rng, (nt, 12, 16, 16), (nt, 12, 16, 8))
    got = conv3x3_dw(_t(x), _t(dz))
    assert got.shape == (8, 16, 3, 3) and got.dtype == torch.float32
    for ref in (conv3x3_dw_pallas(jnp.asarray(x), jnp.asarray(dz), bh=bh,
                                  interpret=True),
                jdw(jnp.asarray(x), jnp.asarray(dz))):
        _check(got, np.transpose(np.asarray(ref), (3, 2, 0, 1)))


@pytest.mark.parametrize('shift', ['tsm', 'causal'])
def test_conv3x3_dw_of_shifted_sum(shift):
    """With a shift and a second addend, the weight gradient is the plain
    one of shift(x + x2): the JAX XLA weight gradient of that input."""
    from bsvd_tpu.nn.shift import temporal_shift as jshift
    from bsvd_tpu.ops.conv3x3 import conv3x3_dw as jdw
    rng = np.random.default_rng(72)
    x, x2, dz = _arrays(rng, (6, 8, 16, 16), (6, 8, 16, 16), (6, 8, 16, 24))
    mode = 'TSM' if shift == 'tsm' else 'TSM_toFutureOnly'
    v = jshift(jnp.asarray(x + x2).reshape(2, 3, 8, 16, 16), 8,
               mode).reshape(6, 8, 16, 16)
    got = conv3x3_dw(_t(x), _t(dz), _t(x2), t_len=3, shift=shift)
    _check(got, np.transpose(np.asarray(jdw(v, jnp.asarray(dz))),
                             (3, 2, 0, 1)))
    with pytest.raises(ValueError):
        conv3x3_dw(_t(x), _t(dz), t_len=4, shift=shift)
    np.testing.assert_array_equal(
        conv3x3_dw_reference(_t(x), _t(dz), _t(x2), t_len=3,
                             shift=shift).numpy(), got.numpy())
