"""The port's whole-clip denoise_seq on CPU against the JAX package's
denoise_seq (temp_psz=-1, mode='mimo'; the chunked protocol is in
test_torch_chunked.py) and against the reference torch
net's pinned synthetic-clip output and PSNR (fixtures/synthetic_clip_psnr.npz,
see test_arch_parity.test_synthetic_clip_denoise_psnr_anchor).

fp32: tolerance 1e-4 absolute and relative, PSNR within 1e-3 dB (as the
JAX anchor test). bf16: see test_denoise_seq_bf16_matches_jax.
"""

import numpy as np
import pytest
import torch

from bsvd_tpu_torch.archs import build_network
from bsvd_tpu_torch.archs.wnet_arch import WNetConfig
from bsvd_tpu_torch.convert.torch_ckpt import (from_jax_params,
                                               load_tsn_state_dict)
from bsvd_tpu_torch.models.seq_inference import denoise_seq

from golden_util import golden
from reference_util import SMALL_NET2D_OPT
from torch_threads import one_torch_thread  # noqa: F401

jax = pytest.importorskip('jax')
jnp = pytest.importorskip('jax.numpy')

_KW = dict(chns=(16, 32, 64), mid_ch=16, interm_ch=16, norm='none',
           act='relu6')


def _pair(seed, **over):
    from bsvd_tpu.archs.wnet_arch import WNetConfig as JaxConfig, wnet_init
    jcfg, pcfg = JaxConfig(**_KW, **over), WNetConfig(**_KW, **over)
    jparams = wnet_init(jax.random.PRNGKey(seed), jcfg)
    return jcfg, jparams, pcfg, from_jax_params(
        jax.tree.map(np.asarray, jparams), pcfg)


def _clip(seed, t=6, h=16, w=24):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 1, (t, 3, h, w)).astype(np.float32)


@pytest.mark.parametrize('over', [{}, dict(shift_mode='TSM_toFutureOnly'),
                                  dict(blind=True)])
def test_denoise_seq_matches_jax(over):
    from bsvd_tpu.models.seq_inference import denoise_seq as jax_denoise
    jcfg, jparams, pcfg, params = _pair(20, **over)
    seq = _clip(21)
    sigma = None if pcfg.blind else 30 / 255
    ref = jax_denoise(jparams, jcfg, seq, noise_sigma=sigma, temp_psz=-1)
    got = denoise_seq(params, pcfg, seq, noise_sigma=sigma, temp_psz=-1)
    assert got.dtype == np.float32 and got.shape == (6, 3, 16, 24)
    assert got.min() >= 0 and got.max() <= 1
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_denoise_seq_bf16_matches_jax():
    """bf16 rounds at every conv output; the two frameworks sum in other
    orders, so their bf16 outputs may differ by what bf16 itself costs:
    the port's mean |bf16 - JAX bf16| stays within 2x JAX's mean
    |bf16 - fp32|, and the port's bf16 PSNR against fp32 is no more than
    1 dB below JAX's."""
    from bsvd_tpu.models.seq_inference import denoise_seq as jax_denoise
    jcfg, jparams, pcfg, params = _pair(22)
    seq = _clip(23)
    ref32 = jax_denoise(jparams, jcfg, seq, noise_sigma=0.1)
    ref16 = jax_denoise(jparams, jcfg, seq, noise_sigma=0.1,
                        compute_dtype=jnp.bfloat16)
    got = denoise_seq(params, pcfg, seq, noise_sigma=0.1,
                      compute_dtype=torch.bfloat16)
    bf16_cost = np.abs(ref16 - ref32).mean()
    assert np.abs(got - ref16).mean() <= 2 * bf16_cost

    def psnr(a):
        return 10 * np.log10(1 / np.mean((a - ref32) ** 2))
    assert psnr(got) > psnr(ref16) - 1.0, (psnr(got), psnr(ref16))


def test_synthetic_clip_psnr_anchor():
    from bsvd_tpu.archs.wnet_arch import WNetConfig as JaxConfig, wnet_init
    from bsvd_tpu.convert.torch_ckpt import params_to_tsn_state_dict
    opt = dict(SMALL_NET2D_OPT)
    kw = dict(chns=tuple(opt['chns']), mid_ch=opt['mid_ch'],
              interm_ch=opt['interm_ch'], norm=opt['norm'], act=opt['act'])
    jcfg, pcfg = JaxConfig(**kw), WNetConfig(**kw)
    state = params_to_tsn_state_dict(wnet_init(jax.random.PRNGKey(13), jcfg),
                                     jcfg)
    rng = np.random.default_rng(6)
    t, h, w = 8, 32, 32
    clean = rng.uniform(0, 1, (1, t, 3, h, w)).astype(np.float32)
    sigma = 25 / 255.0
    noisy = (clean + sigma * rng.standard_normal(clean.shape)
             ).astype(np.float32)
    g = golden('synthetic_clip_psnr', lambda: pytest.skip('fixture missing'))

    net = build_network(dict(opt, type='BSVD'), device='cpu')
    net.load_params(load_tsn_state_dict(state, pcfg))
    out = denoise_seq(net, None, noisy[0], noise_sigma=sigma, temp_psz=-1)
    np.testing.assert_allclose(out, g['ref_den'][0], rtol=1e-4, atol=1e-4)
    psnr = 10 * np.log10(1.0 / float(np.mean((out[None] - clean) ** 2)))
    assert abs(psnr - float(g['ref_psnr'])) < 1e-3, (psnr, g['ref_psnr'])


def test_whole_clip_temp_psz_at_least_t_is_whole_clip():
    """temp_psz >= T is the whole-clip protocol, as in the JAX package."""
    _, _, pcfg, params = _pair(26)
    seq = _clip(27)
    a = denoise_seq(params, pcfg, seq, noise_sigma=0.1, temp_psz=-1)
    b = denoise_seq(params, pcfg, seq, noise_sigma=0.1, temp_psz=6)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('mode', ['mimo', 'streaming'])
def test_jax_signature_runs_the_whole_clip(mode):
    """A call written for the JAX signature (its argument order, its
    look-ahead and chunk-loop switches) runs the whole clip: on it
    ``future_buffer_len``, ``host_chunks`` and ``device_program`` change
    nothing, as in the JAX package, which gives the same frames."""
    from bsvd_tpu.models.seq_inference import denoise_seq as jax_denoise
    jcfg, jparams, pcfg, params = _pair(28)
    seq = _clip(29)
    plain = denoise_seq(params, pcfg, seq, noise_sigma=0.1, mode=mode)
    positional = denoise_seq(params, pcfg, seq, 0.1, -1, 2, mode, None, None,
                             True, True)
    keyword = denoise_seq(params, pcfg, seq, noise_sigma=0.1, temp_psz=-1,
                          future_buffer_len=2, mode=mode, host_chunks=True,
                          device_program=True)
    np.testing.assert_array_equal(positional, plain)
    np.testing.assert_array_equal(keyword, plain)
    ref = jax_denoise(jparams, jcfg, seq, 0.1, -1, 2, mode)
    np.testing.assert_allclose(plain, ref, rtol=1e-4, atol=1e-4)


def test_mesh_raises_not_implemented():
    """A mesh that is not a parallel.mesh.Mesh raises TypeError; a mesh of
    one process (world size 1) gives the unsharded array exactly
    (multi-rank meshes: tests/test_torch_spatial.py)."""
    from bsvd_tpu_torch.parallel.mesh import make_mesh
    _, _, pcfg, params = _pair(30)
    with pytest.raises(TypeError, match='Mesh'):
        denoise_seq(params, pcfg, _clip(31), noise_sigma=0.1,
                    mesh=object())
    got = denoise_seq(params, pcfg, _clip(31), noise_sigma=0.1,
                      mesh=make_mesh())
    np.testing.assert_array_equal(got, denoise_seq(params, pcfg, _clip(31),
                                                   noise_sigma=0.1))
