"""The port's streaming path (bsvd_tpu_torch.archs.streaming) on CPU against
the JAX package's streaming (bsvd_tpu/archs/streaming.py) and against the
port's whole-clip MIMO ``wnet_apply``.

Same weights on both sides (a JAX ``wnet_init`` tree through
``from_jax_params``), inputs from numpy seeds. fp32 throughout; tolerance
1e-4 absolute and relative (summation order only). On CPU tensors every
site runs its plain version, so no kernel launches.
"""

import numpy as np
import pytest
import torch

from bsvd_tpu_torch.archs import build_network
from bsvd_tpu_torch.archs.streaming import (StreamDenoiser, pipeline_latency,
                                            stream_init, stream_step,
                                            stream_step_block,
                                            streaming_apply)
from bsvd_tpu_torch.archs.wnet_arch import WNetConfig, wnet_apply
from bsvd_tpu_torch.convert.torch_ckpt import (from_jax_params,
                                               from_jax_stream_state)
from bsvd_tpu_torch.models.seq_inference import denoise_seq
from bsvd_tpu_torch.ops.bibuffer_conv import (bibuffer_chain, bibuffer_conv,
                                              bibuffer_multi)
from bsvd_tpu_torch.ops.conv3x3 import conv3x3, conv_ps
from bsvd_tpu_torch.ops.conv_chain import conv_chain
from bsvd_tpu_torch.ops.conv_s2 import conv_s2
from torch_threads import one_torch_thread  # noqa: F401

jax = pytest.importorskip('jax')
jnp = pytest.importorskip('jax.numpy')

TOL = dict(rtol=1e-4, atol=1e-4)
_KW = dict(chns=(8, 16, 32), mid_ch=8, interm_ch=8, norm='none',
           act='relu6')


@pytest.fixture(autouse=True)
def _no_launches():
    fns = (conv3x3, conv_ps, conv_chain, conv_s2, bibuffer_conv,
           bibuffer_multi, bibuffer_chain)
    for f in fns:
        f.launches = 0
    yield
    assert [f.launches for f in fns] == [0] * len(fns)


def _pair(seed, **over):
    from bsvd_tpu.archs.wnet_arch import WNetConfig as JaxConfig, wnet_init
    kw = dict(_KW, **over)
    jcfg, pcfg = JaxConfig(**kw), WNetConfig(**kw)
    jparams = wnet_init(jax.random.PRNGKey(seed), jcfg)
    return jcfg, jparams, pcfg, from_jax_params(
        jax.tree.map(np.asarray, jparams), pcfg)


def _clip(seed, n, t, h, w, c):
    return np.random.default_rng(seed).standard_normal(
        (n, t, h, w, c)).astype(np.float32)


@pytest.mark.parametrize('variant', ['base', 'blind', 'stage1', 'short_clip',
                                     'batch2', 'causal'])
def test_streaming_apply_matches_jax_and_mimo(variant):
    from bsvd_tpu.archs.streaming import streaming_apply as jax_streaming
    over = {'blind': dict(blind=True), 'stage1': dict(stage_num=1),
            'causal': dict(shift_mode='TSM_toFutureOnly')}.get(variant, {})
    t = 5 if variant == 'short_clip' else 20
    n = 2 if variant == 'batch2' else 1
    jcfg, jparams, pcfg, params = _pair(30, **over)
    x = _clip(31, n, t, 16, 16, pcfg.effective_in_ch)
    ref = np.asarray(jax_streaming(jparams, jnp.asarray(x), jcfg))
    got = streaming_apply(params, torch.from_numpy(x), pcfg)
    assert got.shape == ref.shape == (n, t, 16, 16, 3)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    mimo = wnet_apply(params, torch.from_numpy(x), pcfg)
    np.testing.assert_allclose(got.numpy(), mimo.numpy(), **TOL)


def test_pipeline_latency():
    assert pipeline_latency(WNetConfig(**_KW)) == 16
    assert pipeline_latency(WNetConfig(**_KW, stage_num=1)) == 8
    assert pipeline_latency(
        WNetConfig(**_KW, shift_mode='TSM_toFutureOnly')) == 0


def _push_all(sd, x):
    outs = []
    for i in range(x.shape[1]):
        o = sd.push(x[:, i])
        if o is not None:
            outs.append(o)
    return outs


def test_stream_denoiser_push_flush_reset():
    _, _, cfg, params = _pair(32)
    x = torch.from_numpy(_clip(33, 1, 20, 16, 16, 4))
    mimo = wnet_apply(params, x, cfg)
    sd = StreamDenoiser(params, cfg, batch=1, height=16, width=16)
    assert sd.latency == 16
    outs = _push_all(sd, x)
    assert len(outs) == 20 - sd.latency
    outs += sd.flush()
    assert len(outs) == 20
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), mimo.numpy(),
                               **TOL)
    assert sd.flush() == []
    # reset and reuse reproduces the same outputs
    sd.reset()
    out0 = None
    for i in range(sd.latency + 1):
        out0 = sd.push(x[:, i])
    np.testing.assert_allclose(out0.numpy(), mimo[:, 0].numpy(), **TOL)


def test_stream_denoiser_flush_short_clip():
    """Fewer pushes than the pipeline depth: flush drains the whole latency
    and returns exactly the pushed frames."""
    _, _, cfg, params = _pair(34)
    x = torch.from_numpy(_clip(35, 1, 5, 16, 16, 4))
    sd = StreamDenoiser(params, cfg, batch=1, height=16, width=16)
    assert all(sd.push(x[:, i]) is None for i in range(5))
    outs = sd.flush()
    assert len(outs) == 5
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(),
                               wnet_apply(params, x, cfg).numpy(), **TOL)
    assert sd.flush() == []


def test_stream_denoiser_causal_zero_latency():
    _, _, cfg, params = _pair(36, shift_mode='TSM_toFutureOnly')
    x = torch.from_numpy(_clip(37, 1, 6, 16, 16, 4))
    mimo = wnet_apply(params, x, cfg)
    sd = StreamDenoiser(params, cfg, batch=1, height=16, width=16)
    for i in range(6):
        out = sd.push(x[:, i])
        assert out is not None, 'the causal net has zero latency'
        np.testing.assert_allclose(out.numpy(), mimo[:, i].numpy(), **TOL)
    assert sd.flush() == []


@pytest.mark.parametrize('shift_mode', ['TSM', 'TSM_toFutureOnly'])
@pytest.mark.parametrize('n', [1, 2])
def test_push_block_equals_push(shift_mode, n):
    """push_block (fill: F pushes; steady: K5 over F frames per temporal
    conv) == per-frame push, outputs and final state."""
    _, _, cfg, params = _pair(38, shift_mode=shift_mode)
    x = torch.from_numpy(_clip(39, n, 24, 16, 16, 4))
    a = StreamDenoiser(params, cfg, batch=n, height=16, width=16)
    b = StreamDenoiser(params, cfg, batch=n, height=16, width=16)
    ref = _push_all(a, x)
    got = []
    for i in range(0, 24, 4):
        block = x[:, i:i + 4].transpose(0, 1)       # (F, N, H, W, C)
        got += [o for o in b.push_block(block) if o is not None]
    assert len(got) == len(ref) == 24 - a.latency
    np.testing.assert_allclose(torch.stack(got).numpy(),
                               torch.stack(ref).numpy(), **TOL)
    for sa, sb in zip(a.state, b.state):
        for k in ('down0', 'down1', 'up2', 'up1'):
            for pa, pb in zip(sa[k], sb[k]):
                np.testing.assert_allclose(pa['packed'].numpy(),
                                           pb['packed'].numpy(), **TOL)
    fa, fb = a.flush(), b.flush()
    assert len(fa) == len(fb) == a.latency
    for oa, ob in zip(fa, fb):
        np.testing.assert_allclose(ob.numpy(), oa.numpy(), **TOL)


def _compare_state(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert sorted(g) == sorted(r)
        for k in ('down0', 'down1', 'up2', 'up1'):
            for gb, rb in zip(g[k], r[k]):
                assert gb['has_center'] == rb['has_center']
                np.testing.assert_allclose(gb['packed'].numpy(),
                                           rb['packed'].numpy(), **TOL)
        for k in ('skip1', 'skip2', 'skip3'):
            assert (g[k]['w'], g[k]['r']) == (r[k]['w'], r[k]['r']), k
            np.testing.assert_allclose(g[k]['buf'].numpy(),
                                       r[k]['buf'].numpy(), **TOL)


@pytest.mark.parametrize('k', [3, 18])
@pytest.mark.parametrize('shift_mode', ['TSM', 'TSM_toFutureOnly'])
def test_state_after_k_pushes_matches_jax(shift_mode, k):
    """The port's StreamDenoiser.state after k pushes (filling, steady) ==
    the JAX StreamDenoiser's, through from_jax_stream_state; a port stream
    resumed from the JAX state gives the JAX outputs."""
    from bsvd_tpu.archs.streaming import StreamDenoiser as JaxStream
    jcfg, jparams, pcfg, params = _pair(40, shift_mode=shift_mode)
    x = _clip(41, 1, k + 3, 16, 16, 4)
    js = JaxStream(jparams, jcfg, batch=1, height=16, width=16)
    ps = StreamDenoiser(params, pcfg, batch=1, height=16, width=16)
    for i in range(k):
        js.push(jnp.asarray(x[:, i]))
        ps.push(torch.from_numpy(x[:, i]))
    jstate = from_jax_stream_state(jax.tree.map(np.asarray, js.state), pcfg)
    _compare_state(ps.state, jstate)

    resumed = StreamDenoiser(params, pcfg, batch=1, height=16, width=16)
    resumed.state, resumed._pushed = jstate, k
    for i in range(k, k + 3):
        ref = js.push(jnp.asarray(x[:, i]))
        got = resumed.push(torch.from_numpy(x[:, i]))
        assert (ref is None) == (got is None)
        if got is not None:
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_stream_step_block_equals_steps():
    """stream_step_block == F stream_step calls from a primed state."""
    _, _, cfg, params = _pair(42)
    x = torch.from_numpy(_clip(43, 1, 21, 16, 16, 4))
    state = stream_init(cfg, 1, 16, 16, device='cpu')
    for i in range(16):
        state, _ = stream_step(params, state, x[:, i], cfg)
    s_ref = [dict(st, **{k: dict(st[k], buf=st[k]['buf'].clone())
                         for k in ('skip1', 'skip2', 'skip3')})
             for st in state]
    ref = []
    for i in range(16, 21):
        s_ref, out = stream_step(params, s_ref, x[:, i], cfg)
        assert out is not None
        ref.append(out)
    _, outs = stream_step_block(params, state, x[:, 16:21].transpose(0, 1),
                                cfg)
    np.testing.assert_allclose(outs.numpy(), torch.stack(ref).numpy(), **TOL)


@pytest.mark.parametrize('shift_mode', ['TSM', 'TSM_toFutureOnly'])
def test_streaming_c64_widths(shift_mode):
    """BSVD-c64's widths (chns 64/128/256, mid/interm 64) on 16x24 frames:
    streaming == the port's MIMO == JAX MIMO."""
    from bsvd_tpu.archs.wnet_arch import wnet_apply as jax_apply
    opt = dict(chns=(64, 128, 256), mid_ch=64, interm_ch=64,
               shift_mode=shift_mode)
    jcfg, jparams, pcfg, params = _pair(44, **opt)
    x = _clip(45, 1, 18, 16, 24, 4)
    got = streaming_apply(params, torch.from_numpy(x), pcfg)
    np.testing.assert_allclose(
        got.numpy(), wnet_apply(params, torch.from_numpy(x), pcfg).numpy(),
        **TOL)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jax_apply(jparams, jnp.asarray(x), jcfg)),
        **TOL)


@pytest.mark.parametrize('chain_max_c', [0, 128, 256])
@pytest.mark.parametrize('shift_mode', ['TSM', 'TSM_toFutureOnly'])
def test_streaming_apply_routes_match_jax(shift_mode, chain_max_c,
                                          monkeypatch):
    """streaming_apply by each MemCvBlock route (``CHAIN_MAX_C`` set: every
    MemCvBlock by two K5 steps, the 16-channel ones by K6, or every one by
    K6) against JAX streaming, with MemCvBlocks of 16 and 160 channels; the
    chain wrapper runs exactly where ``chain_route`` says."""
    from bsvd_tpu.archs.streaming import streaming_apply as jax_streaming
    from bsvd_tpu_torch.archs import streaming
    monkeypatch.setattr(streaming, 'CHAIN_MAX_C', chain_max_c)
    widths = []

    def counted(x, *args, **kw):
        widths.append(x.shape[-1])
        return bibuffer_chain(x, *args, **kw)
    monkeypatch.setattr(streaming, 'bibuffer_chain', counted)
    jcfg, jparams, pcfg, params = _pair(50, chns=(8, 16, 160),
                                        shift_mode=shift_mode)
    x = _clip(51, 1, 20, 16, 16, pcfg.effective_in_ch)
    got = streaming_apply(params, torch.from_numpy(x), pcfg)
    ref = np.asarray(jax_streaming(jparams, jnp.asarray(x), jcfg))
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    assert set(widths) == {c for c in (16, 160) if streaming.chain_route(c)}


@pytest.mark.parametrize('over', [{}, dict(shift_mode='TSM_toFutureOnly'),
                                  dict(blind=True)])
def test_denoise_seq_streaming_equals_mimo_and_jax(over):
    from bsvd_tpu.models.seq_inference import denoise_seq as jax_denoise
    jcfg, jparams, pcfg, params = _pair(46, **over)
    seq = np.random.default_rng(47).uniform(
        0, 1, (10, 3, 16, 24)).astype(np.float32)
    sigma = None if pcfg.blind else 30 / 255
    got = denoise_seq(params, pcfg, seq, noise_sigma=sigma, mode='streaming')
    assert got.dtype == np.float32 and got.shape == (10, 3, 16, 24)
    mimo = denoise_seq(params, pcfg, seq, noise_sigma=sigma, mode='mimo')
    np.testing.assert_allclose(got, mimo, **TOL)
    ref = jax_denoise(jparams, jcfg, seq, noise_sigma=sigma,
                      mode='streaming')
    np.testing.assert_allclose(got, ref, **TOL)


def test_stream_denoiser_from_build_network():
    """build_network -> StreamDenoiser on the module (its cached weights)
    == the module's MIMO forward; numpy frames are accepted."""
    net = build_network(dict(_KW, type='BSVD', seed=3), device='cpu')
    rng = np.random.default_rng(48)
    x = rng.uniform(0, 1, (1, 18, 16, 16, 4)).astype(np.float32)
    sd = StreamDenoiser(net, None, batch=1, height=16, width=16)
    outs = [o for i in range(18) if (o := sd.push(x[:, i])) is not None]
    outs += sd.flush()
    ref = net(torch.from_numpy(x).permute(0, 1, 4, 2, 3)).permute(
        0, 1, 3, 4, 2)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), ref.numpy(),
                               **TOL)


def test_stream_denoiser_rejects_mesh_and_odd_sizes():
    """A mesh that is not a parallel.mesh.Mesh, and sizes off the stride-2
    grids, raise; a mesh of one process (world size 1) leaves the client
    unsharded."""
    from bsvd_tpu_torch.parallel.mesh import make_mesh
    _, _, cfg, params = _pair(49)
    with pytest.raises(TypeError, match='Mesh'):
        StreamDenoiser(params, cfg, batch=1, height=16, width=16,
                       mesh=object())
    assert StreamDenoiser(params, cfg, batch=1, height=16, width=16,
                          mesh=make_mesh()).mesh is None
    with pytest.raises(ValueError):
        StreamDenoiser(params, cfg, batch=1, height=18, width=16)
