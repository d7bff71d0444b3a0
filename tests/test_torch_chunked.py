"""The port's chunked MIMO protocol on CPU: ``temporal_shift_chunk``,
``wnet_apply_chunk``, ``denoise_seq(temp_psz, future_buffer_len)`` and
``BlockStreamDenoiser``, against the JAX package's functions and the
reference global queue's pinned outputs (tests/fixtures/
shift_chunked_*.npz, tsn_chunked_eval.npz; see test_arch_parity.py).

Same weights on both sides (a JAX ``wnet_init`` tree through
``from_jax_params``, or its TSN state dict through ``load_tsn_state_dict``),
inputs from numpy seeds. Tolerances: the shift is exact; fp32 nets 1e-4
absolute and relative (summation order), carries compared slot by slot;
bf16 by test_torch_seq.py's bf16-noise rule; BlockStreamDenoiser equals
denoise_seq exactly (the same chunks through the same code).
"""

import numpy as np
import pytest
import torch

from bsvd_tpu_torch.archs.wnet_arch import (WNetConfig, prepare_params,
                                            wnet_apply_chunk)
from bsvd_tpu_torch.convert.torch_ckpt import (from_jax_params,
                                               load_tsn_state_dict)
from bsvd_tpu_torch.models.seq_inference import (BlockStreamDenoiser,
                                                 denoise_seq)
from bsvd_tpu_torch.nn.shift import temporal_shift_chunk
from bsvd_tpu_torch.ops.conv3x3 import conv3x3, conv_ps
from bsvd_tpu_torch.ops.conv_chain import conv_chain
from bsvd_tpu_torch.ops.conv_s2 import conv_s2

from golden_util import golden
from reference_util import SMALL_NET2D_OPT

jax = pytest.importorskip('jax')
jnp = pytest.importorskip('jax.numpy')

TOL = dict(rtol=1e-4, atol=1e-4)
_KW = dict(chns=(8, 16, 32), mid_ch=8, interm_ch=8, norm='none',
           act='relu6')
MODES = ['TSM', 'TSM_toFutureOnly']
# (T, psz, future): look-ahead chunks then the sticky disable and a tail;
# a clip that splits evenly; no look-ahead; a look-ahead that overruns at
# once (every chunk after the first runs with future 0)
PROTOCOLS = [(12, 4, 2), (13, 4, 2), (9, 4, 0), (10, 4, 3)]


@pytest.fixture(autouse=True)
def _no_launches():
    """On CPU tensors every site runs its plain version."""
    fns = (conv3x3, conv_ps, conv_chain, conv_s2)
    for f in fns:
        f.launches = 0
    yield
    assert [f.launches for f in fns] == [0] * len(fns)


_PAIRS = {}


def _pair(mode, blind=False):
    """(JAX cfg, JAX params, port cfg, port params), one per config."""
    key = (mode, blind)
    if key not in _PAIRS:
        from bsvd_tpu.archs.wnet_arch import WNetConfig as JaxConfig
        from bsvd_tpu.archs.wnet_arch import wnet_init
        kw = dict(_KW, shift_mode=mode, blind=blind)
        jcfg, pcfg = JaxConfig(**kw), WNetConfig(**kw)
        jparams = wnet_init(jax.random.PRNGKey(40), jcfg)
        _PAIRS[key] = (jcfg, jparams, pcfg, from_jax_params(
            jax.tree.map(np.asarray, jparams), pcfg))
    return _PAIRS[key]


def _seq(seed, t, h=16, w=16):
    return np.random.default_rng(seed).uniform(
        0, 1, (t, 3, h, w)).astype(np.float32)


def _nthwc(x_nfchw):
    return np.ascontiguousarray(np.transpose(x_nfchw, (0, 1, 3, 4, 2)))


# ---------------------------------------------------------------------------
# temporal_shift_chunk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('shift_type', MODES)
def test_shift_chunk_matches_global_queue_and_jax(shift_type):
    """Three chunks of 4 + 2 look-ahead frames, carries threaded: equal to
    the reference's batch_shift + global queue and to JAX, exactly."""
    from bsvd_tpu.nn.shift import temporal_shift_chunk as jax_shift_chunk
    rng = np.random.default_rng(1)
    c, h, w = 16, 6, 6
    t_chunk, future = 4, 2
    chunks = [rng.standard_normal((t_chunk + future, c, h, w)).astype(
        np.float32) for _ in range(3)]
    ref = golden(f'shift_chunked_{shift_type}',
                 lambda: pytest.skip('fixture missing'))
    carry = jcarry = None
    for i, ch in enumerate(chunks):
        x = _nthwc(ch[None])
        got, carry = temporal_shift_chunk(torch.from_numpy(x), carry,
                                          fold_div=8, shift_type=shift_type,
                                          future_buffer_len=future)
        jgot, jcarry = jax_shift_chunk(jnp.asarray(x), jcarry, fold_div=8,
                                       shift_type=shift_type,
                                       future_buffer_len=future)
        got = got.numpy()
        np.testing.assert_array_equal(np.transpose(got, (0, 1, 4, 2, 3))[0],
                                      ref[f'ref_out_{i}'],
                                      err_msg=f'chunk {i}')
        np.testing.assert_array_equal(got, np.asarray(jgot))
        np.testing.assert_array_equal(carry.numpy(), np.asarray(jcarry))


@pytest.mark.parametrize('split', [False, True], ids=['x', 'x+x_add'])
@pytest.mark.parametrize('t_len', [1, 6])
@pytest.mark.parametrize('shift_type', MODES)
def test_chunk_site_matches_shift_chunk(shift_type, t_len, split):
    """A shift site of the chunked forward (archs/wnet_arch._ChunkShiftSite,
    on the (N*T, H, W, C) frames it sees, up1's input given as x + x_add)
    assembles frame 0 and records the carry as temporal_shift_chunk does on
    the summed chunk, with and without an incoming carry."""
    from bsvd_tpu_torch.archs.wnet_arch import _ChunkShiftSite
    rng = np.random.default_rng(3)
    n, c, h, w, future = 2, 16, 5, 7, min(2, t_len - 1)
    cfg = WNetConfig(**dict(_KW, shift_mode=shift_type))
    carry = None
    for i in range(2):
        a = rng.standard_normal((n, t_len, h, w, c)).astype(np.float32)
        b = rng.standard_normal(a.shape).astype(np.float32)
        whole = torch.from_numpy(a + b if split else a)
        want, want_carry = temporal_shift_chunk(
            whole, carry, fold_div=8, shift_type=shift_type,
            future_buffer_len=future)
        x = torch.from_numpy(a).reshape(n * t_len, h, w, c)
        x_add = torch.from_numpy(b).reshape(x.shape) if split else None
        out = [None]
        site = _ChunkShiftSite(cfg, carry, future, out, 0)
        frame0 = site.frame0(x, x_add, t_len)
        site.record(x, x_add, t_len)
        assert frame0.is_contiguous()
        np.testing.assert_array_equal(frame0.numpy(), want[:, 0].numpy(),
                                      err_msg=f'chunk {i}')
        np.testing.assert_array_equal(out[0].numpy(), want_carry.numpy())
        carry = want_carry


# ---------------------------------------------------------------------------
# wnet_apply_chunk
# ---------------------------------------------------------------------------

def test_wnet_apply_chunk_matches_reference_global_queue():
    """The eval-mode TSN over chunks (batch_shift + global queue) equals
    the port's chunked forward with carries (tsn_chunked_eval.npz)."""
    from bsvd_tpu.archs.wnet_arch import WNetConfig as JaxConfig
    from bsvd_tpu.archs.wnet_arch import wnet_init
    from bsvd_tpu.convert.torch_ckpt import params_to_tsn_state_dict
    opt = dict(SMALL_NET2D_OPT)
    kw = dict(chns=tuple(opt['chns']), mid_ch=opt['mid_ch'],
              interm_ch=opt['interm_ch'], norm=opt['norm'], act=opt['act'])
    jcfg, pcfg = JaxConfig(**kw), WNetConfig(**kw)
    state = params_to_tsn_state_dict(wnet_init(jax.random.PRNGKey(11), jcfg),
                                     jcfg)
    params = load_tsn_state_dict(state, pcfg)
    rng = np.random.default_rng(4)
    t_chunk, future, h, w = 4, 2, 16, 16
    chunks = [rng.standard_normal((1, t_chunk + future, 4, h, w)).astype(
        np.float32) for _ in range(3)]
    ref = golden('tsn_chunked_eval', lambda: pytest.skip('fixture missing'))
    carries = None
    for i, ch in enumerate(chunks):
        got, carries = wnet_apply_chunk(params, torch.from_numpy(_nthwc(ch)),
                                        pcfg, carries,
                                        future_buffer_len=future)
        np.testing.assert_allclose(
            np.transpose(got.numpy(), (0, 1, 4, 2, 3)), ref[f'ref_out_{i}'],
            err_msg=f'chunk {i}', **TOL)


@pytest.mark.parametrize('mode', MODES)
def test_wnet_apply_chunk_carries_match_jax_slot_by_slot(mode):
    """Outputs and each of the 16 carries equal JAX's, slot by slot: a
    carry sent to the wrong site would still give a plausible output."""
    from bsvd_tpu.archs.wnet_arch import wnet_apply_chunk as jax_chunk
    jcfg, jparams, pcfg, params = _pair(mode)
    rng = np.random.default_rng(5)
    carries = jcarries = None
    for i in range(3):
        x = rng.uniform(0, 1, (2, 6, 16, 16, 4)).astype(np.float32)
        got, carries = wnet_apply_chunk(params, torch.from_numpy(x), pcfg,
                                        carries, future_buffer_len=2)
        ref, jcarries = jax_chunk(jparams, jnp.asarray(x), jcfg, jcarries,
                                  future_buffer_len=2)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
        assert len(carries) == len(jcarries) == pcfg.shift_num == 16
        for k, (a, b) in enumerate(zip(carries, jcarries)):
            assert a.shape == b.shape, (k, a.shape, b.shape)
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       err_msg=f'chunk {i} slot {k}', **TOL)


def test_chunk_carry_is_the_site_input_not_its_output():
    """The first site's carry is the past lanes of down0.cv's input at
    frame T-1-future (what the stride-2 conv produced), in the compute
    dtype: recomputing that input by hand gives the same bits."""
    _, _, pcfg, params = _pair('TSM')
    p = prepare_params(params, 'cpu', torch.bfloat16)
    x = torch.from_numpy(np.random.default_rng(6).uniform(
        0, 1, (1, 6, 16, 16, 4)).astype(np.float32)).to(torch.bfloat16)
    _, carries = wnet_apply_chunk(p, x, pcfg, None, future_buffer_len=2)
    s0 = p['stage0']
    x0 = conv_chain(x[0], s0['inc']['c1'], None, s0['inc']['c2'], None,
                    pcfg.act, pcfg.act)
    x1 = conv_s2(x0, s0['down0']['conv'], act=pcfg.act)
    fold = x1.shape[-1] // pcfg.fold_div
    assert carries[0].dtype == torch.bfloat16
    assert carries[0].shape == (1, 1, 8, 8, fold)
    torch.testing.assert_close(carries[0][0, 0], x1[3, ..., fold:2 * fold],
                               rtol=0, atol=0)


# ---------------------------------------------------------------------------
# denoise_seq(temp_psz, future_buffer_len)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('blind', [False, True], ids=['noise_map', 'blind'])
@pytest.mark.parametrize('mode', MODES)
@pytest.mark.parametrize('t,psz,future', PROTOCOLS)
def test_denoise_seq_chunked_matches_jax(t, psz, future, mode, blind):
    from bsvd_tpu.models.seq_inference import denoise_seq as jax_denoise
    jcfg, jparams, pcfg, params = _pair(mode, blind)
    seq = _seq(50 + t + future, t)
    sigma = None if blind else 30 / 255
    ref = jax_denoise(jparams, jcfg, seq, noise_sigma=sigma, temp_psz=psz,
                      future_buffer_len=future)
    got = denoise_seq(params, pcfg, seq, noise_sigma=sigma, temp_psz=psz,
                      future_buffer_len=future)
    assert got.dtype == np.float32 and got.shape == (t, 3, 16, 16)
    assert got.min() >= 0 and got.max() <= 1
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize('mode', MODES)
def test_denoise_seq_chunked_bf16_matches_jax(mode):
    """bf16 rounds at every conv output and the frameworks sum in other
    orders: the port's mean |bf16 - JAX bf16| stays within 2x JAX's mean
    |bf16 - fp32|, and its PSNR against fp32 no more than 1 dB below
    JAX's."""
    from bsvd_tpu.models.seq_inference import denoise_seq as jax_denoise
    jcfg, jparams, pcfg, params = _pair(mode)
    seq = _seq(60, 13)
    kw = dict(noise_sigma=0.1, temp_psz=4, future_buffer_len=2)
    ref32 = jax_denoise(jparams, jcfg, seq, **kw)
    ref16 = jax_denoise(jparams, jcfg, seq, compute_dtype=jnp.bfloat16, **kw)
    got = denoise_seq(params, pcfg, seq, compute_dtype=torch.bfloat16, **kw)
    assert np.abs(got - ref16).mean() <= 2 * np.abs(ref16 - ref32).mean()

    def psnr(a):
        return 10 * np.log10(1 / np.mean((a - ref32) ** 2))
    assert psnr(got) > psnr(ref16) - 1.0, (psnr(got), psnr(ref16))


def test_chunk_schedules_and_modes_give_one_array():
    """``host_chunks``, ``device_program`` and ``mode='streaming'`` change
    nothing on the chunked protocol, as in the JAX package (whose three
    schedules tests/test_streaming.py holds equal)."""
    _, _, pcfg, params = _pair('TSM')
    seq = _seq(61, 13)
    kw = dict(noise_sigma=0.1, temp_psz=4, future_buffer_len=2)
    base = denoise_seq(params, pcfg, seq, **kw)
    for extra in (dict(host_chunks=True), dict(device_program=True),
                  dict(mode='streaming')):
        np.testing.assert_array_equal(denoise_seq(params, pcfg, seq, **kw,
                                                  **extra), base)


def test_chunked_differs_from_whole_clip_for_tsm():
    """The chunked protocol is its own function for a bidirectional net
    (each chunk's look-ahead ends), not the whole clip: the two differ."""
    _, _, pcfg, params = _pair('TSM')
    seq = _seq(62, 12)
    whole = denoise_seq(params, pcfg, seq, noise_sigma=0.1)
    chunked = denoise_seq(params, pcfg, seq, noise_sigma=0.1, temp_psz=4,
                          future_buffer_len=0)
    assert np.abs(whole - chunked).max() > 1e-3


# ---------------------------------------------------------------------------
# BlockStreamDenoiser
# ---------------------------------------------------------------------------

def _frames(seq, sigma):
    """(T, 3, H, W) -> T frames (1, H, W, 4)."""
    x = np.concatenate([seq, np.full_like(seq[:, :1], sigma)], axis=1)
    return [f[None] for f in np.transpose(x, (0, 2, 3, 1))]


def _drive(bsd, frames, block=None):
    outs = []
    if block is None:
        for f in frames:
            got = bsd.push(f)
            assert len(got) in (0, bsd.psz)
            outs += got
    else:
        for i in range(0, len(frames), block):
            outs += bsd.push_block(frames[i:i + block])
    return outs + bsd.flush()


@pytest.mark.parametrize('mode', MODES)
@pytest.mark.parametrize('t,psz,future', PROTOCOLS)
def test_block_stream_equals_denoise_seq_and_jax(t, psz, future, mode):
    from bsvd_tpu.models.seq_inference import (
        BlockStreamDenoiser as JaxBlockStream)
    jcfg, jparams, pcfg, params = _pair(mode)
    seq = _seq(70 + t, t)
    frames = _frames(seq, 0.1)
    want = denoise_seq(params, pcfg, seq, noise_sigma=0.1, temp_psz=psz,
                       future_buffer_len=future)
    bsd = BlockStreamDenoiser(params, pcfg, psz=psz, future_buffer_len=future)
    assert bsd.latency == psz - 1 + future
    for block in (None, 3):
        bsd.reset()
        outs = _drive(bsd, [torch.from_numpy(f) for f in frames], block)
        got = torch.stack(outs, dim=1)[0].permute(0, 3, 1, 2).numpy()
        np.testing.assert_array_equal(got, want)
    ref = _drive(JaxBlockStream(jparams, jcfg, psz=psz,
                                future_buffer_len=future), frames)
    ref = np.transpose(np.stack([np.asarray(o) for o in ref], axis=1)[0],
                       (0, 3, 1, 2))
    np.testing.assert_allclose(got, ref, **TOL)


def test_block_stream_short_stream_raises_as_jax():
    """A stream too short for the reflect-padded tail raises ValueError in
    both packages (2 frames at psz 4: the tail needs 2 earlier frames)."""
    from bsvd_tpu.models.seq_inference import (
        BlockStreamDenoiser as JaxBlockStream)
    jcfg, jparams, pcfg, params = _pair('TSM')
    frames = _frames(_seq(80, 2), 0.1)
    bsd = BlockStreamDenoiser(params, pcfg, psz=4, future_buffer_len=0)
    jbsd = JaxBlockStream(jparams, jcfg, psz=4, future_buffer_len=0)
    for f in frames:
        assert bsd.push(torch.from_numpy(f)) == []
        jbsd.push(f)
    with pytest.raises(ValueError, match='too short'):
        bsd.flush()
    with pytest.raises(ValueError, match='too short'):
        jbsd.flush()


def test_block_stream_mesh_raises_not_implemented():
    """A mesh of one process (world size 1) gives the unsharded client's
    frames exactly; a mesh that is not a parallel.mesh.Mesh raises
    TypeError (multi-rank meshes: tests/test_torch_spatial.py)."""
    from bsvd_tpu_torch.parallel.mesh import make_mesh
    _, _, pcfg, params = _pair('TSM')
    with pytest.raises(TypeError, match='Mesh'):
        BlockStreamDenoiser(params, pcfg, mesh=object())
    frames = _frames(_seq(81, 7), 0.1)
    outs = []
    for bsd in (BlockStreamDenoiser(params, pcfg, psz=3, future_buffer_len=1,
                                    mesh=make_mesh()),
                BlockStreamDenoiser(params, pcfg, psz=3,
                                    future_buffer_len=1)):
        got = []
        for f in frames:
            got += bsd.push(torch.from_numpy(f))
        outs.append(torch.stack(got + bsd.flush()))
    assert outs[0].shape[0] == len(frames)
    assert torch.equal(outs[0], outs[1])


def test_no_shift_chunk_is_the_per_frame_forward_unlike_jax():
    """shift_mode='none' has no temporal mixing: the port's chunked forward
    equals its whole-chunk forward and carries nothing. The JAX package's
    chunked path shifts there as TSM (its _cvblock_apply takes the chunk
    site before looking at shift_mode, and temporal_shift_chunk treats
    'none' as 'TSM'): a reference-side fault, pinned, not copied."""
    from bsvd_tpu.archs.wnet_arch import wnet_apply as jax_apply
    from bsvd_tpu.archs.wnet_arch import wnet_apply_chunk as jax_chunk
    from bsvd_tpu_torch.archs.wnet_arch import wnet_apply
    jcfg, jparams, pcfg, params = _pair('none')
    x = np.random.default_rng(7).uniform(0, 1, (1, 6, 16, 16, 4)).astype(
        np.float32)
    got, carries = wnet_apply_chunk(params, torch.from_numpy(x), pcfg, None,
                                    future_buffer_len=2)
    assert carries == [None] * 16
    np.testing.assert_array_equal(
        got.numpy(), wnet_apply(params, torch.from_numpy(x), pcfg).numpy())
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jax_apply(jparams, jnp.asarray(x), jcfg)),
        **TOL)
    ref, _ = jax_chunk(jparams, jnp.asarray(x), jcfg, None,
                       future_buffer_len=2)
    assert np.abs(np.asarray(ref) - got.numpy()).max() > 0.1
