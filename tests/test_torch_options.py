"""The WNet options of the port on CPU against the JAX package: shift_input,
norms 'bn' and 'in', remat, and the raw (in 5 / out 4 / residual 4) and
c32-blind configs, on every path: whole clip (``wnet_apply``), streaming
(``streaming_apply``, ``StreamDenoiser``, ``stream_step_block``), chunked
(``wnet_apply_chunk`` carries, ``denoise_seq(temp_psz)``,
``BlockStreamDenoiser``), the train step and the checkpoints.

Same weights on both sides (a JAX ``wnet_init`` tree, its BN leaves given
seeded non-trivial statistics, through ``from_jax_params``), inputs from
numpy seeds, fp32 unless a test says otherwise. Tolerances, with their
reasons:

- forwards, streams, chunks and carries: 1e-4 absolute and relative
  (summation order; BN folded into the convs on the port's side, applied
  after them on JAX's: one more rounding per site);
- gradients against ``jax.grad`` of the JAX net in float64: 1e-4 x
  max|ref| per tensor (as tests/test_torch_train.py);
- BN running statistics after SGD steps: 1e-5 (as the JAX package's own
  test against the reference torch BN, test_train_pipeline.py);
- remat against no remat: the same ops recomputed in the same order, so
  the same bits (checked with ``torch.equal``).

On CPU tensors no wrapper launches a kernel (checked).
"""

import copy
import logging

import numpy as np
import pytest
import torch

from bsvd_tpu_torch.archs import build_network
from bsvd_tpu_torch.archs.streaming import (StreamDenoiser, pipeline_latency,
                                            stream_init, stream_step,
                                            stream_step_block,
                                            streaming_apply)
from bsvd_tpu_torch.archs.wnet_arch import (TSN, WNetConfig, _map_tree,
                                            _to_tree, fold_bn,
                                            wnet_apply, wnet_apply_chunk,
                                            wnet_init)
from bsvd_tpu_torch.convert.torch_ckpt import (from_jax_params,
                                               from_jax_stream_state,
                                               load_tsn_state_dict,
                                               to_jax_params,
                                               to_tsn_state_dict)
from bsvd_tpu_torch.losses import build_loss
from bsvd_tpu_torch.models.checkpoint import (load_npz_params,
                                              save_npz_params)
from bsvd_tpu_torch.models.seq_inference import (BlockStreamDenoiser,
                                                 denoise_seq)
from bsvd_tpu_torch.nn.layers import bn_update
from bsvd_tpu_torch.ops.bibuffer_conv import (bibuffer_chain, bibuffer_conv,
                                              bibuffer_multi)
from bsvd_tpu_torch.ops.conv3x3 import conv3x3, conv3x3_dw, conv_ps
from bsvd_tpu_torch.ops.conv_chain import conv_chain
from bsvd_tpu_torch.ops.conv_s2 import conv_s2

from golden_util import golden
from reference_util import SMALL_NET2D_OPT

jax = pytest.importorskip('jax')
jnp = pytest.importorskip('jax.numpy')

TOL = dict(rtol=1e-4, atol=1e-4)
_KW = dict(chns=(8, 16, 32), mid_ch=8, interm_ch=8, norm='none',
           act='relu6')
# one config per option, at the small widths (raw and c32 at their own
# channel counts, their widths scaled like the rest)
VARIANTS = {
    'shift_input': dict(shift_input=True),
    'shift_input_causal': dict(shift_input=True,
                               shift_mode='TSM_toFutureOnly'),
    'shift_input_blind': dict(shift_input=True, blind=True),
    'bn': dict(norm='bn'),
    'bn_shift_input': dict(norm='bn', shift_input=True),
    'in': dict(norm='in'),
    'in_causal': dict(norm='in', shift_mode='TSM_toFutureOnly'),
    'raw': dict(in_ch=5, out_ch=4, residual_ch=4),
    'c32_blind': dict(chns=(32, 64, 128), mid_ch=32, interm_ch=32,
                      blind=True),
    'remat': dict(remat=True),
}
COUNTED = (conv3x3, conv_ps, conv_chain, conv_s2, conv3x3_dw, bibuffer_conv,
           bibuffer_multi, bibuffer_chain)


@pytest.fixture(autouse=True)
def _no_launches():
    for f in COUNTED:
        f.launches = 0
    yield
    assert [f.launches for f in COUNTED] == [0] * len(COUNTED)


def _bn_stats(tree, rng):
    """Seeded non-trivial BN leaves (scale, bias, running mean and var) in
    a JAX tree, in place; a tree without BN is left as it is."""
    if isinstance(tree, dict):
        if 'mean' in tree:
            ch = tree['mean'].shape[0]
            tree['scale'] = rng.uniform(0.5, 1.5, ch).astype(np.float32)
            tree['bias'] = rng.uniform(-0.2, 0.2, ch).astype(np.float32)
            tree['mean'] = rng.uniform(-0.3, 0.3, ch).astype(np.float32)
            tree['var'] = rng.uniform(0.5, 2.0, ch).astype(np.float32)
            return
        for v in tree.values():
            _bn_stats(v, rng)


def _pair(variant, seed=30, **extra):
    """(JAX cfg, JAX params as numpy, port cfg, port params)."""
    from bsvd_tpu.archs.wnet_arch import WNetConfig as JaxConfig
    from bsvd_tpu.archs.wnet_arch import wnet_init as jax_init
    kw = dict(_KW, **VARIANTS[variant], **extra)
    jcfg, pcfg = JaxConfig(**kw), WNetConfig(**kw)
    jparams = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(seed),
                                                jcfg))
    _bn_stats(jparams, np.random.default_rng(seed))
    return jcfg, jparams, pcfg, from_jax_params(jparams, pcfg)


def _clip(seed, n, t, h, w, c):
    return np.random.default_rng(seed).uniform(
        0, 1, (n, t, h, w, c)).astype(np.float32)


# ---------------------------------------------------------------------------
# config and init
# ---------------------------------------------------------------------------

def test_config_takes_every_option():
    """shift_num counts the inc sites of shift_input; the latency follows
    it; wnet_init gives BN leaves for 'bn' only and the inc CvBlock's
    widths (s_in -> c0 -> c0) for shift_input; TSN takes remat, BSVD
    (an inference net, as the JAX package's) warns that it ignores it."""
    cfg = WNetConfig(**_KW, shift_input=True)
    assert cfg.shift_num == 20 and pipeline_latency(cfg) == 20
    assert pipeline_latency(WNetConfig(**_KW, shift_input=True,
                                       shift_mode='TSM_toFutureOnly')) == 0
    assert WNetConfig(**_KW, shift_input=True, stage_num=1).shift_num == 10
    inc = wnet_init(cfg)['stage0']['inc']
    assert inc['c1']['w'].shape == (8, 4, 3, 3)
    assert inc['c2']['w'].shape == (8, 8, 3, 3) and 'n1' not in inc
    bn = wnet_init(WNetConfig(**dict(_KW, norm='bn')))['stage1']
    assert set(bn['down0']['n']) == {'scale', 'bias', 'mean', 'var'}
    assert 'n1' not in wnet_init(WNetConfig(**dict(_KW, norm='in')))[
        'stage0']['inc']
    tsn = TSN(net2d_opt=dict(SMALL_NET2D_OPT, remat=True, norm='bn'))
    assert tsn.cfg.remat and tsn.cfg.norm == 'bn'
    assert {n for n, _ in tsn.named_buffers()} and not any(
        n.endswith(('.mean', '.var')) for n, _ in tsn.named_parameters())
    seen = []
    handler = logging.Handler()
    handler.emit = lambda record: seen.append(record.getMessage())
    logger = logging.getLogger('bsvd_tpu_torch')
    logger.addHandler(handler)
    try:
        net = build_network(dict(SMALL_NET2D_OPT, type='BSVD', norm='in',
                                 shift_input=True, remat=True), device='cpu')
    finally:
        logger.removeHandler(handler)
    assert net.cfg.shift_input and not net.cfg.remat and net.shift_num == 20
    assert any(m.startswith('BSVD: ignoring unknown network option(s)')
               and "'remat'" in m for m in seen)


# ---------------------------------------------------------------------------
# whole clip
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('variant', list(VARIANTS))
def test_wnet_apply_matches_jax(variant):
    """Norm 'in' is held against JAX in float64: its 4x4 quarter-resolution
    maps divide by their own spread, where JAX's fp32 on XLA:CPU lands
    1.3e-4 from its float64 and the port's fp32 7.7e-5 (the two float64
    forwards agree to 2e-13)."""
    from bsvd_tpu.archs.wnet_arch import wnet_apply as jax_apply
    jcfg, jparams, pcfg, params = _pair(variant)
    x = _clip(31, 2, 5, 16, 16, pcfg.effective_in_ch)
    dt = jnp.float64 if pcfg.norm == 'in' else jnp.float32
    with jax.enable_x64(pcfg.norm == 'in'):
        ref = np.asarray(jax_apply(jax.tree.map(lambda a: jnp.asarray(a, dt),
                                                jparams),
                                   jnp.asarray(x, dt), jcfg), np.float32)
    got = wnet_apply(params, torch.from_numpy(x), pcfg)
    assert got.shape == ref.shape == (2, 5, 16, 16, pcfg.out_ch)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_module_forward_folds_bn_and_renews_the_fold():
    """The BSVD module's forward (prepared, BN folded) equals wnet_apply on
    its raw tree; the cached fold is renewed when a weight or a running
    statistic changes in place (an optimizer step, bn_update)."""
    _, _, cfg, params = _pair('bn')
    net = build_network(dict(_KW, type='BSVD', norm='bn'), device='cpu')
    net.load_params(params)
    x = torch.from_numpy(_clip(32, 1, 3, 16, 16, 4))

    def check():
        got = net(x.permute(0, 1, 4, 2, 3)).permute(0, 1, 3, 4, 2)
        ref = wnet_apply(net.param_tree(), x, net.cfg)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)
        return got
    y0, p0 = check(), net.prepared('cpu', torch.float32)
    assert net.prepared('cpu', torch.float32) is p0
    with torch.no_grad():
        net.params['stage0']['inc']['c1']['w'].mul_(1.1)
    y1 = check()
    assert net.prepared('cpu', torch.float32) is not p0
    p1 = net.prepared('cpu', torch.float32)
    leaf = _to_tree(net.params)['stage0']['down0']['n']
    bn_update([(leaf, leaf['mean'] + 1.0, leaf['var'] * 2, 8)])
    y2 = check()
    assert net.prepared('cpu', torch.float32) is not p1
    assert not torch.equal(y0, y1) and not torch.equal(y1, y2)


# ---------------------------------------------------------------------------
# streaming
# ---------------------------------------------------------------------------

STREAM_VARIANTS = ['shift_input', 'shift_input_causal', 'bn', 'in',
                   'raw']


@pytest.mark.parametrize('variant', STREAM_VARIANTS)
def test_streaming_apply_matches_jax_and_mimo(variant):
    from bsvd_tpu.archs.streaming import streaming_apply as jax_streaming
    jcfg, jparams, pcfg, params = _pair(variant)
    x = _clip(33, 1, 6, 16, 16, pcfg.effective_in_ch)
    ref = np.asarray(jax_streaming(jparams, jnp.asarray(x), jcfg))
    got = streaming_apply(params, torch.from_numpy(x), pcfg)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    mimo = wnet_apply(params, torch.from_numpy(x), pcfg)
    np.testing.assert_allclose(got.numpy(), mimo.numpy(), **TOL)


def _compare_state(got, ref):
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert set(a) == set(b)
        for k in a:
            if k.startswith('skip'):
                np.testing.assert_allclose(a[k]['buf'].numpy(),
                                           b[k]['buf'].numpy(), **TOL)
                assert (a[k]['w'] - a[k]['r']) == (b[k]['w'] - b[k]['r'])
            else:
                for sa, sb in zip(a[k], b[k]):
                    assert sa['has_center'] == sb['has_center']
                    np.testing.assert_allclose(sa['packed'].numpy(),
                                               sb['packed'].numpy(), **TOL)


@pytest.mark.parametrize('variant', ['shift_input', 'shift_input_causal',
                                     'in'])
@pytest.mark.parametrize('k', [3, 22])
def test_stream_denoiser_state_and_outputs_match_jax(variant, k):
    """StreamDenoiser after k pushes (filling, steady) holds the JAX
    client's state, the shift_input inc buffers and the deeper skip1 ring
    included (through from_jax_stream_state); the pushes' outputs and the
    flush equal JAX's and the whole clip; push_block equals pushes."""
    from bsvd_tpu.archs.streaming import StreamDenoiser as JaxStream
    jcfg, jparams, pcfg, params = _pair(variant)
    t = k + 3
    x = _clip(34, 1, t, 16, 16, pcfg.effective_in_ch)
    js = JaxStream(jparams, jcfg, batch=1, height=16, width=16)
    ps = StreamDenoiser(params, pcfg, batch=1, height=16, width=16)
    assert ps.latency == js.latency == pipeline_latency(pcfg)
    outs = []
    for i in range(k):
        ref = js.push(jnp.asarray(x[:, i]))
        got = ps.push(torch.from_numpy(x[:, i]))
        assert (ref is None) == (got is None)
        if got is not None:
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
            outs.append(got)
    jstate = from_jax_stream_state(jax.tree.map(np.asarray, js.state), pcfg)
    _compare_state(ps.state, jstate)
    if pcfg.shift_input:
        assert [b['packed'].shape[-1] for b in ps.state[0]['inc']] == [4, 8]
        depth = 1 if 'causal' in variant else 11
        assert ps.state[0]['skip1']['buf'].shape[0] == depth
    outs += [o for o in ps.push_block(list(torch.from_numpy(x[:, k:])
                                           .unbind(1))) if o is not None]
    outs += ps.flush()
    assert len(outs) == t
    mimo = wnet_apply(params, torch.from_numpy(x), pcfg)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), mimo.numpy(),
                               **TOL)


@pytest.mark.parametrize('variant', ['shift_input', 'in'])
def test_stream_step_block_equals_steps(variant):
    """stream_step_block == F stream_step calls from a primed state (K5
    over F frames at shift_input's inc; the split norm sites)."""
    _, _, cfg, params = _pair(variant)
    lat = pipeline_latency(cfg)
    x = torch.from_numpy(_clip(35, 1, lat + 4, 16, 16, 4))
    state = stream_init(cfg, 1, 16, 16, device='cpu')
    for i in range(lat):
        state, _ = stream_step(params, state, x[:, i], cfg)
    s_ref = copy.deepcopy(state)
    ref = []
    for i in range(lat, lat + 4):
        s_ref, out = stream_step(params, s_ref, x[:, i], cfg)
        ref.append(out)
    _, outs = stream_step_block(params, state, x[:, lat:].transpose(0, 1),
                                cfg)
    np.testing.assert_allclose(outs.numpy(), torch.stack(ref).numpy(), **TOL)


# ---------------------------------------------------------------------------
# chunked
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('variant', ['shift_input', 'shift_input_causal',
                                     'bn', 'in'])
def test_wnet_apply_chunk_carries_match_jax_slot_by_slot(variant):
    """Outputs and every carry (20 with shift_input: the two inc sites of
    each stage first, their carries zero lanes wide at stage 0's 4
    channels) equal JAX's, slot by slot, over three chunks."""
    from bsvd_tpu.archs.wnet_arch import wnet_apply_chunk as jax_chunk
    jcfg, jparams, pcfg, params = _pair(variant)
    rng = np.random.default_rng(36)
    carries = jcarries = None
    for i in range(3):
        x = rng.uniform(0, 1, (2, 6, 16, 16, 4)).astype(np.float32)
        got, carries = wnet_apply_chunk(params, torch.from_numpy(x), pcfg,
                                        carries, future_buffer_len=2)
        ref, jcarries = jax_chunk(jparams, jnp.asarray(x), jcfg, jcarries,
                                  future_buffer_len=2)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
        assert len(carries) == len(jcarries) == pcfg.shift_num
        for k, (a, b) in enumerate(zip(carries, jcarries)):
            assert a.shape == b.shape, (k, a.shape, b.shape)
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       err_msg=f'chunk {i} slot {k}', **TOL)
    if pcfg.shift_input:
        # stage 1's inc input has mid_ch = 8 channels: fold 1
        causal = 'toFutureOnly' in pcfg.shift_mode
        assert carries[0].shape[-1] == 0
        assert carries[10].shape[-1] == (2 if causal else 1)


@pytest.mark.parametrize('variant', ['shift_input', 'in', 'raw'])
def test_denoise_seq_chunked_and_block_stream_match_jax(variant):
    """denoise_seq(temp_psz 4, look-ahead 2) of 13 frames equals JAX's,
    and BlockStreamDenoiser(4, 2) push / flush equals it exactly."""
    from bsvd_tpu.models.seq_inference import denoise_seq as jax_denoise
    jcfg, jparams, pcfg, params = _pair(variant)
    c = 4 if variant == 'raw' else 3
    seq = np.random.default_rng(37).uniform(
        0, 1, (13, c, 16, 16)).astype(np.float32)
    kw = dict(noise_sigma=30 / 255, temp_psz=4, future_buffer_len=2)
    ref = jax_denoise(jparams, jcfg, seq, **kw)
    got = denoise_seq(params, pcfg, seq, **kw)
    np.testing.assert_allclose(got, ref, **TOL)
    bsd = BlockStreamDenoiser(params, pcfg, psz=4, future_buffer_len=2)
    frames = np.concatenate([seq, np.full_like(seq[:, :1], 30 / 255)], 1)
    outs = []
    for f in frames:
        outs += bsd.push(torch.from_numpy(f).permute(1, 2, 0)[None])
    outs += bsd.flush()
    blk = torch.stack(outs, 0)[:, 0].permute(0, 3, 1, 2).numpy()
    np.testing.assert_array_equal(blk, got)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _jax_grad64(jcfg, jparams, lq, gt):
    """Loss, grads and BN batch statistics of the JAX net's MSE in float64
    (train-mode BN where the norm is 'bn')."""
    from bsvd_tpu.archs.wnet_arch import wnet_apply as jax_apply
    from bsvd_tpu.nn.layers import bn_training
    with jax.enable_x64(True):
        p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jparams)

        def jloss(p):
            coll = []
            with bn_training(coll):
                out = jax_apply(p, jnp.asarray(lq, jnp.float64), jcfg)
            return jnp.mean((out - jnp.asarray(gt, jnp.float64)) ** 2)
        jl, jg = jax.value_and_grad(jloss)(p64)
        return float(jl), jax.tree.map(lambda a: np.asarray(a, np.float32),
                                       jg)


def _rel_close(got, ref, tol):
    """|got - ref| <= tol x max|ref|. A conv bias that a norm follows has
    gradient 0 (the mean of the norm removes it; JAX's float64 gives
    ~1e-16): the port's fp32 value there is rounding, held to 1e-6."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    if scale < 1e-12:
        assert err <= 1e-6, err
        return
    assert err <= tol * scale, (err, scale)


def _leaves(tree, prefix=''):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f'{prefix}/{k}')
    else:
        yield prefix, tree


def _train_batch(seed, c_in, c_out=3, n=2, t=5, hw=16):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, (n, t, hw, hw, c_in)).astype(np.float32),
            rng.uniform(0, 1, (n, t, hw, hw, c_out)).astype(np.float32))


@pytest.mark.parametrize('variant', ['bn', 'bn_shift_input', 'in',
                                     'shift_input', 'raw'])
def test_train_grads_match_jax_grad64(variant):
    """The training forward (BN on batch statistics) and its gradients
    against jax.grad of the JAX net in float64; the recorded statistics
    fold into the running ones as JAX's bn_fold_running_stats."""
    from bsvd_tpu.nn.layers import bn_fold_running_stats, bn_stats_with_paths
    from bsvd_tpu.nn.layers import bn_training
    from bsvd_tpu.archs.wnet_arch import wnet_apply as jax_apply
    jcfg, jparams, pcfg, params = _pair(variant)
    lq, gt = _train_batch(38, pcfg.effective_in_ch, pcfg.out_ch)
    jl, jg = _jax_grad64(jcfg, jparams, lq, gt)
    for _, leaf in _leaves(params):
        if leaf.dtype.is_floating_point:
            leaf.requires_grad_(True)
    for path, leaf in _leaves(params):
        if path.endswith(('/mean', '/var')):
            leaf.requires_grad_(False)
    stats = [] if pcfg.norm == 'bn' else None
    out = wnet_apply(params, torch.from_numpy(lq), pcfg, bn_stats=stats)
    loss = ((out - torch.from_numpy(gt)) ** 2).mean()
    loss.backward()
    _rel_close(loss.item(), jl, 1e-4)
    grads = from_jax_params(jg, pcfg)
    for (name, p), (_, r) in zip(_leaves(params), _leaves(grads)):
        if p.requires_grad:
            _rel_close(p.grad, r, 1e-4)
    if stats is None:
        return
    # fold: JAX's fp32 statistics of the same forward, folded by JAX
    coll = []
    with bn_training(coll):
        jax_apply(jparams, jnp.asarray(lq), jcfg)
    want = bn_fold_running_stats(jparams, bn_stats_with_paths(jparams, coll))
    assert len(stats) == len(coll) == sum(
        1 for p, _ in _leaves(params) if p.endswith('/mean'))
    bn_update(stats)
    want = from_jax_params(jax.tree.map(np.asarray, want), pcfg)
    for (name, a), (_, r) in zip(_leaves(params), _leaves(want)):
        if name.endswith(('/mean', '/var')):
            np.testing.assert_allclose(a.numpy(), r.numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=name)


class _SGD:
    """optax.sgd(lr) over named parameters (the fixture's optimizer)."""

    def __init__(self, params, lr):
        self.params, self.lr = [p for _, p in params], lr

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self):
        for p in self.params:
            if p.grad is not None:
                p -= self.lr * p.grad


def test_bn_train_steps_match_reference_fixture_and_jax():
    """Three SGD train steps of a BN net (test_train_pipeline.py's
    test_bn_train_mode_parity_vs_torch setup) through the port's
    make_train_step: the running statistics of stage 0's first BN against
    the reference torch BN (tests/fixtures/bn_train_parity.npz, 1e-5) and
    every running statistic against JAX's make_train_step (1e-5); then the
    eval forward. The fixture's eval output carries the fp32 trajectory of
    the reference (JAX's fp32 steps share it to 1.4e-5), where the float64
    trajectory, JAX's and the port's alike (5e-7 apart), lands 4.0e-4 from
    it: the eval is held against JAX's float64 steps (1e-4) and the
    fixture to 1e-3."""
    import optax
    from bsvd_tpu.archs.wnet_arch import WNetConfig as JaxConfig
    from bsvd_tpu.archs.wnet_arch import wnet_apply as jax_apply
    from bsvd_tpu.archs.wnet_arch import wnet_init as jax_init
    from bsvd_tpu.convert.torch_ckpt import (convert_tsn_state_dict,
                                             params_to_tsn_state_dict)
    from bsvd_tpu.losses import MSELoss
    from bsvd_tpu.models.denoising_model import make_train_step as jstep_fn
    from bsvd_tpu_torch.models.denoising_model import make_train_step
    opt = dict(SMALL_NET2D_OPT, norm='bn', act='relu')
    kw = dict(chns=tuple(opt['chns']), mid_ch=opt['mid_ch'], in_ch=4,
              out_ch=3, stage_num=2, interm_ch=opt['interm_ch'], norm='bn',
              act='relu', shift_mode='TSM')
    jcfg = JaxConfig(**kw)
    state0 = params_to_tsn_state_dict(jax_init(jax.random.PRNGKey(21), jcfg),
                                      jcfg)
    n, t, h, w = 2, 4, 16, 16
    lr, steps = 0.005, 3
    rng = np.random.default_rng(22)
    lqs = rng.standard_normal((steps, n, t, 4, h, w)).astype(np.float32)
    gts = rng.standard_normal((steps, n, t, 3, h, w)).astype(np.float32)
    x_eval = rng.standard_normal((1, t, 4, h, w)).astype(np.float32)
    g = golden('bn_train_parity', lambda: pytest.skip('fixture missing'))

    def nthwc(v):
        return np.ascontiguousarray(np.transpose(v, (0, 1, 3, 4, 2)))
    batches = [{'lq': nthwc(lqs[i]), 'gt': nthwc(gts[i])}
               for i in range(steps)]

    net = TSN(num_segments=t, net2d_opt=opt)
    net.load_params(load_tsn_state_dict(
        {k: torch.from_numpy(np.array(v)) for k, v in state0.items()},
        net.cfg))
    step = make_train_step(net, _SGD(net.named_parameters(), lr),
                           build_loss({'type': 'MSELoss'}))
    for b in batches:
        step({k: torch.from_numpy(v) for k, v in b.items()})

    def jax_steps(dt):
        p = jax.tree.map(lambda a: jnp.asarray(a, dt),
                         convert_tsn_state_dict(state0, jcfg))
        tx = optax.sgd(lr)
        st = tx.init(p)
        jstep = jax.jit(jstep_fn(jcfg, tx, MSELoss(), params_template=p))
        for i, b in enumerate(batches):
            p, st, _, _ = jstep(p, st, None, {k: jnp.asarray(v, dt)
                                              for k, v in b.items()},
                                i, 0.999)
        return p, np.asarray(jax_apply(p, jnp.asarray(nthwc(x_eval), dt),
                                       jcfg), np.float32)

    jparams, _ = jax_steps(jnp.float32)
    with jax.enable_x64(True):
        _, ref64 = jax_steps(jnp.float64)
    bn = _to_tree(net.params)['stage0']['inc']['n1']
    np.testing.assert_allclose(bn['mean'].numpy(), g['ref_mean'], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(bn['var'].numpy(), g['ref_var'], rtol=1e-5,
                               atol=1e-5)
    want = from_jax_params(jax.tree.map(np.asarray, jparams), net.cfg)
    for (name, a), (_, r) in zip(_leaves(net.param_tree()), _leaves(want)):
        if name.endswith(('/mean', '/var')):
            np.testing.assert_allclose(a.numpy(), r.numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=name)
    got = wnet_apply(net.param_tree(), torch.from_numpy(nthwc(x_eval)),
                     net.cfg).numpy()
    np.testing.assert_allclose(got, ref64, **TOL)
    np.testing.assert_allclose(got, nthwc(g['ref_eval']), rtol=1e-3,
                               atol=1e-3)


def _model_opt(net2d, **train_over):
    train = {'optim_g': {'type': 'Adam', 'lr': 1e-3, 'weight_decay': 0,
                         'betas': [0.9, 0.99]},
             'scheduler': {'type': 'MultiStepLR', 'milestones': [10],
                           'gamma': 0.5},
             'total_iter': 4, 'warmup_iter': -1, 'ema_decay': 0.9,
             'pixel_opt': {'type': 'MSELoss', 'loss_weight': 1.0,
                           'reduction': 'mean'}}
    train.update(train_over)
    return {'name': 'options', 'model_type': 'DenoisingModel',
            'num_gpu': 1, 'is_train': True,
            'network_g': {'type': 'TSN', 'num_segments': 5,
                          'base_model': 'WNet_multistage', 'shift_type': 'TSM',
                          'shift_div': 8, 'net2d_opt': dict(net2d)},
            'path': {'strict_load_g': True}, 'train': train}


def _feed(model, seed):
    lq, gt = _train_batch(seed, 3)
    nm = np.full(lq.shape[:-1] + (1,), 25 / 255., np.float32)
    model.feed_data({'lq': np.transpose(lq, (0, 1, 4, 2, 3)),
                     'noise_map': np.transpose(nm, (0, 1, 4, 2, 3)),
                     'gt': np.transpose(gt, (0, 1, 4, 2, 3))})


def test_bn_model_step_ignores_amp_and_keeps_stats_out_of_adam():
    """A BN DenoisingModel: train.fp16 is ignored with the JAX package's
    warning; Adam holds no running statistic (so AdamW cannot decay one,
    where the JAX package's optax.adamw over the whole tree does: pinned
    below, not copied); a step moves the running statistics once; the EMA
    averages them like every other leaf."""
    import optax
    from bsvd_tpu_torch.models.denoising_model import DenoisingModel
    net2d = dict(_KW, norm='bn')
    seen = []
    handler = logging.Handler()
    handler.emit = lambda record: seen.append(record.getMessage())
    logger = logging.getLogger('bsvd_tpu_torch')
    logger.addHandler(handler)
    try:
        model = DenoisingModel(_model_opt(net2d, fp16=True), device='cpu')
    finally:
        logger.removeHandler(handler)
    assert model.amp is False
    assert any('train.fp16 ignored for norm=bn' in m for m in seen)
    assert not any(n.endswith(('.mean', '.var'))
                   for n in model.optimizer.names)
    before = _map_tree(model.net.param_tree(), torch.clone)
    ema0 = _map_tree(model.ema_params, torch.clone)
    _feed(model, 39)
    model.optimize_parameters(1)
    after = model.net.param_tree()
    stage = after['stage0']['inc']['n1']
    assert not torch.equal(stage['mean'], before['stage0']['inc']['n1'][
        'mean'])
    for name, e in _leaves(model.ema_params):
        e0 = dict(_leaves(ema0))[name]
        p = dict(_leaves(after))[name]
        torch.testing.assert_close(e, e0 * 0.9 + p * 0.1)
    # the JAX package's AdamW decays a running statistic whose gradient is 0
    tx = optax.adamw(1e-3, weight_decay=0.05)
    leaf = {'var': jnp.full((4,), 2.0)}
    upd, _ = tx.update({'var': jnp.zeros(4)}, tx.init(leaf), leaf)
    assert float(jnp.abs(upd['var']).max()) > 0


def test_remat_grads_and_stats_equal_no_remat():
    """remat recomputes each stage in the backward: the loss, every
    gradient and the folded BN statistics are the bits of the run without
    it, and the recompute records no statistic a second time."""
    _, _, cfg, params = _pair('bn_shift_input')
    _, _, rcfg, _ = _pair('bn_shift_input', remat=True)
    lq, gt = _train_batch(40, 4)
    runs = []
    for c in (cfg, rcfg):
        p = _map_tree(params, lambda v: v.clone())
        for name, leaf in _leaves(p):
            leaf.requires_grad_(not name.endswith(('/mean', '/var')))
        stats = []
        out = wnet_apply(p, torch.from_numpy(lq), c, bn_stats=stats)
        loss = ((out - torch.from_numpy(gt)) ** 2).mean()
        loss.backward()
        n_stats = len(stats)
        bn_update(stats)
        runs.append((loss.detach(), p, n_stats))
    (l0, p0, n0), (l1, p1, n1) = runs
    sites = sum(1 for name, _ in _leaves(params) if name.endswith('/mean'))
    assert n0 == n1 == sites == 26 and torch.equal(l0, l1)
    for (name, a), (_, b) in zip(_leaves(p0), _leaves(p1)):
        if a.grad is not None:
            assert torch.equal(a.grad, b.grad), name
        else:
            assert torch.equal(a, b), name


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('variant', ['bn', 'bn_shift_input', 'in'])
def test_checkpoint_round_trips_carry_running_stats(variant, tmp_path):
    """.pth: to_tsn_state_dict -> load_tsn_state_dict is the identity, the
    JAX converter reads the same state dict to the same tree, and a
    ``num_batches_tracked`` key is skipped. .npz: the port's file loads
    in the JAX package and back, BN leaves (or empty slots) included."""
    from bsvd_tpu.convert.torch_ckpt import convert_tsn_state_dict
    from bsvd_tpu.models.checkpoint import load_npz_params as jax_load_npz
    jcfg, jparams, pcfg, params = _pair(variant)
    state = to_tsn_state_dict(params, pcfg)
    if pcfg.norm == 'bn':
        key = 'base_model.nets_list.0.downc0.convblock.1.running_var'
        assert key in state
        state[key.replace('running_var', 'num_batches_tracked')] = \
            torch.tensor(7)
    back = load_tsn_state_dict(state, pcfg)
    jback = convert_tsn_state_dict({k: v.numpy() for k, v in state.items()
                                    if 'num_batches' not in k}, jcfg)
    for (name, a), (_, b), (_, c) in zip(_leaves(params), _leaves(back),
                                         _leaves(from_jax_params(jback,
                                                                 pcfg))):
        assert torch.equal(a, b) and torch.equal(a, c), name
    path = str(tmp_path / 'net.npz')
    save_npz_params(path, {'params': to_jax_params(params, pcfg)})
    jtree = jax_load_npz(path, 'params')
    assert jax.tree.structure(jtree) == jax.tree.structure(jparams)
    for a, b in zip(jax.tree.leaves(jtree), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(a, b)
    again = from_jax_params(load_npz_params(path, 'params'), pcfg)
    for (name, a), (_, b) in zip(_leaves(params), _leaves(again)):
        assert torch.equal(a, b), name


def test_bn_model_saves_and_loads_running_stats(tmp_path):
    """DenoisingModel.save writes the running statistics in the JAX layout;
    a model built from that file holds them as buffers."""
    from bsvd_tpu_torch.models.denoising_model import DenoisingModel
    opt = _model_opt(dict(_KW, norm='bn'), ema_decay=0)
    opt['path'].update(models=str(tmp_path), training_states=str(tmp_path))
    model = DenoisingModel(copy.deepcopy(opt), device='cpu')
    _feed(model, 41)
    model.optimize_parameters(1)
    model.save(0, 1)
    opt['path']['pretrain_network_g'] = str(tmp_path / 'net_g_1.npz')
    loaded = DenoisingModel(opt, device='cpu')
    for (name, a), (_, b) in zip(_leaves(model.net.param_tree()),
                                 _leaves(loaded.net.param_tree())):
        assert torch.equal(a, b), name
    assert not torch.equal(_to_tree(loaded.net.params)['stage1']['outc'][
        'n1']['var'], torch.ones(8))


def test_fold_bn_is_the_eval_bn():
    """Each folded conv equals its conv then eval-mode BN on the running
    statistics (torch's F.conv2d and F.batch_norm, training off), at every
    BN site of the tree; fold_bn drops the BN leaves, leaves a tree without
    BN as it was, and streaming refuses a tree it has not folded."""
    import torch.nn.functional as F
    from bsvd_tpu_torch.archs.wnet_arch import _CONV_NORM, _Norms
    _, _, cfg, params = _pair('bn')
    folded = fold_bn(params)
    x = torch.from_numpy(_clip(42, 1, 1, 12, 12, 64))[0, 0]
    sites = 0

    def walk(raw, fold):
        nonlocal sites
        assert not any(k.startswith('n') for k in fold)
        for c, n in _CONV_NORM:
            if n in raw:
                w, b, bn = raw[c]['w'], raw[c]['b'], raw[n]
                xin = x[None, :, :, :w.shape[1]].permute(0, 3, 1, 2)
                ref = F.batch_norm(F.conv2d(xin, w, b, padding=1),
                                   bn['mean'], bn['var'], bn['scale'],
                                   bn['bias'], training=False, eps=1e-5)
                got = F.conv2d(xin, fold[c]['w'], fold[c]['b'], padding=1)
                np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)
                sites += 1
        for k, v in raw.items():
            if isinstance(v, dict) and 'w' not in v and 'mean' not in v:
                walk(v, fold[k])
    walk(params, folded)
    assert sites == 2 * 13
    plain = wnet_init(WNetConfig(**_KW))
    assert fold_bn(plain)['stage0']['inc']['c1'] is plain['stage0']['inc'][
        'c1']
    assert _Norms(cfg, []).split and not _Norms(cfg).split
    with pytest.raises(ValueError, match='BN folded'):
        stream_step(params, stream_init(cfg, 1, 8, 8, device='cpu'),
                    torch.zeros(1, 8, 8, 4), cfg)
