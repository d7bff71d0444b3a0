"""The port's training slice on CPU against the JAX package: the kernels'
autograd Functions, the whole net's gradients, the optimizer step, the
schedules, the train batch, the checkpoints and resumption.

Inputs come from numpy seeds and go to both frameworks as arrays; JAX
weights are HWIO, the port's OIHW (``from_jax_params``). fp32 unless a test
says otherwise. Tolerances, with their reasons:

- one op's (dx, dw, db) against ``jax.vjp`` of the JAX custom_vjp, its
  Pallas forward in interpret mode: 1e-4 absolute and relative (summation
  order only);
- the whole net's loss and grads against ``jax.grad`` of the JAX net in
  float64: 1e-4 x max|ref| per tensor (summation order over 32 convs
  forward and back);
- parameters and EMA after Adam steps, against optax fed the same
  gradients: 1e-5 x max|ref| per tensor;
- the bf16 AMP step: see its test.

On CPU tensors no wrapper launches a kernel, so every launch counter stays
0 (checked).
"""

import copy
import os
import queue

import numpy as np
import pytest
import torch

from bsvd_tpu_torch.archs.wnet_arch import (WNetConfig, _map_tree, _to_tree,
                                            wnet_apply)
from bsvd_tpu_torch.convert.torch_ckpt import from_jax_params, to_jax_params
from bsvd_tpu_torch.ops.conv3x3 import conv3x3, conv3x3_dw, conv_ps
from bsvd_tpu_torch.ops.conv_chain import (conv_chain, conv_chain_add2,
                                           conv_chain_add2_res)
from bsvd_tpu_torch.ops.conv_s2 import conv_s2
from bsvd_tpu_torch.ops.shift_conv import (shift_conv, shift_conv_add2,
                                           shift_conv_fused_v1)

jax = pytest.importorskip('jax')
jnp = pytest.importorskip('jax.numpy')

TOL = dict(rtol=1e-4, atol=1e-4)
NET2D = {'chns': [16, 32, 64], 'mid_ch': 16, 'shift_input': False,
         'norm': 'none', 'interm_ch': 16, 'act': 'relu6'}
N, T, H, W = 2, 5, 32, 32
COUNTED = (conv3x3, conv_ps, conv_chain, conv_s2, conv3x3_dw,
           shift_conv_fused_v1)


@pytest.fixture(autouse=True)
def _no_launches():
    for f in COUNTED:
        f.launches = 0
    yield
    assert [f.launches for f in COUNTED] == [0] * len(COUNTED)


def _arr(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a, grad=False):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


def _oihw(w_hwio):
    return np.ascontiguousarray(np.transpose(w_hwio, (3, 2, 0, 1)))


def _close(got, ref, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               **(tol or TOL))


def _port_vjp(fn, inputs, g):
    """(output, grads of every input) of the port's fn at cotangent g."""
    ts = [_t(a, True) for a in inputs]
    y = fn(*ts)
    y.backward(_t(g))
    return y.detach(), [t.grad for t in ts]


def _jax_vjp(fn, inputs, g):
    from jax.experimental.pallas import tpu as pltpu
    with pltpu.force_tpu_interpret_mode():
        y, vjp = jax.vjp(fn, *[jnp.asarray(a) for a in inputs])
        return y, vjp(jnp.asarray(g))


def _check_vjp(port_fn, jax_fn, inputs, g, w_idx=()):
    """Compare outputs and every input's cotangent; inputs at ``w_idx`` are
    HWIO weights on the JAX side and OIHW on the port's."""
    p_in = [_oihw(a) if i in w_idx else a for i, a in enumerate(inputs)]
    y, grads = _port_vjp(port_fn, p_in, g)
    yj, gj = _jax_vjp(jax_fn, inputs, g)
    _close(y, yj)
    for i, (a, b) in enumerate(zip(grads, gj)):
        b = np.asarray(b)
        _close(a, _oihw(b) if i in w_idx else b)


# ---- autograd Functions against the JAX custom_vjps ------------------------

@pytest.mark.parametrize('act', ['relu6', 'relu', 'none'])
@pytest.mark.parametrize('add2', [False, True])
def test_conv3x3_function_matches_jax_vjp(add2, act):
    from bsvd_tpu.ops.conv3x3 import conv3x3 as jc3, conv3x3_add2 as jc3a
    rng = np.random.default_rng(101)
    x, x2 = _arr(rng, (2, 8, 64, 16)), _arr(rng, (2, 8, 64, 16))
    w, b = _arr(rng, (3, 3, 16, 16), 0.1), _arr(rng, (16,), 0.1)
    g = _arr(rng, (2, 8, 64, 16))
    if add2:
        _check_vjp(lambda x, x2, w, b: conv3x3(x, w, b, x2, act=act),
                   lambda x, x2, w, b: jc3a(x, x2, w, b, act),
                   [x, x2, w, b], g, w_idx=(2,))
    else:
        _check_vjp(lambda x, w, b: conv3x3(x, w, b, act=act),
                   lambda x, w, b: jc3(x, w, b, act), [x, w, b], g,
                   w_idx=(1,))


@pytest.mark.parametrize('causal', [False, True])
@pytest.mark.parametrize('add2', [False, True])
def test_shift_conv_function_matches_jax_vjp(add2, causal):
    from bsvd_tpu.ops.shift_conv import (shift_conv as jsc,
                                         shift_conv_add2 as jsca)
    rng = np.random.default_rng(102)
    x, x2 = _arr(rng, (6, 8, 64, 16)), _arr(rng, (6, 8, 64, 16))
    w, b = _arr(rng, (3, 3, 16, 16), 0.1), _arr(rng, (16,), 0.1)
    g = _arr(rng, (6, 8, 64, 16))
    if add2:
        _check_vjp(lambda x, x2, w, b: shift_conv_add2(x, x2, w, b, 3, 8,
                                                       'relu6', causal),
                   lambda x, x2, w, b: jsca(x, x2, w, b, 3, 8, 'relu6',
                                            causal),
                   [x, x2, w, b], g, w_idx=(2,))
    else:
        _check_vjp(lambda x, w, b: shift_conv(x, w, b, 3, 8, 'relu6',
                                              causal),
                   lambda x, w, b: jsc(x, w, b, 3, 8, 'relu6', causal),
                   [x, w, b], g, w_idx=(1,))


def test_conv_ps_function_matches_jax_vjp():
    from bsvd_tpu.ops.conv3x3 import conv_ps_natural
    rng = np.random.default_rng(103)
    x = _arr(rng, (1, 8, 64, 16))
    w, b = _arr(rng, (3, 3, 16, 32), 0.1), _arr(rng, (32,), 0.1)
    g = _arr(rng, (1, 16, 128, 8))
    _check_vjp(conv_ps, conv_ps_natural, [x, w, b], g, w_idx=(1,))


def test_conv_s2_function_matches_jax_vjp():
    """The JAX custom_vjp runs on the width-folded view with folded
    weights; its natural-weight cotangent is the vjp through the fold."""
    from bsvd_tpu.ops.conv3x3 import fold_width_stride2_weights
    from bsvd_tpu.ops.conv_s2 import conv_s2 as jconv_s2
    rng = np.random.default_rng(104)
    x = _arr(rng, (1, 16, 128, 8))
    w, b = _arr(rng, (3, 3, 8, 16), 0.1), _arr(rng, (16,), 0.1)
    g = _arr(rng, (1, 8, 64, 16))

    def jfn(x, w, b):
        wf, bf = fold_width_stride2_weights(w, b)
        return jconv_s2(x.reshape(1, 16, 64, 16), wf, bf, 'relu6')
    _check_vjp(lambda x, w, b: conv_s2(x, w, b, act='relu6'), jfn,
               [x, w, b], g, w_idx=(1,))


@pytest.mark.parametrize('case', ['inc', 'inc_relu_both', 'add2', 'res'])
def test_conv_chain_function_matches_jax_vjp(case):
    """Chain backward (K1 recompute of h, two K7 dws) against the JAX
    chain's direct backward; the residual variant against the JAX chain
    followed by the natural-layout residual (wnet_arch._stage_apply)."""
    from bsvd_tpu.ops.conv_chain import (conv_chain as jcc,
                                         conv_chain_add2 as jcca)
    rng = np.random.default_rng(105)
    x, x2 = _arr(rng, (1, 8, 64, 16)), _arr(rng, (1, 8, 64, 16))
    xr = _arr(rng, (1, 8, 64, 4))
    w1, b1 = _arr(rng, (3, 3, 16, 16), 0.1), _arr(rng, (16,), 0.1)
    w2, b2 = _arr(rng, (3, 3, 16, 8), 0.1), _arr(rng, (8,), 0.1)
    g = _arr(rng, (1, 8, 64, 8))
    act2 = 'relu6' if case == 'inc_relu_both' else 'none'
    if case in ('inc', 'inc_relu_both'):
        _check_vjp(lambda x, w1, b1, w2, b2: conv_chain(x, w1, b1, w2, b2,
                                                        'relu6', act2),
                   lambda *a: jcc(*a, 'relu6', act2),
                   [x, w1, b1, w2, b2], g, w_idx=(1, 3))
    elif case == 'add2':
        _check_vjp(lambda x, x2, w1, b1, w2, b2: conv_chain_add2(
                       x, x2, w1, b1, w2, b2, 'relu6', 'none'),
                   lambda *a: jcca(*a, 'relu6', 'none'),
                   [x, x2, w1, b1, w2, b2], g, w_idx=(2, 4))
    else:
        def jfn(x, x2, xr, w1, b1, w2, b2):
            y = jcca(x, x2, w1, b1, w2, b2, 'relu6', 'none')
            return jnp.concatenate([xr[..., :3] - y[..., :3], y[..., 3:]],
                                   axis=-1)
        _check_vjp(lambda x, x2, xr, w1, b1, w2, b2: conv_chain_add2_res(
                       x, x2, xr, w1, b1, w2, b2, 'relu6', 'none', 3),
                   jfn, [x, x2, xr, w1, b1, w2, b2], g, w_idx=(3, 5))


def test_shift_conv_fused_v1_matches_jax():
    """Row 12's entry (K1 with no second input) against the JAX
    generation-1 kernel in interpret mode."""
    from bsvd_tpu.ops.shift_conv import _shift_conv_fused_v1
    rng = np.random.default_rng(106)
    x = _arr(rng, (6, 16, 64, 16))
    w, b = _arr(rng, (3, 3, 16, 24), 0.1), _arr(rng, (24,), 0.1)
    for causal in (False, True):
        got = shift_conv_fused_v1(_t(x), _t(_oihw(w)), _t(b), t_len=3,
                                  causal=causal)
        ref = _shift_conv_fused_v1(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(b), t_len=3, causal=causal,
                                   interpret=True)
        _close(got, ref)


def test_temporal_shift_transpose_is_the_adjoint():
    from bsvd_tpu_torch.nn.shift import (temporal_shift,
                                         temporal_shift_transpose)
    rng = np.random.default_rng(107)
    x, g = _arr(rng, (2, 4, 3, 3, 16)), _arr(rng, (2, 4, 3, 3, 16))
    for mode in ('TSM', 'TSM_toFutureOnly'):
        lhs = (temporal_shift(_t(x), 8, mode) * _t(g)).sum()
        rhs = (_t(x) * temporal_shift_transpose(_t(g), 8, mode)).sum()
        assert abs(lhs.item() - rhs.item()) < 1e-4


# ---- the whole net -----------------------------------------------------------

def _jax_net(seed=0, **over):
    from bsvd_tpu.archs.wnet_arch import WNetConfig as JaxConfig, wnet_init
    kw = dict(chns=tuple(NET2D['chns']), mid_ch=16, interm_ch=16,
              norm='none', act='relu6')
    kw.update(over)
    jcfg = JaxConfig(**kw)
    return jcfg, WNetConfig(**kw), wnet_init(jax.random.PRNGKey(seed), jcfg)


def _batch(seed, n=N, t=T, h=H, w=W):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(0, 1, (n, t, 3, h, w)).astype(np.float32)
    nm = np.full((n, t, 1, h, w), 25 / 255., np.float32)
    lq = (gt + rng.normal(0, 25 / 255., gt.shape)).astype(np.float32)
    return {'gt': gt, 'lq': lq, 'noise_map': nm}


def _nthwc(a):
    return np.ascontiguousarray(np.transpose(a, (0, 1, 3, 4, 2)))


def _rel_close(got, ref, tol):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    err = np.abs(got - ref).max()
    assert err <= tol * max(np.abs(ref).max(), 1e-30), (err, np.abs(ref).max())


def _leaves(tree, prefix=''):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f'{prefix}/{k}')
    else:
        yield prefix, tree


def _jax_grad64(jcfg, jparams, lq, gt):
    """Loss and grads of the JAX wnet_apply's MSE in float64. The fp32 JAX
    gradient on XLA:CPU is no reference at 1e-4: at seed 3 / batch 11 its
    stage-1 inc and all of stage 0 sit up to 1.5e-3 x max|g| from JAX's
    own float64 gradient, where the port's fp32 gradient sits within 1e-6."""
    from bsvd_tpu.archs.wnet_arch import wnet_apply as jax_apply
    with jax.enable_x64(True):
        p64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float64),
                           jparams)

        def jloss(p):
            return jnp.mean((jax_apply(p, jnp.asarray(lq, jnp.float64), jcfg)
                             - jnp.asarray(gt, jnp.float64)) ** 2)
        jl, jg = jax.value_and_grad(jloss)(p64)
        return float(jl), jax.tree.map(
            lambda a: np.asarray(a, np.float32), jg)


@pytest.mark.parametrize('shift_type,seed', [('TSM', 1), ('TSM', 3),
                                             ('TSM_toFutureOnly', 1)])
def test_wnet_grads_match_jax_grad(shift_type, seed):
    jcfg, pcfg, jparams = _jax_net(seed, shift_mode=shift_type)
    b = _batch(2 if seed == 1 else 11)
    lq = _nthwc(np.concatenate([b['lq'], b['noise_map']], axis=2))
    gt = _nthwc(b['gt'])
    jl, jg = _jax_grad64(jcfg, jparams, lq, gt)
    params = from_jax_params(jax.tree.map(np.asarray, jparams), pcfg)
    for _, leaf in _leaves(params):
        leaf.requires_grad_(True)
    loss = ((wnet_apply(params, _t(lq), pcfg) - _t(gt)) ** 2).mean()
    loss.backward()
    _rel_close(loss.item(), jl, 1e-4)
    grads = from_jax_params(jg, pcfg)
    for (name, p), (_, r) in zip(_leaves(params), _leaves(grads)):
        _rel_close(p.grad, r, 1e-4)


# ---- the train step: optimizer, EMA, AMP -----------------------------------

def _opt(**train_over):
    train = {'optim_g': {'type': 'Adam', 'lr': 1e-3, 'weight_decay': 0,
                         'betas': [0.9, 0.99]},
             'scheduler': {'type': 'MultiStepLR', 'milestones': [2],
                           'gamma': 0.7},
             'total_iter': 6, 'warmup_iter': -1, 'ema_decay': 0.9,
             'gradient_clipping': 0.05,
             'pixel_opt': {'type': 'MSELoss', 'loss_weight': 1.0,
                           'reduction': 'mean'}}
    train.update(train_over)
    return {'name': 'train_parity', 'model_type': 'DenoisingModel',
            'num_gpu': 1, 'is_train': True, 'manual_seed': 10,
            'network_g': {'type': 'TSN', 'num_segments': T,
                          'base_model': 'WNet_multistage', 'shift_type': 'TSM',
                          'shift_div': 8, 'net2d_opt': dict(NET2D)},
            'path': {'strict_load_g': True}, 'train': train,
            'logger': {'print_freq': 2, 'save_checkpoint_freq': 4}}


def _models(opt, jparams):
    from bsvd_tpu.models.denoising_model import DenoisingModel as JaxModel
    from bsvd_tpu_torch.models.denoising_model import DenoisingModel
    # the JAX step donates its parameters: each model gets its own copy
    jm = JaxModel(copy.deepcopy(opt))
    jm.params = jm.net.params = jax.tree.map(jnp.array, jparams)
    jm.opt_state = jm.tx.init(jm.params)
    pm = DenoisingModel(copy.deepcopy(opt), device='cpu')
    pm.net.load_params(from_jax_params(jax.tree.map(np.asarray, jparams),
                                       pm.cfg))
    if opt['train']['ema_decay']:
        jm.ema_params = jax.tree.map(jnp.array, jparams)
        pm.ema_params = _map_tree(pm.net.param_tree(), torch.clone)
    return jm, pm


@pytest.mark.parametrize('clip,wd', [(False, 0), (True, 0), (False, 0.05)],
                         ids=['adam', 'adam_clip', 'adamw'])
def test_optimize_parameters_matches_jax(clip, wd):
    """3 optimize_parameters steps (the MultiStepLR milestone at update 2,
    EMA on), with and without the global-norm clip, and as AdamW (weight
    decay set), against the JAX
    DenoisingModel: the first step's loss against its make_train_step, and
    the parameters and EMA after 3 steps against the JAX model's optax
    chain (``tx``, the one its make_train_step applies) and its ema_update
    fed the port's gradients of each step.

    The gradients are shared because Adam amplifies a gradient difference
    by lr / eps (1e5 here) wherever |g| is near eps = 1e-8: fp32
    summation-order noise alone moves such parameters by up to 2 lr, far
    past 1e-5 x max|param|. The gradients themselves are held against JAX
    in test_wnet_grads_match_jax_grad."""
    import optax
    from bsvd_tpu.models.base_model import BaseModel as JaxBase
    opt = _opt(use_grad_clip=clip)
    opt['train']['optim_g']['weight_decay'] = wd
    _, _, jparams = _jax_net(3)
    jm, pm = _models(opt, jparams)
    params = jax.tree.map(jnp.array, jparams)
    ema = jax.tree.map(jnp.array, jparams)
    state = jm.tx.init(params)
    for i in range(1, 4):
        b = _batch(10 + i)
        pm.feed_data(b)
        pm.optimize_parameters(i)
        if i == 1:
            jm.feed_data(b)
            jm.optimize_parameters(i)
            _rel_close(pm.get_current_log()['l_pix'], jm.log_dict['l_pix'],
                       1e-4)
        grads = to_jax_params(_map_tree(_to_tree(pm.net.params),
                                        lambda p: p.grad), pm.cfg)
        updates, state = jm.tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        ema = JaxBase.ema_update(ema, params, opt['train']['ema_decay'])
    for got, want in ((pm.net.param_tree(), params), (pm.ema_params, ema)):
        want = from_jax_params(jax.tree.map(np.asarray, want), pm.cfg)
        for (name, a), (_, r) in zip(_leaves(got), _leaves(want)):
            _rel_close(a, r, 1e-5)
    assert pm.optimizer.count == 3
    assert pm.get_current_learning_rate() == [np.float32(1e-3) *
                                              np.float32(0.7)]


def test_amp_step_within_bf16_noise():
    """One bf16 AMP step (bf16 forward / backward, fp32 masters) against
    the JAX AMP step and the exact (float64) gradient. bf16 rounds at other
    places in the two frameworks, so the bounds are bf16 noise:

    - the loss within 2^-7 relative of the JAX AMP loss;
    - each master's gradient no further from the exact gradient, in
      relative L2, than max(1.5 x the JAX AMP gradient's distance, 2^-5).
      (JAX on XLA:CPU sums the bias cotangents in bf16: its full-resolution
      bias gradients sit 40-90 % from the exact ones, the port's within 2 %);
    - Adam's first step, -lr sign(g), wherever |g| > 2^-3 max|g| of the
      exact gradient (where bf16 noise cannot flip the sign), to
      1e-5 x max|param|."""
    from bsvd_tpu.archs.wnet_arch import wnet_apply as jax_apply
    opt = _opt(fp16=True, ema_decay=0)
    lr = opt['train']['optim_g']['lr']
    jcfg, pcfg, jparams = _jax_net(4)
    jm, pm = _models(opt, jparams)
    b = _batch(20, n=1)
    for m in (jm, pm):
        m.feed_data(b)
        m.optimize_parameters(1)
    _rel_close(pm.get_current_log()['l_pix'], jm.log_dict['l_pix'], 2 ** -7)

    lq = _nthwc(np.concatenate([b['lq'], b['noise_map']], axis=2))
    gt = _nthwc(b['gt'])

    def jloss(p):
        p = jax.tree.map(lambda a: a.astype(jnp.bfloat16), p)
        out = jax_apply(p, jnp.asarray(lq, jnp.bfloat16), jcfg)
        return jnp.mean((out.astype(jnp.float32) - jnp.asarray(gt)) ** 2)
    jg = from_jax_params(jax.tree.map(np.asarray, jax.grad(jloss)(jparams)),
                         pcfg)
    exact = from_jax_params(_jax_grad64(jcfg, jparams, lq, gt)[1], pcfg)
    before = from_jax_params(jax.tree.map(np.asarray, jparams), pcfg)
    named = dict(pm.net.named_parameters())
    for (name, r), (_, e), (_, p0) in zip(_leaves(jg), _leaves(exact),
                                          _leaves(before)):
        param = named['params.' + name.strip('/').replace('/', '.')]
        g, r, e, p0 = param.grad.numpy(), r.numpy(), e.numpy(), p0.numpy()
        norm = np.linalg.norm(e)
        dist, jdist = np.linalg.norm(g - e), np.linalg.norm(r - e)
        assert dist <= max(1.5 * jdist, 2 ** -5 * norm), (name, dist / norm,
                                                          jdist / norm)
        big = np.abs(e) > 2 ** -3 * np.abs(e).max()
        np.testing.assert_allclose(
            param.detach().numpy()[big], (p0 - lr * np.sign(e))[big],
            rtol=0, atol=1e-5 * np.abs(p0).max(), err_msg=name)


def test_amp_grads_are_rounded_to_bf16():
    """Under AMP each master's gradient is the bf16 gradient cast back
    (JAX rounds dw to the weight dtype before the cast)."""
    from bsvd_tpu_torch.models.denoising_model import DenoisingModel
    pm = DenoisingModel(_opt(fp16=True, ema_decay=0), device='cpu')
    pm.feed_data(_batch(21))
    pm.optimize_parameters(1)
    for name, p in pm.net.named_parameters():
        assert p.grad.dtype == torch.float32
        assert torch.equal(p.grad, p.grad.to(torch.bfloat16).float()), name


# ---- schedules, batches, checkpoints ---------------------------------------

@pytest.mark.parametrize('train_opt', [
    {'optim_g': {'lr': 1e-3}, 'scheduler': {
        'type': 'MultiStepLR', 'milestones': [3, 50, 120], 'gamma': 0.7}},
    {'optim_g': {'lr': 2e-4}, 'scheduler': {
        'type': 'MultiStepRestartLR', 'milestones': [10, 60, 130, 170],
        'gamma': 0.5, 'restarts': [0, 100], 'restart_weights': [1, 0.5]}},
    {'optim_g': {'lr': 1e-3}, 'scheduler': {
        'type': 'MultiStepLR', 'milestones': [30], 'gamma': 0.7},
     'warmup_iter': 20},
    {'optim_g': {'lr': 4e-4}, 'scheduler': {
        'type': 'CosineAnnealingRestartLR', 'periods': [50, 70, 90],
        'restart_weights': [1, 0.5, 0.25], 'eta_min': 1e-7}},
    {'optim_g': {'lr': 4e-4}, 'scheduler': {
        'type': 'CosineAnnealingRestartLR', 'periods': [200]},
     'warmup_iter': 10},
], ids=['multistep', 'multistep_restart', 'warmup', 'cosine', 'cosine_warm'])
def test_schedules_match_jax(train_opt):
    """Steps 0-200 in fp32. Exact, except that XLA's fp32 cos is not
    correctly rounded: the port's cosine schedule (the correctly rounded
    cos) may differ from JAX's by one ulp at a few steps."""
    from bsvd_tpu.models.lr_scheduler import build_schedule as jbuild
    from bsvd_tpu_torch.models.lr_scheduler import build_schedule
    js, ps = jbuild(train_opt), build_schedule(train_opt)
    ref = np.array([np.asarray(js(s)) for s in range(201)], np.float32)
    got = np.array([ps(s) for s in range(201)], np.float32)
    if 'Cosine' in train_opt['scheduler']['type']:
        assert np.all(np.abs(got - ref) <= np.spacing(ref))
        assert (got != ref).sum() <= 3
    else:
        np.testing.assert_array_equal(got, ref)


def test_normalize_augment_bit_equal_to_jax():
    """Every augment choice shows up over the seeds; outputs bit-equal."""
    from bsvd_tpu.data.video_train_loader import normalize_augment as jna
    from bsvd_tpu_torch.data.video_train_loader import normalize_augment
    batch = np.random.default_rng(0).integers(0, 256, (2, 3, 3, 8, 12),
                                              dtype=np.uint8)
    shapes = set()
    for seed in range(40):
        a, _ = jna(batch, np.random.default_rng(seed))
        b, b2 = normalize_augment(batch, np.random.default_rng(seed))
        np.testing.assert_array_equal(a, b)
        assert b2 is b
        shapes.add(b.shape)
    assert shapes == {(2, 3, 3, 8, 12), (2, 3, 3, 12, 8)}


@pytest.mark.parametrize('noise_shape', ['N', 'NF'])
def test_noisy_batch_bit_equal_to_jax_loader(noise_shape):
    """The JAX loader's __next__ on queued uint8 samples against
    noisy_batch on the same samples and Generator state."""
    from bsvd_tpu.data.video_train_loader import train_video_loader
    from bsvd_tpu_torch.data.video_train_loader import (noisy_batch,
                                                        synthetic_clips)
    clips = synthetic_clips(np.random.default_rng(1), 3, 4, 16, 24)
    loader = object.__new__(train_video_loader)
    loader.opt = {'noise_ival': [5, 55], 'noise_shape': noise_shape}
    loader.batch_size, loader.epoch_size, loader._emitted = 3, 1, 0
    loader.rng = np.random.default_rng(7)
    loader._queue = queue.Queue()
    for c in clips:
        loader._queue.put(c)
    ref = next(loader)
    got = noisy_batch(clips, np.random.default_rng(7), [5, 55], noise_shape)
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_npz_checkpoints_load_across_packages(tmp_path):
    """A port checkpoint loads in JAX load_npz_params with the wnet_init
    tree's exact structure (empty norm slots included), and a JAX
    checkpoint loads in the port."""
    from bsvd_tpu.models.checkpoint import (load_npz_params as jload,
                                            save_npz_params as jsave)
    from bsvd_tpu_torch.models.denoising_model import DenoisingModel
    _, _, jparams = _jax_net(5)
    opt = _opt()
    opt['path']['models'] = str(tmp_path)
    pm = DenoisingModel(copy.deepcopy(opt), device='cpu')
    pm.net.load_params(from_jax_params(jax.tree.map(np.asarray, jparams),
                                       pm.cfg))
    pm.ema_params = _map_tree(pm.net.param_tree(), torch.clone)
    path = pm.save_network([pm.net.param_tree(), pm.ema_params], 'g', 3,
                           param_key=['params', 'params_ema'])
    for key in ('params', 'params_ema'):
        back = jload(path, key)
        assert jax.tree.structure(back) == jax.tree.structure(jparams)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jparams)):
            np.testing.assert_array_equal(a, np.asarray(b))
    jpath = str(tmp_path / 'jax.npz')
    jsave(jpath, {'params': jax.tree.map(np.asarray, jparams)})
    got = pm.load_network(jpath)
    want = from_jax_params(jax.tree.map(np.asarray, jparams), pm.cfg)
    for (n1, a), (n2, b) in zip(_leaves(got), _leaves(want)):
        assert n1 == n2
        assert torch.equal(a, b)
    assert jax.tree.structure(to_jax_params(got, pm.cfg)) == \
        jax.tree.structure(jparams)


def test_resume_reproduces_the_uninterrupted_trajectory(tmp_path):
    """6 straight steps against 4 steps, save, a fresh model resumed
    from the state (check_resume's pretrain repoint for params and EMA,
    the optimizer's moments and count), and 2 more steps."""
    from bsvd_tpu_torch.utils.misc import check_resume
    from bsvd_tpu_torch.models.checkpoint import load_training_state
    from bsvd_tpu_torch.models.denoising_model import DenoisingModel
    opt = _opt(scheduler={'type': 'MultiStepLR', 'milestones': [5],
                          'gamma': 0.7})
    opt['path'].update(models=str(tmp_path / 'models'),
                       training_states=str(tmp_path / 'states'))
    os.makedirs(opt['path']['models'])
    os.makedirs(opt['path']['training_states'])
    batches = [_batch(30 + i, n=1, t=T, h=16, w=16) for i in range(6)]
    a = DenoisingModel(copy.deepcopy(opt), device='cpu')
    for i, b in enumerate(batches, 1):
        a.feed_data(b)
        a.optimize_parameters(i)
    b_ = DenoisingModel(copy.deepcopy(opt), device='cpu')
    for i, b in enumerate(batches[:4], 1):
        b_.feed_data(b)
        b_.optimize_parameters(i)
    b_.save(0, 4)
    state_path = os.path.join(opt['path']['training_states'], '4.state')
    state = load_training_state(state_path)
    assert state['iter'] == 4 and state['opt_state']['count'] == 4
    opt_c = copy.deepcopy(opt)
    opt_c['path']['resume_state'] = state_path
    check_resume(opt_c, state['iter'])
    assert opt_c['path']['pretrain_network_g'].endswith('net_g_4.npz')
    c = DenoisingModel(opt_c, device='cpu')
    c.resume_training(state)
    for i, b in enumerate(batches[4:], 5):
        c.feed_data(b)
        c.optimize_parameters(i)
    for got, want in ((c.net.param_tree(), a.net.param_tree()),
                      (c.ema_params, a.ema_params)):
        for (_, x), (_, y) in zip(_leaves(got), _leaves(want)):
            assert torch.equal(x, y)


def test_train_pipeline_runs_saves_and_auto_resumes(tmp_path):
    from bsvd_tpu_torch.data.video_train_loader import SyntheticVideoLoader
    from bsvd_tpu_torch.models.base_model import latest_resume_state
    from bsvd_tpu_torch.train import train_loop
    opt = _opt(total_iter=4)
    opt['path'].update(models=str(tmp_path / 'm'),
                       training_states=str(tmp_path / 's'))
    opt['logger'] = {'print_freq': 1, 'save_checkpoint_freq': 2}
    loader = SyntheticVideoLoader(
        {'batch_size_per_gpu': 1, 'temp_patch_size': T, 'patch_size': 16,
         'noise_ival': [5, 55], 'noise_shape': 'N', 'manual_seed': 3},
        epoch_size=3)
    model = train_loop(opt, loader, device='cpu')
    assert model.current_iter == 4
    assert latest_resume_state(opt['path']['training_states']).endswith(
        '4.state')
    assert os.path.isfile(os.path.join(opt['path']['models'],
                                       'net_g_latest.npz'))
    opt['auto_resume'] = True
    opt['train']['total_iter'] = 5
    resumed = train_loop(opt, loader, device='cpu')
    assert resumed.current_iter == 5 and resumed.optimizer.count == 5
    # val_freq with no val datasets: nothing to validate, and no raise
    # (validation itself: test_torch_eval.py)
    opt['train']['total_iter'] = 6
    validated = train_loop(dict(opt, val={'val_freq': 2}), loader,
                               device='cpu')
    assert validated.current_iter == 6


def test_unported_options_raise():
    """The perceptual loss waits for the zoo and raises; norm 'bn' builds
    and trains (tests/test_torch_options.py holds it against JAX)."""
    from bsvd_tpu_torch.models.denoising_model import DenoisingModel
    with pytest.raises(NotImplementedError):
        DenoisingModel(_opt(perceptual_opt={'type': 'PerceptualLoss'}),
                       device='cpu')
    bn = _opt()
    bn['network_g']['net2d_opt']['norm'] = 'bn'
    assert DenoisingModel(bn, device='cpu').cfg.norm == 'bn'


@pytest.mark.parametrize('name', ['L1Loss', 'MSELoss', 'CharbonnierLoss'])
@pytest.mark.parametrize('reduction', ['mean', 'sum', 'none'])
def test_losses_match_jax(name, reduction):
    from bsvd_tpu.losses import build_loss as jbuild
    from bsvd_tpu_torch.losses import build_loss
    rng = np.random.default_rng(40)
    a, b, wt = (_arr(rng, (2, 3, 4, 5)) for _ in range(3))
    opt = {'type': name, 'loss_weight': 0.5, 'reduction': reduction}
    got = build_loss(opt)(_t(a), _t(b), _t(wt))
    ref = jbuild(opt)(jnp.asarray(a), jnp.asarray(b), jnp.asarray(wt))
    _close(got, ref, rtol=1e-6, atol=1e-6)
