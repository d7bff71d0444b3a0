"""HiFaceGAN of the port against the JAX package on the CPU: the helpers
(``nearest_resize`` at sizes whose ratio is not an integer, instance norm,
the pad-excluding average pool, ``lip2d``), the generator at num_feat 4 on
64 x 64 and on 96 x 64, the multiscale discriminator on a power-iteration
tree and on a converted (``u``-free) one, three ``HiFaceGANModel`` steps
with ``net_d_iters`` 2 / ``net_d_init_iters`` 1 (G gated off at 1 and 3),
the model's checkpoints and the ``hifacegan_sr4x.yml`` command line.

The JAX functions run under ``jax.jit`` on the port's seeded weights
carried over with ``to_jax_tree`` (its trees checked against
``jax.eval_shape`` of the JAX inits). In the model test the JAX package's
``hifacegan_init`` / ``hifacegan_discriminator_init`` are replaced, for
that test only (monkeypatch), by the port's trees, so both engines start
from the same weights; nothing is drawn at random inside either step.

The model test runs both engines in float64: in fp32 G's gradients of
the two packages differ by up to 1e-2 of a tensor's largest element
(``ups.2.norm_0.mlp_beta.weight``), which hides a missing perceptual
term. Each step starts both
engines from the JAX model's weights (loaded into the port): the port's
Adam takes its bias corrections in fp32, as the JAX package's fp32 optax
does, and under x64 optax takes them in float64, which alone moves a
step by 2e-5 of itself. Each step is held in two parts (``torch_optax``):
the gradients against the JAX step's, and the port's update against the
JAX model's own optax transform on the port's recorded inputs.

Tolerances, with their reasons:

- helpers: 1e-6 x max|ref| (nearest_resize: equal bits);
- generator: 2e-4 x max|ref| (fp32 summation order through 13 SPADE
  blocks, each renormalising: 3.7e-5 seen);
- discriminator features 1e-5 x max|ref|, its power-iteration vectors
  1e-5;
- model (float64): losses 1e-12 x |ref| (3e-15 seen), the ``u`` vectors
  1e-12 (2e-16 seen), each gradient within 1e-9 x its tensor's max|ref|
  + 1e-12 x the net's (3e-12 seen); the update 1e-6 x max|ref| of each
  parameter and Adam moment (the fp32 bias corrections above).
"""

import functools
import os

import numpy as np
import pytest
import torch

from bsvd_tpu_torch.archs import build_network
from bsvd_tpu_torch.archs import hifacegan_arch as ph
from bsvd_tpu_torch.archs.discriminator_arch import SNConv2d
from bsvd_tpu_torch.convert.torch_generic import (to_jax_tree,
                                                  tree_to_state_dict)
from bsvd_tpu_torch.models.base_model import build_model
from bsvd_tpu_torch.utils.img_util import imwrite
from torch_optax import (grads_close, jax_grads, recording,
                         step_matches_optax)
from torch_threads import one_torch_thread  # noqa: F401

jax = pytest.importorskip('jax')
jnp = pytest.importorskip('jax.numpy')

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
G_OPT = {'type': 'HiFaceGAN', 'num_in_ch': 3, 'num_feat': 4,
         'crop_size': 64, 'is_train': False, 'seed': 1}
D_OPT = {'type': 'HiFaceGANDiscriminator', 'num_in_ch': 3, 'num_out_ch': 3,
         'num_d': 2, 'n_layers_d': 3, 'num_feat': 8, 'seed': 2}
LR_G, LR_D = 1e-3, 4e-3
GRAD_TOL, GRAD_FLOOR = 1e-9, 1e-12
LOSS_TOL, U_TOL = 1e-12, 1e-12


def _arr(seed, shape):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(
        np.float32)


def _nhwc(a):
    return jnp.asarray(np.transpose(a, (0, 2, 3, 1)))


def _nchw(a):
    return np.transpose(np.asarray(a), (0, 3, 1, 2))


def _rel(got, ref, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = float(np.abs(got - ref).max())
    assert err <= tol * max(float(np.abs(ref).max()), 1e-30), \
        (err, float(np.abs(ref).max()))


def _jtree(module):
    return jax.tree.map(jnp.asarray, to_jax_tree(module))


def _same_shapes(tree, shapes):
    assert jax.tree.structure(tree) == jax.tree.structure(shapes)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(shapes)):
        assert a.shape == b.shape


# ---------------------------------------------------------------------------
# helpers, generator, discriminator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('case', [
    ('nearest', (7, 9), (5, 4)), ('nearest', (5, 6), (7, 13)),
    ('nearest', (64, 96), (3, 2)), ('instance_norm', (6, 10), None),
    ('avg_pool', (7, 10), None), ('avg_pool', (8, 8), None),
    ('lip2d', (9, 6), None)],
    ids=['nearest_down', 'nearest_up', 'nearest_64x96_to_3x2', 'in',
         'pool_odd', 'pool_even', 'lip2d'])
def test_helpers_match_jax(case):
    from bsvd_tpu.archs import hifacegan_arch as jh
    name, hw, out = case
    x = _arr(3, (2, 3) + hw) * 4 - 2
    xt = torch.from_numpy(x)
    if name == 'nearest':
        got = ph.nearest_resize(xt, *out)
        ref = _nchw(jh.nearest_resize(_nhwc(x), *out))
        np.testing.assert_array_equal(got.numpy(), ref)
        return
    if name == 'instance_norm':
        got, ref = ph.instance_norm(xt), jh._instance_norm(_nhwc(x))
    elif name == 'avg_pool':
        got, ref = ph.avg_pool_excl(xt), jh._avg_pool_excl(_nhwc(x))
    else:
        logit = _arr(4, x.shape) * 12
        got = ph.lip2d(xt, torch.from_numpy(logit))
        ref = jh.lip2d(_nhwc(x), _nhwc(logit))
    _rel(got, _nchw(ref), 1e-6)


@pytest.mark.parametrize('hw', [(64, 64), (96, 64)], ids=['64', '96x64'])
def test_generator_matches_jax(hw):
    """The full net (phase 4); 96 x 64 resizes the LQ to sizes that are
    not powers of two."""
    from bsvd_tpu.archs import hifacegan_arch as jh
    net = build_network(G_OPT, 'cpu').eval()
    tree = _jtree(net)
    _same_shapes(tree, jax.eval_shape(
        lambda: jh.hifacegan_init(jax.random.PRNGKey(0), 3, 4, 5)))
    x = _arr(5, (1, 3) + hw)
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    fn = jax.jit(functools.partial(jh.hifacegan_apply, scale_ratio=5,
                                   phase=4))
    _rel(got, _nchw(fn(tree, _nhwc(x))), 2e-4)


def test_generator_train_phase_and_registry():
    net = build_network(dict(G_OPT, is_train=True, init_train_phase=2),
                        'cpu')
    assert net.phase == 3 and net.scale_ratio == 5
    assert build_network(G_OPT, 'cpu').phase == 4


def _folded(net):
    """The net's state with each spectral-norm conv given as a plain
    ``weight`` (its raw one: the values do not matter here) and no
    ``weight_orig`` / ``weight_u`` / ``weight_v``, as in a converted
    checkpoint."""
    state = {}
    for k, v in net.state_dict().items():
        if k.endswith('.weight_orig'):
            state[k[:-len('_orig')]] = v
        elif not k.endswith(('.weight_u', '.weight_v')):
            state[k] = v
    return state


@pytest.mark.parametrize('mode', ['power_iteration', 'converted'])
def test_discriminator_matches_jax(mode):
    """Every feature of both discriminators; with spectral norm, also the
    power iteration's new ``u`` of every conv (the JAX apply's aux) and
    the tree's ``u`` leaves. The converted state (sigma folded, no ``u``)
    loads into the built net, whose convs it turns plain, as the JAX
    package runs plain convs on a tree without ``u``; ``norm_d`` chooses
    neither."""
    from bsvd_tpu.archs import hifacegan_arch as jh
    net = build_network(dict(D_OPT, norm_d='instance'), 'cpu')
    assert all(isinstance(c, SNConv2d) for _, c in _d_convs(net))
    if mode == 'converted':
        net.load_state_dict(_folded(net))
        assert not any(isinstance(c, SNConv2d) for _, c in _d_convs(net))
    tree = _jtree(net)
    shapes = jax.eval_shape(lambda: jh.hifacegan_discriminator_init(
        jax.random.PRNGKey(0), 3, 3, True, 2, 3, 8))
    if mode == 'converted':
        shapes = _drop_u(shapes)
    _same_shapes(tree, shapes)
    x = _arr(6, (2, 6, 64, 64))

    def apply(p, xx):
        aux = {}
        return jh.hifacegan_discriminator_apply(p, xx, 2, 3, aux=aux), aux
    ref, aux = jax.jit(apply)(tree, _nhwc(x))
    with torch.no_grad():
        got, us = net.forward_stats(torch.from_numpy(x), train=True)
    assert len(got) == len(ref) == 2
    for d_got, d_ref in zip(got, ref):
        assert len(d_got) == len(d_ref) == 4
        for t_got, t_ref in zip(d_got, d_ref):
            _rel(t_got, _nchw(t_ref), 1e-5)
    assert sorted(us) == sorted(aux)
    assert len(us) == (8 if mode == 'power_iteration' else 0)
    for k, u in aux.items():
        np.testing.assert_allclose(us[k][0].numpy(), np.asarray(u),
                                   atol=1e-5)


def test_discriminator_conv_kind_follows_the_state(tmp_path):
    """A spectral-norm state loaded into a net made plain makes it
    spectral again, strictly and with the same bits; a u-free checkpoint
    file raises KeyError through ``load_torch_generic``, as the JAX
    package's loader does on its template with ``u``."""
    from bsvd_tpu_torch.convert.torch_generic import load_torch_generic
    from bsvd_tpu_torch.models.checkpoint import save_npz_params
    sn = build_network(D_OPT, 'cpu')
    net = build_network(dict(D_OPT, seed=5), 'cpu')
    net.load_state_dict(_folded(net))
    path = str(tmp_path / 'd_folded.npz')
    save_npz_params(path, {'params': to_jax_tree(net)})
    net.load_state_dict(sn.state_dict())
    assert all(isinstance(c, SNConv2d) for _, c in _d_convs(net))
    for k, v in sn.state_dict().items():
        assert torch.equal(net.state_dict()[k], v), k
    with pytest.raises(KeyError, match='model0/0/u'):
        load_torch_generic(path, build_network(D_OPT, 'cpu'))


def _d_convs(net):
    return [c for i in range(net.num_d)
            for c in getattr(net, f'discriminator_{i}').convs()]


def _drop_u(node):
    return {k: _drop_u(v) for k, v in node.items() if k != 'u'} \
        if isinstance(node, dict) else node


# ---------------------------------------------------------------------------
# HiFaceGANModel
# ---------------------------------------------------------------------------

def _vgg_npz(path, seed=9, dtype=np.float32):
    """conv1_1 of a torchvision-layout VGG19 that both packages read (fp32
    values, stored as ``dtype``)."""
    rng = np.random.default_rng(seed)
    np.savez(path, **{'features.0.weight': rng.normal(
        0, 0.27, (64, 3, 3, 3)).astype(np.float32).astype(dtype),
        'features.0.bias': rng.uniform(-0.1, 0.1, 64).astype(
            np.float32).astype(dtype)})
    return str(path)


def _model_opt(tmp_path, **train_over):
    train = {'optim_g': {'type': 'Adam', 'lr': LR_G, 'betas': [0.9, 0.99]},
             'optim_d': {'type': 'Adam', 'lr': LR_D, 'betas': [0.5, 0.999]},
             'scheduler': {'type': 'MultiStepLR', 'milestones': [2],
                           'gamma': 0.5},
             'total_iter': 3, 'net_d_iters': 2, 'net_d_init_iters': 1,
             'pixel_opt': {'type': 'L1Loss', 'loss_weight': 1.0},
             'perceptual_opt': {
                 'type': 'PerceptualLoss', 'layer_weights': {'conv1_1': 1.0},
                 'use_input_norm': False, 'perceptual_weight': 0.1,
                 'style_weight': 0, 'criterion': 'l1',
                 'pretrain_path': _vgg_npz(tmp_path / 'vgg.npz')},
             'gan_opt': {'type': 'MultiScaleGANLoss', 'gan_type': 'lsgan',
                         'loss_weight': 1.0},
             'feature_matching_opt': {'type': 'GANFeatLoss',
                                      'criterion': 'l1', 'loss_weight': 10.0}}
    train.update(train_over)
    for k in ('m', 's'):
        os.makedirs(tmp_path / k, exist_ok=True)
    return {'name': 'hifacegan_parity', 'model_type': 'HiFaceGANModel',
            'is_train': True, 'num_gpu': 1, 'manual_seed': 0, 'scale': 1,
            'network_g': G_OPT, 'network_d': D_OPT,
            'path': {'models': str(tmp_path / 'm'),
                     'training_states': str(tmp_path / 's')},
            'train': train, 'logger': {}}


def _batch():
    return {'lq': _arr(7, (2, 3, 64, 64)), 'gt': _arr(8, (2, 3, 64, 64))}


def _port_state(jtree):
    """A JAX tree as a port state dict of float64 numpy arrays."""
    return tree_to_state_dict(jax.tree.map(
        lambda a: np.array(a, np.float64), jtree))


def _f64(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)


@pytest.fixture
def same_inits(monkeypatch):
    """The JAX package's HiFaceGAN inits replaced by the port's seeded
    trees (this test only)."""
    from bsvd_tpu.archs import hifacegan_arch as jh
    monkeypatch.setattr(jh, 'hifacegan_init', lambda key, *a: _jtree(
        build_network(G_OPT, 'cpu')))
    monkeypatch.setattr(jh, 'hifacegan_discriminator_init',
                        lambda key, *a: _jtree(build_network(D_OPT, 'cpu')))


def test_model_three_steps_match_jax(tmp_path, same_inits):
    """Steps 1-3 of both engines in float64 (the JAX model under
    ``jax.enable_x64`` with float64 trees, Adam states and VGG weights;
    the port's nets, VGG and batch cast to float64): the logged losses at
    each step; D's gradients against the JAX step's (read off its Adam
    moments) and D's update against the JAX model's ``tx_d`` on the port's
    recorded inputs at every step; the spectral-norm ``u`` of every D
    conv after each step (folded after D's update); G the same bits and
    its Adam count 0 after the gated step 1, its gradients and update held
    as D's at step 2 (its count 1), and G unchanged again by step 3."""
    from bsvd_tpu.models import build_model as jax_build_model
    from bsvd_tpu.parallel.mesh import replicated_sharding
    opt = _model_opt(tmp_path)
    _vgg_npz(opt['train']['perceptual_opt']['pretrain_path'],
             dtype=np.float64)
    batch = _batch()
    with jax.enable_x64(True):
        jm = jax_build_model(dict(opt))
        jm.params = jm.net.params = _f64(jm.params)
        jm.d_params = jm.net_d.params = _f64(jm.d_params)
        jm.opt_state = jm.tx_g.init(jm.params)
        jm.opt_state_d = jm.tx_d.init(jm.d_params)
        for name in ('params', 'opt_state', 'd_params', 'opt_state_d'):
            setattr(jm, name, jax.device_put(getattr(jm, name),
                                             replicated_sharding(jm.mesh)))
        pm = build_model(dict(opt), device='cpu')
        for m in (pm.net, pm.net_d, pm.cri_perceptual.vgg):
            m.double()
        for optim in (pm.optimizer, pm.optimizer_d):
            optim.mu = [m.double() for m in optim.mu]
            optim.nu = [v.double() for v in optim.nu]
        steps = {'d': (pm.net_d, pm.optimizer_d, recording(pm.optimizer_d),
                       'tx_d', 'opt_state_d', 0.5),
                 'g': (pm.net, pm.optimizer, recording(pm.optimizer), 'tx_g',
                       'opt_state', 0.9)}
        g0 = {k: v.clone() for k, v in pm.net.state_dict().items()}
        for it in (1, 2, 3):
            for net, tree in ((pm.net, jm.params), (pm.net_d, jm.d_params)):
                net.load_state_dict({k: torch.from_numpy(v) for k, v in
                                     _port_state(tree).items()})
            g_before = {k: v.clone() for k, v in pm.net.state_dict().items()}
            before = {k: jax.tree.map(np.array, getattr(jm, v[4]))
                      for k, v in steps.items()}
            jm.feed_data({k: v.astype(np.float64) for k, v in batch.items()})
            jm.optimize_parameters(it)
            pm.feed_data(batch)
            pm.lq, pm.gt = pm.lq.double(), pm.gt.double()
            pm.optimize_parameters(it)
            for key, (net, optim, records, tx, state, b1) in steps.items():
                if key == 'g' and it != 2:
                    continue
                assert len(records) == (it if key == 'd' else 1)
                want = _port_state(jax_grads(before[key],
                                             getattr(jm, state), b1))
                grads_close(records[-1]['grads'], want, GRAD_TOL, GRAD_FLOOR)
                step_matches_optax(getattr(jm, tx), records[-1], optim)
            jl, pl = dict(jm.log_dict), pm.get_current_log()
            assert list(pl) == ['l_g_pix', 'l_g_percep', 'l_g_gan',
                                'l_g_feat', 'l_d_real', 'l_d_fake']
            assert sorted(jl) == sorted(pl)
            for k in jl:
                _rel(pl[k], jl[k], LOSS_TOL)
            d_want = _port_state(jm.d_params)
            d_got = pm.net_d.state_dict()
            us = [k for k in d_want if k.endswith('weight_u')]
            assert len(us) == 8
            for k in us:
                np.testing.assert_allclose(d_got[k].numpy(), d_want[k],
                                           atol=U_TOL,
                                           err_msg=f'{k} after step {it}')
            g_same = all(torch.equal(v, g_before[k])
                         for k, v in pm.net.state_dict().items())
            assert g_same == (it != 2), it
            assert pm.optimizer.count == (0 if it == 1 else 1)
            assert pm.optimizer_d.count == it
            if it == 1:
                g_want = _port_state(jm.params)
                for k, v in pm.net.state_dict().items():
                    assert torch.equal(v, g0[k])
                    np.testing.assert_array_equal(v.numpy(), g_want[k])
        assert int(jm.opt_state[0][0]) == 1
        assert int(jm.opt_state_d[0][0]) == 3


def test_model_rejects_ema_and_keeps_d_state(tmp_path):
    """ema_decay > 0 raises, as in JAX; save writes net_d beside net_g
    and D's optimizer state, which a resumed model reads back."""
    from bsvd_tpu_torch.models.checkpoint import load_training_state
    with pytest.raises(NotImplementedError, match='EMA'):
        build_model(_model_opt(tmp_path, ema_decay=0.999), device='cpu')
    opt = _model_opt(tmp_path)
    opt['train'].pop('perceptual_opt')
    pm = build_model(opt, device='cpu')
    for it in (1, 2):
        pm.feed_data(_batch())
        pm.optimize_parameters(it)
    pm.save(0, 2)
    assert (tmp_path / 'm' / 'net_g_2.npz').exists()
    assert (tmp_path / 'm' / 'net_d_2.npz').exists()
    st = load_training_state(str(tmp_path / 's' / '2.state'))
    assert st['opt_state']['count'] == 1
    assert st['extra']['opt_state_d']['count'] == 2
    fresh = build_model(opt, device='cpu')
    fresh.resume_training(st)
    assert fresh.optimizer.count == 1 and fresh.optimizer_d.count == 2
    for name, m in st['extra']['opt_state_d']['mu'].items():
        assert torch.equal(fresh.optimizer_d.state_dict()['mu'][name], m)


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

def test_train_cli_from_the_shipped_yml(tmp_path, monkeypatch):
    """``train_pipeline`` on options/train/hifacegan_sr4x.yml with
    --device cpu, at num_feat 4 and 64 x 64 crops (the VGG19 at random
    weights): 2 iterations, the last validation's PSNR, the saved G and
    D, then --auto_resume to 3."""
    from bsvd_tpu_torch.train import train_pipeline
    monkeypatch.delenv('BSVD_VGG_PRETRAIN_PATH', raising=False)
    rng = np.random.default_rng(11)
    for i in range(2):
        gt = rng.integers(0, 256, (64, 64, 3)).astype(np.uint8)
        imwrite(gt, str(tmp_path / 'gt' / f'{i:03d}.png'))
        lq = gt.reshape(16, 4, 16, 4, 3).mean((1, 3)).round()
        lq = np.kron(lq, np.ones((4, 4, 1))).astype(np.uint8)
        imwrite(lq, str(tmp_path / 'lq' / f'{i:03d}.png'))

    def cmd(iters, *extra):
        return ['-opt', os.path.join(ROOT, 'options', 'train',
                                     'hifacegan_sr4x.yml'),
                '--device', 'cpu', *extra, '--force_yml',
                *(f'datasets:{ph_}:dataroot_{k}={tmp_path / k}'
                  for ph_ in ('train', 'val') for k in ('gt', 'lq')),
                'datasets:train:gt_size=64', 'network_g:num_feat=4',
                'network_d:num_feat=8', 'datasets:train:num_worker_per_gpu=1',
                'train:perceptual_opt:layer_weights:relu5_1=0',
                f'train:total_iter={iters}', 'val:val_freq=1000',
                'logger:save_checkpoint_freq=2']
    model = train_pipeline(str(tmp_path), cmd=cmd(2))
    assert type(model).__name__ == 'HiFaceGANModel'
    assert model.net.phase == 4 and model.optimizer_d.count == 2
    log = model.get_current_log()
    assert all(np.isfinite(v) for v in log.values()), log
    exp = tmp_path / 'experiments' / 'hifacegan_sr4x'
    assert (exp / 'models' / 'net_d_latest.npz').exists()
    assert (exp / 'models' / 'net_g_latest.npz').exists()
    assert (exp / 'training_states' / '2.state').exists()
    resumed = train_pipeline(str(tmp_path), cmd=cmd(3, '--auto_resume'))
    assert resumed.current_iter == 3
    assert resumed.optimizer.count == 3 and resumed.optimizer_d.count == 3
