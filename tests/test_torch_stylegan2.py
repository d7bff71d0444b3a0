"""StyleGAN2 of the port against the JAX package on the CPU: ``upfirdn2d``
(up, down, asymmetric and 4-value pads, a negative pad, odd and even
kernels) and its helpers, the modulated conv in each mode, the generator
(out_size 32, narrow 0.25, num_mlp 2) with stored noise, explicit noise,
truncation and two styles, the discriminator, the weights carried both
ways (``convert_stylegan2_state`` against the JAX package's on a BasicSR
state dict, the trees against ``jax.eval_shape`` of the JAX inits, save
and load), ``StyleGAN2Model`` steps covering d / d+r1 / g / g+path, its
save / resume and eval mode, ``SingleImageDataset`` / ``FFHQDataset``
item by item, and the train command line.

The JAX functions run under ``jax.jit``; the nets carry the port's seeded
weights, with every noise strength and bias set nonzero (the inits start
them at 0 and 1), to the JAX trees. In the model test the JAX package's
``stylegan2_generator_init`` / ``stylegan2_discriminator_init`` are
replaced, for that test only (monkeypatch), by those trees. The JAX model
draws its styles and noise inside its jitted steps from its own key
chain; the test derives the same draws from the same keys outside the
step (``_jax_draws``: the model's ``_key`` split as its
``optimize_parameters`` splits it, its ``_sample_styles`` method called on
the step's key) and patches the port model object's ``draws_d`` /
``draws_g`` to return them, so both engines see the same styles, noise,
path latents and probe noise.

Tolerances, with their reasons:

- ops and modulated conv: 1e-5 x max|ref| (summation order);
- generator: 1e-5 x max|ref|; discriminator: 1e-5 x max|ref|;
- conversions: equal bits;
- model (fp32, each engine on its own trajectory): losses 1e-4 x |ref|
  at each step; each gradient within 1e-2 x its tensor's max|ref| +
  1e-5 x the net's (1.3e-3 seen at step 3: the steps before move
  elements whose gradient is at rounding level by a whole Adam step, lr
  x g / (|g| + eps), of the noise's sign); each update (parameters and
  Adam moments) against the JAX model's optax transform on the port's
  recorded inputs within 1e-6 x max|ref| (``torch_optax``); the EMA's
  move against the JAX package's ``ema_update`` of the port's values
  within 1e-2 of the move; the mean path length 1e-4 x |ref|;
- datasets: equal bits.
"""

import functools
import os

import numpy as np
import pytest
import torch

from bsvd_tpu_torch.archs import build_network
from bsvd_tpu_torch.archs import stylegan2_arch as ps
from bsvd_tpu_torch.convert.torch_generic import (from_jax_tree,
                                                  load_torch_generic,
                                                  to_jax_tree)
from bsvd_tpu_torch.models.base_model import build_model
from bsvd_tpu_torch.ops import stylegan_ops as po
from bsvd_tpu_torch.utils.img_util import imwrite
from torch_optax import (grads_close, jax_grads, recording,
                         step_matches_optax)
from torch_threads import one_torch_thread  # noqa: F401

jax = pytest.importorskip('jax')
jnp = pytest.importorskip('jax.numpy')

SIZE, NSF = 32, 16
G_OPT = {'type': 'StyleGAN2Generator', 'out_size': SIZE,
         'num_style_feat': NSF, 'num_mlp': 2, 'channel_multiplier': 2,
         'narrow': 0.25, 'seed': 3}
D_OPT = {'type': 'StyleGAN2Discriminator', 'out_size': SIZE,
         'channel_multiplier': 2, 'narrow': 0.25, 'seed': 4}
LR = 2e-3
GRAD_TOL, GRAD_FLOOR = 1e-2, 1e-5


def _arr(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _nhwc(a):
    return jnp.asarray(np.transpose(np.asarray(a), (0, 2, 3, 1)))


def _nchw(a):
    return np.transpose(np.asarray(a), (0, 3, 1, 2))


def _rel(got, ref, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = float(np.abs(got - ref).max())
    assert err <= tol * max(float(np.abs(ref).max()), 1e-30), \
        (err, float(np.abs(ref).max()))


def _net(opt, seed=5):
    """The port's net with its noise strengths and biases set to seeded
    draws (N(0, 0.2); modulation biases around 1)."""
    net = build_network(opt, 'cpu')
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith('bias') or p.ndim == 1:
                base = 1.0 if 'modulation' in name else 0.0
                p.copy_(base + 0.2 * torch.randn(p.shape, generator=gen))
    return net


def _jtree(net):
    return jax.tree.map(jnp.asarray, to_jax_tree(net))


def _same_shapes(tree, shapes):
    assert jax.tree.structure(tree) == jax.tree.structure(shapes)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(shapes)):
        assert a.shape == b.shape


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('up,down,pad,kernel', [
    (2, 1, (2, 1), [1, 3, 3, 1]), (1, 2, (1, 1), [1, 3, 3, 1]),
    (1, 1, (2, 0, 1, 3), [1, 2, 1]), (3, 2, (-1, 2), [1, 3, 3, 1]),
    (2, 2, (0, 1, 2, 0), [1, 2, 1]),
    (1, 1, (1, 1), [[1., 2., 0.], [0., 1., 3.], [2., 0., 1.]])],
    ids=['up2', 'down2', 'pad4_odd', 'up3_down2_neg', 'up_down_pad4',
         'kernel_2d_odd'])
def test_upfirdn2d_matches_jax(up, down, pad, kernel):
    from bsvd_tpu.ops import stylegan_ops as jo
    x = _arr(1, (2, 3, 9, 7))
    k = po.make_resample_kernel(kernel)
    np.testing.assert_array_equal(
        k.numpy(), np.asarray(jo.make_resample_kernel(kernel)))
    got = po.upfirdn2d(torch.from_numpy(x), k, up, down, pad)
    ref = jax.jit(functools.partial(jo.upfirdn2d, up=up, down=down,
                                    pad=pad))(_nhwc(x), jnp.asarray(k))
    _rel(got, _nchw(ref), 1e-5)


@pytest.mark.parametrize('fn', ['upsample', 'downsample', 'fused_lrelu'])
def test_stylegan_helpers_match_jax(fn):
    from bsvd_tpu.ops import stylegan_ops as jo
    x = _arr(2, (2, 4, 8, 6))
    if fn == 'fused_lrelu':
        b = _arr(3, (4,))
        got = po.fused_leaky_relu(torch.from_numpy(x), torch.from_numpy(b))
        ref = _nchw(jo.fused_leaky_relu(_nhwc(x), jnp.asarray(b)))
    else:
        k = po.make_resample_kernel([1, 3, 3, 1])
        got = getattr(po, fn)(torch.from_numpy(x), k)
        ref = _nchw(getattr(jo, fn)(_nhwc(x), jnp.asarray(k)))
    _rel(got, ref, 1e-5)


@pytest.mark.parametrize('mode,demod,k', [
    (None, True, 3), (None, False, 1), ('upsample', True, 3),
    ('downsample', True, 3), ('upsample', False, 3)],
    ids=['plain', 'torgb', 'up', 'down', 'up_nodemod'])
def test_modulated_conv_matches_jax(mode, demod, k):
    """The port's ModulatedConv2d against ``modulated_conv2d`` on its
    tree, per-sample styles over a batch of 3."""
    from bsvd_tpu.archs import stylegan2_arch as js
    m = ps.ModulatedConv2d(6, 5, k, NSF, demod, mode)
    with torch.no_grad():
        m.modulation.bias.copy_(torch.from_numpy(1 + _arr(4, (6,), 0.3)))
    tree = _jtree(m)
    x, style = _arr(5, (3, 6, 8, 10)), _arr(6, (3, NSF))
    with torch.no_grad():
        got = m(torch.from_numpy(x), torch.from_numpy(style))
    ref = jax.jit(functools.partial(js.modulated_conv2d, demodulate=demod,
                                    sample_mode=mode))(
        tree, _nhwc(x), jnp.asarray(style))
    _rel(got, _nchw(ref), 1e-5)


# ---------------------------------------------------------------------------
# generator and discriminator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('case', ['stored_noise', 'explicit_noise',
                                  'truncation', 'two_styles'])
def test_generator_matches_jax(case):
    from bsvd_tpu.archs import stylegan2_arch as js
    net = _net(G_OPT).eval()
    tree = _jtree(net)
    z = [_arr(7, (3, NSF))] + ([_arr(8, (3, NSF))]
                               if case == 'two_styles' else [])
    kw_t, kw_j = {}, {}
    if case == 'explicit_noise':
        noise = [_arr(20 + i, (3, 1, 2 ** ((i + 5) // 2),
                               2 ** ((i + 5) // 2)))
                 for i in range(net.num_layers)]
        kw_t['noise'] = [torch.from_numpy(n) for n in noise]
        kw_j['noise'] = [_nhwc(n) for n in noise]
    else:
        kw_t['randomize_noise'] = kw_j['randomize_noise'] = False
    if case == 'truncation':
        mean = _arr(9, (1, NSF))
        kw_t.update(truncation=0.7, truncation_latent=torch.from_numpy(mean))
        kw_j.update(truncation=0.7, truncation_latent=jnp.asarray(mean))
    if case == 'two_styles':
        kw_t['inject_index'] = kw_j['inject_index'] = 3
    with torch.no_grad():
        got, lat = net([torch.from_numpy(s) for s in z], **kw_t)
    ref, jlat = jax.jit(lambda p, s: js.stylegan2_generator_apply(
        p, s, SIZE, **kw_j))(tree, [jnp.asarray(s) for s in z])
    _rel(got, _nchw(ref), 1e-5)
    _rel(lat, jlat, 1e-5)


def test_generator_default_inject_index_and_drawn_noise():
    """Two styles mix at num_latent // 2 by default; drawn noise comes
    from the generator given (the same draws, the same image) and moves
    the image."""
    net = _net(G_OPT).eval()
    z = [torch.from_numpy(_arr(7, (2, NSF))),
         torch.from_numpy(_arr(8, (2, NSF)))]
    with torch.no_grad():
        _, lat = net(z, randomize_noise=False)
        w = [net.get_latent(s) for s in z]
        half = net.num_latent // 2
        assert torch.equal(lat[:, :half], w[0][:, None].expand(-1, half, -1))
        assert torch.equal(lat[:, half:], w[1][:, None].expand(
            -1, net.num_latent - half, -1))
        a = net(z, generator=torch.Generator().manual_seed(1))[0]
        b = net(z, generator=torch.Generator().manual_seed(1))[0]
        c = net(z, generator=torch.Generator().manual_seed(2))[0]
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_discriminator_matches_jax():
    from bsvd_tpu.archs import stylegan2_arch as js
    net = _net(D_OPT)
    tree = _jtree(net)
    x = _arr(10, (8, 3, SIZE, SIZE))
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    ref = jax.jit(js.stylegan2_discriminator_apply)(tree, _nhwc(x))
    _rel(got, ref, 1e-5)


def test_weights_carried_both_ways(tmp_path):
    """Trees of both nets against ``jax.eval_shape`` of the JAX inits
    (the 5-D modulated weights, noise buffers, constant input and to-RGB
    bias included); tree -> state -> tree the same bits; the port's
    ``convert_stylegan2_state`` of a generator state dict equal to the
    JAX package's; a BasicSR-named ``.pth`` and a saved ``.npz`` load
    into a fresh net strictly."""
    from bsvd_tpu.archs import stylegan2_arch as js
    shapes = {
        'g': jax.eval_shape(lambda: js.stylegan2_generator_init(
            jax.random.PRNGKey(0), SIZE, NSF, 2, 2, 0.25)),
        'd': jax.eval_shape(lambda: js.stylegan2_discriminator_init(
            jax.random.PRNGKey(0), SIZE, 2, 0.25))}
    for key, opt in (('g', G_OPT), ('d', D_OPT)):
        net = _net(opt)
        tree = to_jax_tree(net)
        _same_shapes(tree, shapes[key])
        state = from_jax_tree(tree, net)
        own = net.state_dict()
        assert set(state) == set(own)
        for k, v in own.items():
            assert torch.equal(state[k], v), k
        fresh = build_network(dict(opt, seed=77), 'cpu')
        torch.save({'params': own}, tmp_path / f'{key}.pth')
        load_torch_generic(str(tmp_path / f'{key}.pth'), fresh, 'params')
        for k, v in own.items():
            assert torch.equal(fresh.state_dict()[k], v), k
    g = _net(G_OPT)
    ours = to_jax_tree(g)
    theirs = js.convert_stylegan2_state(
        {k: v.numpy() for k, v in g.state_dict().items()})
    assert jax.tree.structure(ours) == jax.tree.structure(theirs)
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(theirs)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# StyleGAN2Model
# ---------------------------------------------------------------------------

def _model_opt(tmp_path, **train_over):
    train = {'optim_g': {'type': 'Adam', 'lr': LR},
             'optim_d': {'type': 'Adam', 'lr': LR},
             'total_iter': 3,
             'gan_opt': {'type': 'GANLoss', 'gan_type': 'wgan_softplus',
                         'loss_weight': 1.0},
             'r1_reg_weight': 10, 'path_reg_weight': 2,
             'net_g_reg_every': 3, 'net_d_reg_every': 2, 'mixing_prob': 0.5,
             'ema_decay': 0.9}
    train.update(train_over)
    for k in ('m', 's'):
        os.makedirs(tmp_path / k, exist_ok=True)
    return {'name': 'stylegan2_parity', 'model_type': 'StyleGAN2Model',
            'is_train': True, 'num_gpu': 1, 'manual_seed': 7,
            'network_g': G_OPT, 'network_d': D_OPT,
            'path': {'models': str(tmp_path / 'm'),
                     'training_states': str(tmp_path / 's')},
            'train': train, 'logger': {}}


def _jax_draws(jm, batch, do_path):
    """The draws of the JAX model's next ``optimize_parameters``, from its
    key chain (advancing ``jm._key`` a copy of it, not the model's)."""
    num_layers = jm.net.num_layers

    def noise(key, b):
        keys = jax.random.split(key, num_layers)
        return [torch.from_numpy(_nchw(jax.random.normal(
            keys[i], (b, 2 ** ((i + 5) // 2), 2 ** ((i + 5) // 2), 1))))
            for i in range(num_layers)]

    def styles(key, b):
        return [torch.from_numpy(np.asarray(s))
                for s in jm._sample_styles(key, b)]
    _, kd, kg = jax.random.split(jm._key, 3)
    k1, k2 = jax.random.split(kd)
    d = {'styles': styles(k1, batch), 'noise': noise(k2, batch)}
    k1, k2, k3, k4 = jax.random.split(kg, 4)
    g = {'styles': styles(k1, batch), 'noise': noise(k2, batch)}
    if do_path:
        n = max(1, batch // 2)
        g.update(path_z=torch.from_numpy(np.asarray(jax.random.normal(
            k3, (n, jm.num_style_feat)))), path_noise=noise(k4, n),
            path_probe=torch.from_numpy(np.asarray(jax.random.normal(
                k4, (n, 3, SIZE, SIZE)))))
    return d, g


@pytest.fixture
def same_inits(monkeypatch):
    """The JAX package's StyleGAN2 inits replaced by the port's trees (this
    test only)."""
    from bsvd_tpu.archs import stylegan2_arch as js
    monkeypatch.setattr(js, 'stylegan2_generator_init',
                        lambda *a, **k: _jtree(_net(G_OPT)))
    monkeypatch.setattr(js, 'stylegan2_discriminator_init',
                        lambda *a, **k: _jtree(_net(D_OPT, seed=6)))


def _port_model(opt):
    pm = build_model(dict(opt), device='cpu')
    pm.net.load_state_dict(_net(G_OPT).state_dict())
    pm.net_g_ema.load_state_dict(_net(G_OPT).state_dict())
    pm.net_d.load_state_dict(_net(D_OPT, seed=6).state_dict())
    return pm


def test_model_steps_match_jax(tmp_path, same_inits):
    """Iterations 1-3 with net_d_reg_every 2 and net_g_reg_every 3: 1 runs
    d and g, 2 d+r1 and g, 3 d and g+path; the JAX model's draws fed to
    the port (``draws_d`` / ``draws_g`` patched on the port's model). At
    every iteration: the logged losses; each net's gradients against the
    JAX step's (its Adam ``mu``: b1 is 0); each net's update against the
    JAX model's ``tx_g`` / ``tx_d`` on the port's recorded inputs; the
    EMA's move against the JAX package's ``ema_update`` of the port's
    values; the mean path length. The Adam counts and learning rates
    (lr x ratio, b1 0, b2 0.99 ** ratio)."""
    from bsvd_tpu.models import build_model as jax_build_model
    from bsvd_tpu.models.base_model import BaseModel as JaxBaseModel
    opt = _model_opt(tmp_path)
    jm = jax_build_model(dict(opt))
    pm = _port_model(opt)
    assert pm.optimizer.b1 == 0 and pm.optimizer.b2 == 0.99 ** 0.75
    assert float(pm.optimizer.schedule(0)) == np.float32(LR * 0.75)
    assert float(pm.optimizer_d.schedule(0)) == np.float32(LR * 2 / 3)
    steps = {'d': (pm.net_d, pm.optimizer_d, recording(pm.optimizer_d),
                   'tx_d', 'opt_state_d'),
             'g': (pm.net, pm.optimizer, recording(pm.optimizer), 'tx_g',
                   'opt_state')}
    real = _arr(11, (4, 3, SIZE, SIZE), 0.5)
    for it in (1, 2, 3):
        do_path = it % 3 == 0
        d, g = _jax_draws(jm, 4, do_path)
        pm.draws_d = lambda b, d=d: d
        pm.draws_g = lambda b, p, g=g: g
        before = {k: jax.tree.map(np.array, getattr(jm, v[4]))
                  for k, v in steps.items()}
        ema_before = {n: p.detach().clone()
                      for n, p in pm.net_g_ema.named_parameters()}
        jm.feed_data({'gt': real})
        jm.optimize_parameters(it)
        pm.feed_data({'gt': real})
        pm.optimize_parameters(it)
        for key, (net, optim, records, tx, state) in steps.items():
            assert len(records) == it and optim.count == it
            want = from_jax_tree(jax_grads(before[key], getattr(jm, state),
                                           0.0), net)
            grads_close(records[-1]['grads'], want, GRAD_TOL, GRAD_FLOOR)
            step_matches_optax(getattr(jm, tx), records[-1], optim)
        jl, pl = dict(jm.log_dict), pm.get_current_log()
        assert list(pl) == ['l_d', 'l_d_r1', 'real_score', 'fake_score',
                            'l_g', 'l_g_path']
        assert sorted(jl) == sorted(pl)
        assert (pl['l_d_r1'] > 0) == (it == 2)
        assert (pl['l_g_path'] > 0) == (it == 3)
        for k in jl:
            _rel(np.float32(pl[k]), jl[k], 1e-4)
        params = dict(pm.net.named_parameters())
        want = JaxBaseModel.ema_update(
            {n: jnp.asarray(v.numpy()) for n, v in ema_before.items()},
            {n: jnp.asarray(p.detach().numpy()) for n, p in params.items()},
            pm.ema_decay)
        for n, e in pm.net_g_ema.named_parameters():
            move = np.asarray(want[n], np.float64) - ema_before[n].numpy()
            err = np.abs((e - ema_before[n]).detach().numpy() - move).max()
            assert err <= 1e-2 * np.abs(move).max(), (n, err)
        _rel(pm.mean_path_length, jm.mean_path_length, 1e-4)
    assert float(pm.mean_path_length) > 0


def test_model_save_resume_and_eval(tmp_path):
    """save writes net_g (params, params_ema), net_d and both optimizers
    with mean_path_length; a resumed model has them; a model out of
    training loads params_ema and samples finite images."""
    from bsvd_tpu_torch.models.checkpoint import load_training_state
    opt = _model_opt(tmp_path, net_g_reg_every=2)
    pm = build_model(dict(opt), device='cpu')
    for it in (1, 2):
        pm.feed_data({'gt': _arr(12, (2, 3, SIZE, SIZE), 0.5)})
        pm.optimize_parameters(it)
    pm.save(0, 2)
    st = load_training_state(str(tmp_path / 's' / '2.state'))
    g_state, d_state = st['opt_state']
    assert g_state['count'] == d_state['count'] == 2
    assert float(st['extra']['mean_path_length']) == float(
        pm.mean_path_length) > 0
    fresh = build_model(dict(opt), device='cpu')
    fresh.resume_training(st)
    assert fresh.optimizer.count == 2
    assert float(fresh.mean_path_length) == float(pm.mean_path_length)
    ckpt = str(tmp_path / 'm' / 'net_g_2.npz')
    with np.load(ckpt) as z:
        assert any(k.startswith('params_ema/') for k in z.files)
    ev = dict(opt, is_train=False, path=dict(
        opt['path'], pretrain_network_g=ckpt, param_key_g='params_ema'))
    em = build_model(ev, device='cpu')
    for k, v in pm.net_g_ema.state_dict().items():
        assert torch.equal(em.net.state_dict()[k], v), k
    out = em.test(num_samples=3)
    assert out.shape == (3, 3, SIZE, SIZE) and np.isfinite(out).all()
    assert em.validation(None, 0, None) == {}


# ---------------------------------------------------------------------------
# datasets and the command line
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def faces(tmp_path_factory):
    """5 PNG faces under img/ and a meta-info file naming two of them."""
    root = tmp_path_factory.mktemp('ffhq')
    rng = np.random.default_rng(13)
    for i in range(5):
        img = rng.integers(0, 256, (SIZE, SIZE, 3)).astype(np.uint8)
        imwrite(img, str(root / 'img' / f'{i:05d}.png'))
    (root / 'meta.txt').write_text('00003.png (32,32,3)\n'
                                   '00001.png (32,32,3)\n')
    return root


@pytest.mark.parametrize('name,over', [
    ('FFHQDataset', {}), ('FFHQDataset', {'use_hflip': False}),
    ('FFHQDataset', {'mean': [0.5] * 3, 'std': [0.5] * 3}),
    ('SingleImageDataset', {}),
    ('SingleImageDataset', {'meta_info_file': True,
                            'mean': [0.4, 0.5, 0.6], 'std': [0.2] * 3})],
    ids=['ffhq', 'ffhq_noflip', 'ffhq_norm', 'single', 'single_meta_norm'])
def test_single_image_datasets_equal_jax(faces, name, over):
    """Every item of both packages' dataset, twice over (the flips drawn
    from one random.Random(manual_seed)): the same bits and paths."""
    from bsvd_tpu.data import build_dataset as jbuild
    from bsvd_tpu_torch.data import build_dataset
    opt = {'type': name, 'name': 'faces', 'manual_seed': 5, 'phase': 'train',
           'dataroot_gt': str(faces / 'img'),
           'dataroot_lq': str(faces / 'img'), **over}
    if over.get('meta_info_file'):
        opt['meta_info_file'] = str(faces / 'meta.txt')
    ours, theirs = build_dataset(dict(opt)), jbuild(dict(opt))
    assert len(ours) == len(theirs) == (2 if 'meta_info_file' in over
                                        else 5)
    key = 'gt' if name == 'FFHQDataset' else 'lq'
    for _ in range(2):
        for i in range(len(ours)):
            a, b = ours[i], theirs[i]
            assert a[f'{key}_path'] == b[f'{key}_path']
            np.testing.assert_array_equal(a[key], np.asarray(b[key]))


def test_train_cli_stylegan2(tmp_path):
    """``train_pipeline`` on a StyleGAN2 yml (FFHQDataset, mean / std 0.5,
    wgan_softplus, both regularisers every 2 iterations) on --device cpu:
    4 iterations, the saved nets and training state, --auto_resume to 5
    with the mean path length carried."""
    from bsvd_tpu_torch.train import train_pipeline
    rng = np.random.default_rng(14)
    for i in range(4):
        imwrite(rng.integers(0, 256, (SIZE, SIZE, 3)).astype(np.uint8),
                str(tmp_path / 'ffhq' / f'{i:05d}.png'))
    yml = tmp_path / 'sg.yml'
    yml.write_text(f"""name: sg_cli
model_type: StyleGAN2Model
num_gpu: auto
manual_seed: 0
datasets:
  train:
    name: FFHQ
    type: FFHQDataset
    dataroot_gt: {tmp_path / 'ffhq'}
    use_hflip: true
    mean: [0.5, 0.5, 0.5]
    std: [0.5, 0.5, 0.5]
    num_worker_per_gpu: 1
    batch_size_per_gpu: 2
    dataset_enlarge_ratio: 10
network_g:
  type: StyleGAN2Generator
  out_size: {SIZE}
  num_style_feat: {NSF}
  num_mlp: 2
  narrow: 0.25
network_d:
  type: StyleGAN2Discriminator
  out_size: {SIZE}
  narrow: 0.25
path:
  pretrain_network_g: ~
train:
  optim_g:
    type: Adam
    lr: !!float 2e-3
  optim_d:
    type: Adam
    lr: !!float 2e-3
  total_iter: 4
  gan_opt:
    type: GANLoss
    gan_type: wgan_softplus
    loss_weight: !!float 1
  r1_reg_weight: 10
  path_reg_weight: 2
  net_g_reg_every: 2
  net_d_reg_every: 2
  mixing_prob: 0.9
logger:
  print_freq: 2
  save_checkpoint_freq: 4
  use_tb_logger: false
""")
    model = train_pipeline(str(tmp_path), cmd=['-opt', str(yml), '--device',
                                               'cpu'])
    assert type(model).__name__ == 'StyleGAN2Model'
    assert model.optimizer.count == model.optimizer_d.count == 4
    assert all(np.isfinite(v) for v in model.get_current_log().values())
    exp = tmp_path / 'experiments' / 'sg_cli'
    assert (exp / 'models' / 'net_g_4.npz').exists()
    assert (exp / 'models' / 'net_d_4.npz').exists()
    mpl = float(model.mean_path_length)
    resumed = train_pipeline(str(tmp_path), cmd=[
        '-opt', str(yml), '--device', 'cpu', '--auto_resume',
        '--force_yml', 'train:total_iter=5'])
    assert resumed.optimizer.count == 5
    st_mpl = float(resumed.mean_path_length)
    assert st_mpl == mpl                 # no path step at iteration 5
