"""Statistics across ranks on the CPU: norm 'bn' / 'in' in the sharded
BSVD train step and the halo-exchange forward with the rows split, SRModel's and
ESRGANModel's perceptual criterion 'fro' on a data mesh, StyleGAN2Model on
a data mesh, and a whole clip over the device budget on the streaming
route.

The rank work runs in gloo CPU ranks spawned by ``python -m
bsvd_tpu_torch.parallel.dryrun --target
tests/_torch_parallel_worker.py:mesh_stats`` (one 2-rank spawn for the
2 x 1 / 1 x 2 cases and the engines, one 4-rank spawn for 2 x 2), each
case held against the port's serial run in this process from the same
inputs, and the normed step and SRModel's 'fro' against the JAX package's
mesh step on 2 of the 8 CPU devices of tests/conftest.py. StyleGAN2Model
is held against the port's serial run, which tests/test_torch_stylegan2.py
holds against JAX.

Tolerances: losses 1e-5 relative; gradients 1e-5 x max|ref| of each
tensor, or of the net's largest gradient where a tensor's is 0 in exact
arithmetic (the conv biases before a norm: rounding noise, ~5e-7 of the
largest); parameters 1e-5 x max|ref| + 2% of lr (Adam's first step of a
gradient near 0); BN running statistics 1e-5 relative; eval outputs
1e-5. The normed WNet steps run SGD: Adam would turn
the rounding noise of the conv biases before a norm (gradient 0 in exact
arithmetic) into steps of +-lr whose signs differ between two summation
orders. They run in float64 (the loss in fp32, as ``train_forward``
returns it): in fp32 these random small nets' norm sites amplify
rounding, so that one serial step's gradients lie up to 1.6% of the
largest gradient from float64 (BN over 2 x 1) and two fp32 runs cannot
be compared at 1e-5.
"""

import copy
import json
import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from bsvd_tpu_torch.archs.wnet_arch import WNetConfig, _map_tree, wnet_init
from bsvd_tpu_torch.models import seq_inference
from bsvd_tpu_torch.models.base_model import build_model
from bsvd_tpu_torch.parallel.mesh import Mesh

from _torch_parallel_worker import _train

jax = pytest.importorskip('jax')
jnp = pytest.importorskip('jax.numpy')

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(chns=(8, 16, 32), mid_ch=8, interm_ch=8, act='relu6')
SGD_LR = 0.05
ADAM_LR = 2e-3
T, H, W = 3, 16, 16
# (norm, data, spatial, remat, H) of each train case, by spawn. At H 16
# every rank's halo-extended block holds the whole frame; at 96 (48 rows
# a rank, a 40-row halo) the blocks' edges compute rows that are wrong
# (zero past the block, not the neighbour's rows), and only the owned rows
# may enter the statistics
LAYOUTS = {2: {'bn_2x1': ('bn', 2, 1, False, H),
               'bn_1x2': ('bn', 1, 2, False, H),
               'in_1x2': ('in', 1, 2, False, H),
               'bn_remat_1x2': ('bn', 1, 2, True, H),
               'bn_tall_1x2': ('bn', 1, 2, False, 96),
               'in_tall_1x2': ('in', 1, 2, False, 96)},
           4: {'bn_2x2': ('bn', 2, 2, False, H)}}


def _wnet(norm, remat, seed):
    """(cfg kwargs, float64 params) with seeded non-trivial BN leaves."""
    kw = dict(KW, norm=norm, remat=remat)
    params = _map_tree(wnet_init(WNetConfig(**kw), seed), torch.Tensor.double)
    g = torch.Generator().manual_seed(seed)

    def fill(tree):
        for v in tree.values():
            if isinstance(v, dict) and 'mean' in v:
                ch = v['mean'].shape[0]
                u = torch.rand(4, ch, generator=g).double()
                v.update(scale=0.5 + u[0], bias=0.4 * u[1] - 0.2,
                         mean=0.6 * u[2] - 0.3, var=0.5 + 1.5 * u[3])
            elif isinstance(v, dict):
                fill(v)
    fill(params)
    return kw, params


def _batches(seed, n, h=H, steps=2):
    rng = np.random.default_rng(seed)
    return [{'lq': torch.from_numpy(rng.uniform(0, 1, (n, T, h, W, 4))),
             'gt': torch.from_numpy(rng.uniform(0, 1, (n, T, h, W, 3)))}
            for _ in range(steps)]


def _vgg_npz(path):
    rng = np.random.default_rng(7)
    np.savez(path, **{'features.0.weight': rng.normal(
        0, 0.27, (64, 3, 3, 3)).astype(np.float32),
        'features.0.bias': rng.uniform(-0.1, 0.1, 64).astype(np.float32)})
    return str(path)


def _sr_opt(model_type, vgg, **train):
    opt = {'name': model_type, 'model_type': model_type, 'is_train': True,
           'num_gpu': 'auto', 'manual_seed': 0, 'scale': 4,
           'network_g': {'type': 'MSRResNet', 'num_in_ch': 3,
                         'num_out_ch': 3, 'num_feat': 8, 'num_block': 1,
                         'upscale': 4},
           'path': {}, 'logger': {},
           'train': {'optim_g': {'type': 'Adam', 'lr': ADAM_LR,
                                 'betas': [0.9, 0.99]},
                     'total_iter': 2,
                     'perceptual_opt': {
                         'type': 'PerceptualLoss', 'criterion': 'fro',
                         'layer_weights': {'conv1_1': 1.0},
                         'style_weight': 0.2, 'pretrain_path': vgg}}}
    opt['train'].update(train)
    return opt


SG_G = {'type': 'StyleGAN2Generator', 'out_size': 16, 'num_style_feat': 16,
        'num_mlp': 2, 'narrow': 0.125}
SG_D = {'type': 'StyleGAN2Discriminator', 'out_size': 16, 'narrow': 0.125}


def _sg_opt():
    return {'name': 'sg', 'model_type': 'StyleGAN2Model', 'is_train': True,
            'num_gpu': 'auto', 'manual_seed': 7, 'network_g': SG_G,
            'network_d': SG_D, 'path': {}, 'logger': {},
            'train': {'optim_g': {'type': 'Adam', 'lr': ADAM_LR},
                      'optim_d': {'type': 'Adam', 'lr': ADAM_LR},
                      'total_iter': 2,
                      'gan_opt': {'type': 'GANLoss',
                                  'gan_type': 'wgan_softplus',
                                  'loss_weight': 1.0},
                      'r1_reg_weight': 10, 'path_reg_weight': 2,
                      'net_g_reg_every': 2, 'net_d_reg_every': 2,
                      'mixing_prob': 0.9, 'ema_decay': 0.9}}


def _model_cases(tmp_path):
    """The engines of the 2-rank spawn: options, starting states, two
    global batches of 4."""
    from bsvd_tpu_torch.archs import build_network
    vgg = _vgg_npz(tmp_path / 'vgg.npz')
    rng = np.random.default_rng(11)

    def sr_batches(size):
        return [{'lq': rng.uniform(0, 1, (4, 3, size // 4, size // 4)
                                   ).astype(np.float32),
                 'gt': rng.uniform(0, 1, (4, 3, size, size)).astype(
                     np.float32)} for _ in range(2)]

    def state(opt, seed):
        return build_network(dict(opt, seed=seed), 'cpu').state_dict()
    g = _sr_opt('SRModel', vgg)['network_g']
    d = {'type': 'VGGStyleDiscriminator128', 'num_feat': 4}
    g_sg = state(SG_G, 5)
    return {
        'sr_fro': {'opt': _sr_opt('SRModel', vgg,
                                  pixel_opt={'type': 'L1Loss'}),
                   'states': {'net': state(g, 5)}, 'batches': sr_batches(32)},
        'esrgan_fro': {'opt': dict(_sr_opt(
            'ESRGANModel', vgg, pixel_opt={'type': 'L1Loss',
                                           'loss_weight': 0.1},
            gan_opt={'type': 'GANLoss', 'gan_type': 'vanilla',
                     'loss_weight': 0.1},
            optim_d={'type': 'Adam', 'lr': 1e-3, 'betas': [0.9, 0.99]}),
            network_d=d), 'states': {'net': state(g, 5),
                                     'net_d': state(d, 6)},
            'batches': sr_batches(128)},
        'stylegan2': {'opt': _sg_opt(),
                      'states': {'net': g_sg, 'net_g_ema': g_sg,
                                 'net_d': state(SG_D, 6)},
                      'batches': [{'gt': rng.uniform(-1, 1, (4, 3, 16, 16))
                                   .astype(np.float32)} for _ in range(2)]},
    }


def _inputs(nproc, tmp_path):
    train = {}
    for i, (name, (norm, d, s, remat, h)) in enumerate(
            sorted(LAYOUTS[nproc].items())):
        kw, params = _wnet(norm, remat, 20 + i)
        train[name] = {'cfg': kw, 'params': params, 'spatial': s,
                       'lr': SGD_LR, 'batches': _batches(40 + i, 2 * d, h)}
    inp = {'train': train}
    if nproc == 2:
        rng = np.random.default_rng(50)
        inp['eval'] = {}
        for norm in ('bn', 'in'):
            kw, params = _wnet(norm, False, 60)
            inp['eval'][f'eval_{norm}_1x2'] = {
                'cfg': kw, 'params': params, 'spatial': 2,
                'seq': torch.from_numpy(rng.uniform(0, 1, (T, 3, H, W))),
                'x': torch.from_numpy(rng.uniform(0, 1, (2, T, H, W, 4)))}
        inp['models'] = _model_cases(tmp_path)
    return inp


def _spawn(nproc, tmp_path):
    inputs = _inputs(nproc, tmp_path)
    torch.save(inputs, tmp_path / 'inputs.pt')
    res = subprocess.run(
        [sys.executable, '-m', 'bsvd_tpu_torch.parallel.dryrun', '--nproc',
         str(nproc), '--data', str(nproc), '--spatial', '1', '--backend',
         'gloo', '--device', 'cpu', '--checks', 'none', '--timeout', '300',
         '--target', os.path.join(ROOT, 'tests',
                                  '_torch_parallel_worker.py:mesh_stats'),
         '--workdir', str(tmp_path)], cwd=ROOT, capture_output=True,
        text=True, timeout=360)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    ranks = json.loads(res.stdout.strip().splitlines()[-1])['ranks']
    assert len(ranks) == nproc
    return inputs, torch.load(tmp_path / 'outputs.pt', weights_only=False), \
        [r['target']['same_on_ranks'] for r in ranks]


@pytest.fixture(scope='module')
def spawn2(tmp_path_factory):
    return _spawn(2, tmp_path_factory.mktemp('mesh2'))


@pytest.fixture(scope='module')
def spawn4(tmp_path_factory):
    return _spawn(4, tmp_path_factory.mktemp('mesh4'))


def _rel(got, ref, tol):
    assert abs(got - ref) <= tol * abs(ref), (got, ref)


def _params_close(got, ref, lr):
    for k in ref:
        if isinstance(ref[k], dict):
            _params_close(got[k], ref[k], lr)
        elif k in ('mean', 'var'):
            np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
        else:
            err = float((got[k] - ref[k]).abs().max())
            assert err <= 1e-5 * float(ref[k].abs().max()) + 2e-2 * lr, \
                (k, err)


def _serial(case):
    return _train(WNetConfig(**case['cfg']), _map_tree(case['params'],
                                                       torch.clone),
                  case["batches"], Mesh(1, 1, "cpu"), sgd_lr=case["lr"])


@pytest.mark.parametrize('nproc,name', [
    (n, name) for n in sorted(LAYOUTS) for name in sorted(LAYOUTS[n])])
def test_normed_train_step_on_a_mesh_equals_serial(nproc, name, spawn2,
                                                   spawn4):
    """Two SGD steps of a normed WNet on each layout (2 x 1, 1 x 2 with and
    without remat and with rows the halo does not cover, 2 x 2): every
    step's loss, the first step's gradients,
    the parameters and BN running statistics against the serial step fed
    the global batch; the same bits on every rank; collectives run."""
    inputs, outputs, same = spawn2 if nproc == 2 else spawn4
    case, got = inputs['train'][name], outputs[name]
    assert all(s[name] for s in same)
    assert got['mesh'] == {'data': LAYOUTS[nproc][name][1],
                           'spatial': LAYOUTS[nproc][name][2]}
    assert got['collectives'] > 0
    params, losses, grads = _serial(case)
    for a, b in zip(got['losses'], losses):
        _rel(a, b, 1e-5)
    floor = max(float(g.abs().max()) for g in grads.values())
    for k, g in grads.items():
        err = float((got['grads'][k] - g).abs().max())
        assert err <= 1e-5 * max(float(g.abs().max()), floor), (k, err)
    _params_close(got['params'], params, case['lr'])


@pytest.mark.parametrize('norm', ['bn', 'in'])
def test_normed_forward_on_rows_equals_unsharded(norm, spawn2):
    """A normed net on a spatial mesh of 2 ranks: the halo-exchange forward
    ``wnet_apply_spatial`` (BN folded; 'in' all-reduced over the rows'
    ranks, its statistics from the owned rows) and the whole-clip
    ``denoise_seq`` (the JAX package's gate: the unsharded function on
    every rank), each against the unsharded call; the same arrays on both
    ranks."""
    from bsvd_tpu_torch.archs.wnet_arch import wnet_apply
    from bsvd_tpu_torch.models.seq_inference import denoise_seq
    inputs, outputs, same = spawn2
    name = f'eval_{norm}_1x2'
    case = inputs['eval'][name]
    cfg = WNetConfig(**case['cfg'])
    assert all(s[name] for s in same)
    with torch.no_grad():
        ref = wnet_apply(case['params'], case['x'], cfg)
    torch.testing.assert_close(outputs[name + '_spatial'], ref, rtol=0,
                               atol=1e-5)
    ref = denoise_seq(case['params'], cfg, case['seq'], noise_sigma=0.1)
    np.testing.assert_allclose(outputs[name], ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize('name', ['bn_2x1', 'bn_1x2'])
def test_bn_mesh_step_matches_jax_mesh_step(name, spawn2):
    """The JAX package's make_train_step on a mesh of 2 of its CPU devices
    (norm 'bn': the GSPMD step, the global batch's statistics folded by
    bn_fold_running_stats; with the rows split, XLA convs), SGD in float64,
    against the port's sharded steps: every loss, the parameters and the
    running statistics."""
    import optax
    from bsvd_tpu.archs.wnet_arch import WNetConfig as JaxConfig
    from bsvd_tpu.losses import MSELoss
    from bsvd_tpu.models.denoising_model import make_train_step as jax_step
    from bsvd_tpu.parallel import mesh as jmesh
    from bsvd_tpu_torch.convert.torch_ckpt import (from_jax_params,
                                                   to_jax_params)
    inputs, outputs, _ = spawn2
    case, got = inputs['train'][name], outputs[name]
    cfg = WNetConfig(**case['cfg'])
    with jax.enable_x64(True):
        p = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                         to_jax_params(case['params'], cfg))
        mesh = jmesh.make_mesh(2, spatial=LAYOUTS[2][name][2])
        repl = jmesh.replicated_sharding(mesh)
        bsh = jmesh.batch_sharding(mesh, 5, batch_axis=0, spatial_axis=2)
        tx = optax.sgd(case['lr'])
        step = jax.jit(jax_step(JaxConfig(**case['cfg']), tx, MSELoss(),
                                params_template=p, mesh=mesh),
                       in_shardings=(repl, repl, repl,
                                     {'lq': bsh, 'gt': bsh}, None, None),
                       out_shardings=(repl, repl, repl, repl))
        st = tx.init(p)
        for i, b in enumerate(case['batches']):
            p, st, _, loss = step(p, st, None, {k: jnp.asarray(v.numpy())
                                                for k, v in b.items()},
                                  i, 0.0)
            _rel(got['losses'][i], float(loss['l_pix']), 1e-5)
        want = from_jax_params(jax.tree.map(np.asarray, p), cfg)
    _params_close(_map_tree(got['params'], torch.Tensor.float), want,
                  case['lr'])


def test_sr_fro_on_a_mesh_matches_jax(spawn2, monkeypatch):
    """SRModel with the perceptual criterion 'fro' on 2 ranks against the
    JAX package's SRModel on 2 CPU devices (its jitted step, the batch
    sharded over 'data' under GSPMD: the Frobenius norm of the global
    batch), from the same weights: both iterations' logged losses, the
    parameters after."""
    from bsvd_tpu.archs import sr_archs as jsr
    from bsvd_tpu.models import build_model as jax_build_model
    from bsvd_tpu.parallel.mesh import replicated_sharding
    from bsvd_tpu_torch.archs import build_network
    from bsvd_tpu_torch.convert.torch_generic import (from_jax_tree,
                                                      to_jax_tree)
    inputs, outputs, _ = spawn2
    case, got = inputs['models']['sr_fro'], outputs['sr_fro']
    monkeypatch.setattr(jsr.MSRResNet, 'init_fn', staticmethod(
        lambda key, **kw: jax.tree.map(jnp.asarray, to_jax_tree(
            build_network(dict(kw, type='MSRResNet', seed=5), 'cpu')))))
    opt = copy.deepcopy(case['opt'])
    opt['num_gpu'] = 2
    jm = jax_build_model(opt)
    for name in ('params', 'opt_state'):
        setattr(jm, name, jax.device_put(getattr(jm, name),
                                         replicated_sharding(jm.mesh)))
    for it, batch in enumerate(case['batches'], 1):
        jm.feed_data(batch)
        jm.optimize_parameters(it)
        mine, ref = got['logs'][it - 1], dict(jm.log_dict)
        assert sorted(mine) == sorted(ref)
        for k in ref:
            _rel(mine[k], float(ref[k]), 1e-5)
    want = from_jax_tree(jax.tree.map(np.asarray, jm.params))
    for k, v in got['states']['net'].items():
        err = float((v - want[k]).abs().max())
        assert err <= 1e-5 * float(want[k].abs().max()) + 2e-2 * ADAM_LR, \
            (k, err)


def test_all_reduce_backward_gives_the_global_losss_gradient(spawn2):
    """``mesh.all_reduce_sum``'s backward (the all-reduce of the incoming
    gradients, factor 1) makes the ranks' mean gradient that of the mean
    of their losses; one collective each way."""
    rec = spawn2[1]['all_reduce_grad']
    assert rec['collectives'] == 2
    assert rec['sum'] == pytest.approx(1.5 ** 2 * (0.5 ** 2 + 1.5 ** 2))
    assert rec['got'] == pytest.approx(rec['want'], rel=1e-6)


def _serial_model(case, steps=None):
    opt = copy.deepcopy(case['opt'])
    opt['num_gpu'] = 1
    model = build_model(opt, device='cpu')
    for attr, state in case['states'].items():
        getattr(model, attr).load_state_dict(state)
    logs = []
    for it, batch in enumerate(case['batches'][:steps], 1):
        model.feed_data(batch)
        model.optimize_parameters(it)
        logs.append(model.get_current_log())
    return model, logs


@pytest.mark.parametrize('name', ['sr_fro', 'esrgan_fro', 'stylegan2'])
def test_engines_on_a_data_mesh_equal_serial(name, spawn2):
    """SRModel and ESRGANModel with the perceptual criterion 'fro' (the
    global batch's norm), and StyleGAN2Model (R1 and the path penalty at
    iteration 2), two iterations of a global batch of 4 on 2 ranks: every
    logged loss against the serial run's, the states after, the mean path
    length, the same bits on both ranks."""
    inputs, outputs, same = spawn2
    case, got = inputs['models'][name], outputs[name]
    assert got['mesh'] == {'data': 2, 'spatial': 1}
    assert same[0][name] and same[1][name]
    model, logs = _serial_model(case)
    for mine, ref in zip(got['logs'], logs):
        assert list(mine) == list(ref)
        for k in ref:
            _rel(mine[k], ref[k], 1e-5)
    if name == 'stylegan2':
        assert logs[1]['l_d_r1'] > 0 and logs[1]['l_g_path'] > 0
        _rel(got['mean_path_length'], float(model.mean_path_length), 1e-5)
    for attr in got['states']:
        want = getattr(model, attr).state_dict()
        for k, v in got['states'][attr].items():
            err = float((v - want[k]).abs().max())
            assert err <= 1e-5 * float(want[k].abs().max()) + \
                2e-2 * ADAM_LR, (name, attr, k, err)


def test_over_budget_whole_clip_runs_the_streaming_route(monkeypatch):
    """A whole-clip MIMO call over the device budget (``_memory_budget``
    lowered here) runs the streaming route with a warning naming it, and
    gives the whole-clip output."""
    kw, params = _wnet('none', False, 70)
    cfg = WNetConfig(**kw)
    seq = np.random.default_rng(71).uniform(0, 1, (6, 3, H, W)).astype(
        np.float32)
    ref = seq_inference.denoise_seq(params, cfg, seq, noise_sigma=0.1)
    routes = []
    real = seq_inference.streaming_apply
    monkeypatch.setattr(seq_inference, 'streaming_apply', lambda *a: (
        routes.append('streaming'), real(*a))[1])
    monkeypatch.setattr(seq_inference, '_memory_budget',
                        lambda device, frac=0.8: 1.0)
    seen = []
    handler = logging.Handler()
    handler.emit = lambda record: seen.append(record.getMessage())
    logger = logging.getLogger('bsvd_tpu_torch')
    logger.addHandler(handler)
    try:
        got = seq_inference.denoise_seq(params, cfg, seq, noise_sigma=0.1)
    finally:
        logger.removeHandler(handler)
    assert routes == ['streaming']
    assert any('streaming route' in m for m in seen)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
