"""The port's process groups and data parallelism
(bsvd_tpu_torch/parallel/mesh.py and its callers) on the CPU, against the
JAX package where it has a counterpart.

``init_distributed``'s resolution and errors (tests/test_multihost.py's
cases, ``init_process_group`` stubbed), the mesh's shape and blocks, the
rank batches of ``train_video_loader`` against the rows of the JAX
loader's global batch (one worker, bit for bit), the rank gating of logs
and checkpoints, and the test entry point's data-parallel validation on 2
gloo ranks (spawned once, by ``python -m bsvd_tpu_torch.parallel.dryrun
--target tests/_torch_parallel_worker.py:validation_cli``) writing the
same CSVs and averages as the serial run.
"""

import copy
import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from bsvd_tpu_torch.data import build_dataloader
from bsvd_tpu_torch.data.video_train_loader import train_video_loader
from bsvd_tpu_torch.parallel import mesh as mesh_mod
from bsvd_tpu_torch.parallel.mesh import (Mesh, batch_sharding, make_mesh,
                                          replicated_sharding, shard_batch)
from bsvd_tpu_torch.utils.img_util import imwrite

jax = pytest.importorskip('jax')
yaml = pytest.importorskip('yaml')

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ENV = ('BSVD_COORDINATOR', 'BSVD_NUM_PROCESSES', 'BSVD_PROCESS_ID',
        'MASTER_ADDR', 'MASTER_PORT', 'RANK', 'WORLD_SIZE', 'LOCAL_RANK',
        'LOCAL_WORLD_SIZE', 'SLURM_PROCID', 'SLURM_NTASKS', 'SLURM_LOCALID')


@pytest.fixture
def fake_init(monkeypatch):
    """``init_process_group`` recorded instead of run; a clean
    environment."""
    for var in _ENV:
        monkeypatch.delenv(var, raising=False)
    seen = []
    monkeypatch.setattr(mesh_mod.dist, 'init_process_group',
                        lambda backend, **kw: seen.append(dict(
                            kw, backend=backend)))
    monkeypatch.setattr(mesh_mod.dist, 'is_initialized', lambda: False)
    return seen


def test_init_distributed_explicit_address_requires_counts(fake_init,
                                                           monkeypatch):
    """An explicit address with unresolved counts fails loudly, as JAX's;
    BSVD_NUM_PROCESSES / BSVD_PROCESS_ID fill them in."""
    with pytest.raises(ValueError, match='num_processes/process_id'):
        mesh_mod.init_distributed('127.0.0.1:12345', backend='gloo')
    monkeypatch.setenv('BSVD_NUM_PROCESSES', '2')
    monkeypatch.setenv('BSVD_PROCESS_ID', '1')
    mesh_mod.init_distributed('127.0.0.1:12345', backend='gloo')
    assert fake_init == [{'init_method': 'tcp://127.0.0.1:12345',
                          'world_size': 2, 'rank': 1, 'backend': 'gloo'}]


def test_init_distributed_resolution_order(fake_init, monkeypatch):
    """No environment: a no-op. Then BSVD_* before torchrun's variables,
    which come before SLURM's; a single SLURM task is no cluster."""
    assert mesh_mod.init_distributed(backend='gloo') == (0, 1)
    monkeypatch.setenv('SLURM_PROCID', '0')
    monkeypatch.setenv('SLURM_NTASKS', '1')
    assert mesh_mod.init_distributed(backend='gloo') == (0, 1)
    assert fake_init == []
    for k, v in (('MASTER_ADDR', 'hostA'), ('MASTER_PORT', '29400'),
                 ('RANK', '3'), ('WORLD_SIZE', '4'), ('LOCAL_RANK', '1')):
        monkeypatch.setenv(k, v)
    mesh_mod.init_distributed(backend='gloo')
    assert fake_init[-1] == {'init_method': 'tcp://hostA:29400',
                             'world_size': 4, 'rank': 3, 'backend': 'gloo'}
    monkeypatch.setenv('BSVD_COORDINATOR', 'hostB:1234')
    monkeypatch.setenv('BSVD_NUM_PROCESSES', '2')
    monkeypatch.setenv('BSVD_PROCESS_ID', '0')
    mesh_mod.init_distributed(backend='gloo')
    assert fake_init[-1] == {'init_method': 'tcp://hostB:1234',
                             'world_size': 2, 'rank': 0, 'backend': 'gloo'}


def test_init_distributed_backend_rules(fake_init, monkeypatch):
    """backend=None is NCCL only with a card per rank: here (no card) it
    raises naming gloo; a failing NCCL init raises and is not retried."""
    with pytest.raises(ValueError, match="backend='gloo'"):
        mesh_mod.init_distributed('127.0.0.1:1', 2, 0)
    assert fake_init == []

    def fails(backend, **kw):
        fake_init.append(backend)
        raise RuntimeError('nccl unavailable')
    monkeypatch.setattr(mesh_mod.dist, 'init_process_group', fails)
    with pytest.raises(RuntimeError, match='nccl'):
        mesh_mod.init_distributed('127.0.0.1:1', 1, 0, backend='nccl')
    assert fake_init == ['nccl']


def test_mesh_of_one_process_and_its_errors():
    m = make_mesh()
    assert m.shape == {'data': 1, 'spatial': 1} and m.size == 1
    assert m.coords == {'data': 0, 'spatial': 0}
    assert make_mesh(8).size == 1        # cut to the ranks, as JAX cuts
    with pytest.raises(ValueError, match='does not divide'):
        make_mesh(1, spatial=2)
    with pytest.warns(UserWarning, match='degrading'):
        assert make_mesh(1, spatial=2, strict=False).shape['spatial'] == 1
    x = torch.arange(24.).reshape(2, 3, 4)
    assert replicated_sharding(m).local(x) is x
    assert torch.equal(shard_batch(m, {'a': [x]})['a'][0], x)


def test_shardings_give_this_ranks_block():
    """Rank 0's view of a 2 x 2 mesh: the first half of the batch and of
    the rows, as JAX's NamedSharding lays them out."""
    m = Mesh(2, 2, 'cpu')
    x = np.arange(4 * 3 * 8 * 2).reshape(4, 3, 8, 2)
    np.testing.assert_array_equal(
        batch_sharding(m, 4, 0, 2).local(x), x[:2, :, :4])
    np.testing.assert_array_equal(
        batch_sharding(m, 4, None, 2).local(x), x[:, :, :4])
    with pytest.raises(ValueError, match='does not divide'):
        batch_sharding(m, 4, 0, None).local(x[:3])


@pytest.fixture(scope='module')
def clip_root(tmp_path_factory):
    root = tmp_path_factory.mktemp('rank_clips')
    rng = np.random.default_rng(21)
    for c in range(3):
        for k in range(9):
            imwrite(rng.integers(0, 256, (40, 52, 3), dtype=np.uint8),
                    str(root / f'clip{c}' / f'{k:03d}.png'))
    return str(root)


@pytest.mark.parametrize('noise_shape', ['N', 'NF'])
def test_rank_batches_are_rows_of_jax_global_batch(clip_root, noise_shape):
    """One worker: rank r's batches are rows [r*b, (r+1)*b) of the JAX
    loader's global batches (num_devices 2) bit for bit, windows and
    noise alike; the epoch counts global batches."""
    from bsvd_tpu.data.video_train_loader import train_video_loader as jax_l
    opt = {'trainset_dir': clip_root, 'batch_size_per_gpu': 2,
           'temp_patch_size': 5, 'patch_size': [24, 24],
           'max_number_patches': 8, 'noise_ival': [5, 55],
           'noise_shape': noise_shape, 'num_workers': 1, 'manual_seed': 4,
           'num_devices': 2}
    loaders = [train_video_loader(dict(opt, rank=r)) for r in (0, 1)]
    ref = jax_l(dict(opt))
    try:
        assert [len(x) for x in loaders] == [len(ref)] * 2 == [2, 2]
        want = list(ref)
        got = [list(x) for x in loaders]
    finally:
        for x in loaders + [ref]:
            x.close()
    for i, b in enumerate(want):
        assert b['gt'].shape[0] == 4
        for r in (0, 1):
            for k in b:
                np.testing.assert_array_equal(got[r][i][k],
                                              b[k][2 * r:2 * r + 2])


class _DrawSpy:
    """A numpy Generator that records the leading size of every normal
    draw."""

    def __init__(self, rng):
        self.rng, self.rows = rng, []

    def normal(self, loc, scale, size):
        self.rows.append(size[0])
        return self.rng.normal(loc, scale, size)

    def __getattr__(self, name):
        return getattr(self.rng, name)


@pytest.mark.parametrize('workers,rows', [(1, 4), (2, 2)])
def test_rank_noise_draws(clip_root, workers, rows):
    """A rank of 2 draws the noise of the whole global batch (4 clips) with
    one worker, for JAX's rows bit for bit, and of its own 2 clips only
    with more workers, so the host's cost does not grow with the ranks."""
    opt = {'trainset_dir': clip_root, 'batch_size_per_gpu': 2,
           'temp_patch_size': 5, 'patch_size': [24, 24],
           'max_number_patches': 8, 'noise_ival': [5, 55],
           'num_workers': workers, 'manual_seed': 4, 'num_devices': 2,
           'rank': 1}
    loader = train_video_loader(opt)
    try:
        loader._batch_rng = spy = _DrawSpy(loader._batch_rng)
        batch = next(iter(loader))
    finally:
        loader.close()
    assert batch['lq'].shape == (2, 5, 3, 24, 24)
    assert spy.rows and set(spy.rows) == {rows}


def test_build_dataloader_checks_the_loaders_rank(clip_root):
    opt = {'trainset_dir': clip_root, 'batch_size_per_gpu': 2,
           'temp_patch_size': 5, 'patch_size': [24, 24],
           'noise_ival': [5, 55], 'num_workers': 1, 'phase': 'train'}
    loader = train_video_loader(dict(opt))
    other = train_video_loader(dict(opt, num_devices=2, rank=1))
    try:
        assert build_dataloader(loader, opt, num_gpu=1, dist=True) is loader
        with pytest.raises(ValueError, match='rank 1 of 2'):
            build_dataloader(other, opt, num_gpu=2, dist=True)
    finally:
        loader.close()
        other.close()


def test_other_ranks_log_errors_only_and_write_nothing(tmp_path,
                                                       monkeypatch):
    """The JAX rank rule (utils/logger.py:14-28, base_model.py:77-90):
    ranks other than 0 log at ERROR with no file, and save no network or
    training state."""
    from bsvd_tpu_torch.models import base_model
    from bsvd_tpu_torch.utils import logger as logger_mod
    monkeypatch.setattr(logger_mod, 'is_main_process', lambda: False)
    log = logger_mod.get_root_logger('bsvd_rank1_test',
                                     log_file=str(tmp_path / 'x.log'))
    assert log.level == logging.ERROR and not (tmp_path / 'x.log').exists()
    assert not any(isinstance(h, logging.FileHandler) for h in log.handlers)
    monkeypatch.setattr(base_model, 'is_main_process', lambda: False)
    model = base_model.BaseModel({'is_train': True, 'path': {
        'models': str(tmp_path), 'training_states': str(tmp_path)}})
    assert model.save_network({}, 'g', 1) is None
    assert model.save_training_state(0, 1) is None
    assert list(tmp_path.iterdir()) == []


NET = {'type': 'BSVD', 'chns': [8, 16, 32], 'mid_ch': 8,
       'shift_input': False, 'norm': 'none', 'interm_ch': 8,
       'act': 'relu6', 'pretrain_ckpt': None}
METRICS = {'psnr': {'type': 'calculate_psnr', 'crop_border': 2,
                    'test_y_channel': False},
           'ssim': {'type': 'calculate_ssim', 'crop_border': 2,
                    'test_y_channel': False}}


def test_data_parallel_validation_writes_the_serial_csvs(tmp_path):
    """The test entry point on 2 ranks (a data mesh, whole clips, 3
    folders: rank 0 takes two, rank 1 one) against the serial run: the
    averages, the per-scene CSVs byte for byte and the images."""
    sys.path.insert(0, os.path.join(ROOT, 'tools'))
    from make_synth_dataset import main as make_ds
    from bsvd_tpu_torch.archs.wnet_arch import WNetConfig, wnet_init
    from bsvd_tpu_torch.convert.torch_ckpt import to_jax_params
    from bsvd_tpu_torch.models.checkpoint import save_npz_params
    from bsvd_tpu_torch.test import test_pipeline
    data = tmp_path / 'data'
    make_ds(str(data), num_clips=3, t=4, h=32, w=32, seed=0)
    cfg = WNetConfig(chns=(8, 16, 32), mid_ch=8, interm_ch=8, norm='none',
                     act='relu6')
    ckpt = str(tmp_path / 'net_g.npz')
    save_npz_params(ckpt, {'params': to_jax_params(wnet_init(cfg, 3), cfg)})
    opt = {'name': 'dp_eval', 'model_type': 'DenoisingModel',
           'num_gpu': 'auto', 'manual_seed': 10,
           'datasets': {'val_1': {'name': 'synth', 'type': 'ValFolderDataset',
                                  'valsetdir': str(data),
                                  'num_validation_frames': 4,
                                  'valnoisestd': 20}},
           'network_g': dict(NET),
           'path': {'pretrain_network_g': ckpt, 'strict_load_g': True},
           'val': {'save_img': True, 'temp_psz': -1, 'future_buffer_len': 0,
                   'metrics': copy.deepcopy(METRICS)},
           'logger': {'print_freq': 100, 'save_checkpoint_freq': 5000,
                      'use_tb_logger': False}}
    with open(tmp_path / 'opt.yml', 'w') as f:
        yaml.safe_dump(opt, f)
    serial = test_pipeline(str(tmp_path / 'serial'), cmd=[
        '-opt', str(tmp_path / 'opt.yml'), '--device', 'cpu'])
    res = subprocess.run(
        [sys.executable, '-m', 'bsvd_tpu_torch.parallel.dryrun', '--nproc',
         '2', '--data', '2', '--spatial', '1', '--backend', 'gloo',
         '--device', 'cpu', '--checks', 'none', '--timeout', '200',
         '--target', os.path.join(ROOT, 'tests',
                                  '_torch_parallel_worker.py:validation_cli'),
         '--workdir', str(tmp_path)], cwd=ROOT, capture_output=True,
        text=True, timeout=240)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    import json
    ranks = json.loads(res.stdout.strip().splitlines()[-1])['ranks']
    assert [r['target']['mesh'] for r in ranks] == [
        {'data': 2, 'spatial': 1}] * 2
    assert ranks[0]['target']['results'] == serial
    assert ranks[1]['target']['results'] == {'synth': None}
    a = tmp_path / 'serial' / 'results' / 'dp_eval'
    b = tmp_path / 'dp' / 'results' / 'dp_eval'
    csvs = sorted(p.name for p in a.glob('*.csv'))
    assert csvs == sorted(p.name for p in b.glob('*.csv')) and \
        len(csvs) == 3
    for name in csvs:
        assert (a / name).read_bytes() == (b / name).read_bytes()
    pngs = sorted(str(p.relative_to(a)) for p in a.rglob('*.png'))
    assert len(pngs) == 12 and pngs == sorted(
        str(p.relative_to(b)) for p in b.rglob('*.png'))
    assert len(list(b.glob('test_*.log'))) == 1


@pytest.mark.parametrize('norm,data,spatial,raises', [
    ('bn', 2, 1, True), ('in', 1, 2, True), ('in', 2, 1, False),
    ('none', 1, 2, False)])
def test_train_step_refuses_split_statistics(norm, data, spatial, raises):
    """Norm 'bn' on a mesh of more than one rank, and 'in' with the rows
    split, raise naming ROADMAP (their statistics would need an
    all-reduce); 'in' over data alone is per sample and runs."""
    from bsvd_tpu_torch.archs.wnet_arch import WNetConfig, _WNetBase
    from bsvd_tpu_torch.losses import build_loss
    from bsvd_tpu_torch.models.denoising_model import make_train_step
    from bsvd_tpu_torch.models.optim import Adam
    net = _WNetBase(WNetConfig(chns=(8, 16, 32), mid_ch=8, interm_ch=8,
                               norm=norm, act='relu6'))
    args = (net, Adam(net.named_parameters(), lambda c: 1e-3),
            build_loss({'type': 'MSELoss'}))
    mesh = Mesh(data, spatial, 'cpu')
    if raises:
        with pytest.raises(NotImplementedError, match='ROADMAP'):
            make_train_step(*args, mesh=mesh)
    else:
        assert callable(make_train_step(*args, mesh=mesh))


@pytest.mark.parametrize('mode', ['mimo', 'streaming'])
def test_denoise_seq_async_matches_jax(mode):
    """The whole clip left on the device, clipped, (T, H, W, out_ch): the
    JAX package's denoise_seq_async, and the port's denoise_seq
    transposed."""
    from bsvd_tpu.archs.wnet_arch import WNetConfig as JaxConfig, wnet_init
    from bsvd_tpu.models.seq_inference import denoise_seq_async as jax_async
    from bsvd_tpu_torch.archs.wnet_arch import WNetConfig
    from bsvd_tpu_torch.convert.torch_ckpt import from_jax_params
    from bsvd_tpu_torch.models.seq_inference import (denoise_seq,
                                                     denoise_seq_async)
    kw = dict(chns=(8, 16, 32), mid_ch=8, interm_ch=8, norm='none',
              act='relu6')
    jcfg, pcfg = JaxConfig(**kw), WNetConfig(**kw)
    jparams = wnet_init(jax.random.PRNGKey(3), jcfg)
    params = from_jax_params(jax.tree.map(np.asarray, jparams), pcfg)
    seq = np.random.default_rng(3).uniform(0, 1, (4, 3, 16, 16)).astype(
        np.float32)
    got = denoise_seq_async(params, pcfg, seq, 0.1, mode)
    assert torch.is_tensor(got) and got.shape == (4, 16, 16, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_async(
        jparams, jcfg, seq, 0.1, mode)), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got.permute(0, 3, 1, 2).numpy(),
                                  denoise_seq(params, pcfg, seq, 0.1,
                                              mode=mode))


def _sr_cases(tmp_path):
    """SRModel (L1 + perceptual), ESRGANModel (its G gated at step 1) and
    DenoisingModel with the perceptual loss over data and over rows, tiny,
    each with 2 steps of a global batch of 4 (2 a rank)."""
    from bsvd_tpu_torch.archs import build_network
    rng = np.random.default_rng(7)
    vgg = tmp_path / 'vgg.npz'
    np.savez(vgg, **{'features.0.weight': rng.normal(
        0, 0.27, (64, 3, 3, 3)).astype(np.float32),
        'features.0.bias': rng.uniform(-0.1, 0.1, 64).astype(np.float32)})
    percep = {'type': 'PerceptualLoss', 'layer_weights': {'conv1_1': 1.0},
              'style_weight': 0.2, 'pretrain_path': str(vgg)}
    g = {'type': 'MSRResNet', 'num_feat': 8, 'num_block': 1, 'upscale': 4}

    def opt(model_type, train, **extra):
        base = {'name': model_type, 'model_type': model_type,
                'is_train': True, 'num_gpu': 'auto', 'scale': 4,
                'network_g': dict(g), 'path': {}, 'logger': {},
                'train': dict({'optim_g': {'type': 'Adam', 'lr': 2e-3,
                                           'betas': [0.9, 0.99]},
                               'total_iter': 2}, **train)}
        base.update(extra)
        return base

    def sr_batches(size):
        return [{'lq': rng.uniform(0, 1, (4, 3, size // 4, size // 4)
                                   ).astype(np.float32),
                 'gt': rng.uniform(0, 1, (4, 3, size, size)).astype(
                     np.float32)} for _ in range(2)]

    def state(net_opt):
        return build_network(dict(net_opt, seed=5), 'cpu').state_dict()
    d = {'type': 'VGGStyleDiscriminator128', 'num_feat': 4}
    tsn = {'type': 'TSN', 'num_segments': 3, 'base_model': 'WNet_multistage',
           'shift_type': 'TSM', 'shift_div': 8, 'seed': 2,
           'net2d_opt': {'chns': [8, 16, 32], 'mid_ch': 8, 'norm': 'none',
                         'interm_ch': 8, 'act': 'relu6'}}
    vid = []
    for _ in range(2):
        gt = rng.uniform(0, 1, (4, 3, 3, 16, 16)).astype(np.float32)
        vid.append({'gt': gt, 'noise_map': np.full((4, 3, 1, 16, 16), 0.1,
                                                   np.float32),
                    'lq': (gt + rng.normal(0, 0.1, gt.shape)).astype(
                        np.float32)})
    den_train = {'pixel_opt': {'type': 'MSELoss'}, 'perceptual_opt': percep}
    return {
        'sr': {'opt': opt('SRModel', {'pixel_opt': {'type': 'L1Loss'},
                                      'perceptual_opt': percep}),
               'states': {'net': state(g)}, 'batches': sr_batches(32)},
        'esrgan': {'opt': opt('ESRGANModel', {
            'pixel_opt': {'type': 'L1Loss', 'loss_weight': 0.1},
            'gan_opt': {'type': 'GANLoss', 'gan_type': 'vanilla',
                        'loss_weight': 0.1}, 'net_d_init_iters': 1},
            network_d=d), 'states': {'net': state(g), 'net_d': state(d)},
            'batches': sr_batches(128)},
        'denoise_data': {'opt': opt('DenoisingModel', den_train,
                                    network_g=tsn),
                         'states': {}, 'batches': vid},
        'denoise_rows': {'opt': opt('DenoisingModel', den_train,
                                    network_g=tsn, parallel={'spatial': 2}),
                         'states': {}, 'batches': vid},
    }


def test_sr_engines_data_parallel_equal_serial(tmp_path):
    """Two gloo ranks (one spawn of ``parallel.dryrun --target
    tests/_torch_parallel_worker.py:sr_train``): SRModel and ESRGANModel
    stepping on their halves of the global batch, DenoisingModel with the
    perceptual loss over data and over rows (the rows gathered before the
    VGG). Each step's losses equal the serial run's (1e-5 x |ref|, the
    order of the mean), the parameters after 2 steps within 1e-5 x
    max|ref| plus 2% of lr (Adam's step of a gradient near 0), and both
    ranks hold the same parameters."""
    import json
    from bsvd_tpu_torch.models.base_model import build_model
    cases = _sr_cases(tmp_path)
    torch.save(cases, tmp_path / 'inputs.pt')
    res = subprocess.run(
        [sys.executable, '-m', 'bsvd_tpu_torch.parallel.dryrun', '--nproc',
         '2', '--data', '2', '--spatial', '1', '--backend', 'gloo',
         '--device', 'cpu', '--checks', 'none', '--timeout', '200',
         '--target', os.path.join(ROOT, 'tests',
                                  '_torch_parallel_worker.py:sr_train'),
         '--workdir', str(tmp_path)], cwd=ROOT, capture_output=True,
        text=True, timeout=240)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    ranks = json.loads(res.stdout.strip().splitlines()[-1])['ranks']
    assert ranks[0]['target']['sums'] == ranks[1]['target']['sums']
    got = torch.load(tmp_path / 'outputs.pt', weights_only=False)
    assert got['denoise_rows']['mesh'] == {'data': 1, 'spatial': 2}
    assert got['sr']['mesh'] == {'data': 2, 'spatial': 1}
    for name, case in cases.items():
        opt = copy.deepcopy(case['opt'])
        opt['num_gpu'] = 1
        opt.pop('parallel', None)
        model = build_model(opt, device='cpu')
        for attr, state in case['states'].items():
            getattr(model, attr).load_state_dict(state)
        for it, batch in enumerate(case['batches'], 1):
            model.feed_data(batch)
            model.optimize_parameters(it)
            ref = model.get_current_log()
            mine = got[name]['logs'][it - 1]
            assert list(mine) == list(ref), name
            for k in ref:
                assert abs(mine[k] - ref[k]) <= 1e-5 * abs(ref[k]), \
                    (name, it, k, mine[k], ref[k])
        for attr in got[name]['states']:
            want = getattr(model, attr).state_dict()
            for k, v in got[name]['states'][attr].items():
                err = float((v - want[k]).abs().max())
                assert err <= 1e-5 * float(want[k].abs().max()) + \
                    2e-2 * 2e-3, (name, attr, k, err)
