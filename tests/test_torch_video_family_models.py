"""The video family's engines of the port against the JAX package's on the
CPU, from the same weights (the JAX package's EDVR / BasicVSR /
VGG-style discriminator inits replaced, for each test only
(monkeypatch), by the port's seeded trees; every DCN pack's
``conv_offset`` random in both):

- ``EDVRModel`` (EDVR num_feat 8, deformable groups 2, 3 frames,
  Charbonnier with ``reduction: sum``, cosine restarts, EMA 0.9) steps 1,
  2 and 3 across ``tsa_iter`` 2 (step 1 trains ``fusion`` only), with
  ``dcn_lr_mul`` 1 and 0.5, both engines in float64, each step from the
  JAX transform's weights: the loss and gradients against JAX's
  ``value_and_grad`` of its EDVR and loss, the gated ones zero at step 1;
  the port's gradients, gated by JAX's rule, fed to the JAX model's own
  optax ``multi_transform`` (its ``pcd_align`` label, the 0.5
  multiplier, both counts), its parameters and the EMA after each step
  against the port's; both Adams' counts; a save and resume that
  continues with the same bits;
- ``VideoBaseModel``'s sliding-window validation (PSNR and SSIM per
  folder, then over two folders of different lengths) against the JAX
  model's with the port's weights, and the frames it saves;
- ``train_pipeline`` on BasicSR's EDVR-M REDS yml (``EDVR_M_YML``) on the
  CPU, cut by --force_yml;
- the GAN engines are in tests/test_torch_video_family_gan.py.

In fp32 the two packages' EDVR gradients part by up to ~2e-3 of a
tensor's max|g| (Charbonnier at eps 1e-12 is |out - gt|, whose sign at
an output within rounding of its GT is noise; and a deformable sample's
gradient in its coordinate jumps where the coordinate crosses a pixel),
while in float64 they agree to 5e-15: hence float64.

Tolerances: loss 1e-12 x |ref|; gradients 1e-9 x each tensor's max|ref|
+ 1e-12 x the net's; parameters and EMA after a step 1e-6 x max|ref| +
1e-5 x lr (the port's Adam takes its bias corrections in fp32, optax
under x64 in float64: ~1e-6 of a step); validation 1e-3 dB PSNR, 1e-5
SSIM (an output within rounding of a uint8 step may round the other
way).
"""

import os

import numpy as np
import pytest
import torch

from bsvd_tpu_torch.archs import build_network
from bsvd_tpu_torch.convert.torch_generic import (from_jax_tree,
                                                  state_dict_to_tree,
                                                  to_jax_tree)
from bsvd_tpu_torch.models.base_model import build_model
from bsvd_tpu_torch.ops.deform_conv import DCNv2Pack
from bsvd_tpu_torch.utils.img_util import imwrite
from torch_threads import one_torch_thread  # noqa: F401

jax = pytest.importorskip('jax')
jnp = pytest.importorskip('jax.numpy')
optax = pytest.importorskip('optax')

LR = 1e-3
LOSS_REL = 1e-12
GRAD_REL = 1e-9
STEP_REL = 1e-6
EDVR_NET = {'type': 'EDVR', 'num_feat': 8, 'num_frame': 3,
            'deformable_groups': 2, 'num_extract_block': 1,
            'num_reconstruct_block': 1}
VSR_NET = {'type': 'BasicVSR', 'num_feat': 8, 'num_block': 1}
D_NET = {'type': 'VGGStyleDiscriminator128', 'num_feat': 4}
OFFSET_SEED = 5


def _random_offsets(module, seed=OFFSET_SEED, scale=2.0):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, DCNv2Pack):
                w = m.conv_offset.weight
                w.copy_(torch.randn(w.shape, generator=gen) * scale
                        / w[0].numel() ** 0.5)
                m.conv_offset.bias.copy_(torch.randn(
                    m.conv_offset.bias.shape, generator=gen))


def _tree(opt):
    net = build_network(opt, 'cpu')
    _random_offsets(net)
    return jax.tree.map(jnp.asarray, to_jax_tree(net))


@pytest.fixture
def port_inits(monkeypatch):
    """The JAX package's EDVR, BasicVSR and VGG-style discriminator inits
    replaced by the port's seeded trees (random DCN offsets)."""
    from bsvd_tpu.archs import basicvsr_arch as jb
    from bsvd_tpu.archs import discriminator_arch as jd
    from bsvd_tpu.archs import edvr_arch as je

    def edvr(key, num_in_ch=3, num_out_ch=3, num_feat=64, num_frame=5,
             deformable_groups=8, num_extract_block=5,
             num_reconstruct_block=10, with_tsa=True, with_predeblur=False,
             hr_in=False):
        return _tree({'type': 'EDVR', 'num_in_ch': num_in_ch,
                      'num_out_ch': num_out_ch, 'num_feat': num_feat,
                      'num_frame': num_frame,
                      'deformable_groups': deformable_groups,
                      'num_extract_block': num_extract_block,
                      'num_reconstruct_block': num_reconstruct_block,
                      'with_tsa': with_tsa,
                      'with_predeblur': with_predeblur, 'hr_in': hr_in})
    monkeypatch.setattr(je, 'edvr_init', edvr)
    monkeypatch.setattr(jb, 'basicvsr_init', lambda key, num_feat=64,
                        num_block=15: _tree({'type': 'BasicVSR',
                                             'num_feat': num_feat,
                                             'num_block': num_block}))
    monkeypatch.setattr(jd, 'vgg_discriminator_init', lambda key, cin, nf,
                        size: _tree({'type': f'VGGStyleDiscriminator{size}',
                                     'num_in_ch': cin, 'num_feat': nf}))


def _port(opt):
    pm = build_model(opt, device='cpu')
    for net in (pm.net, pm.net_g_ema):
        if net is not None:
            _random_offsets(net)
    return pm


def _x(shape, seed):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(
        np.float32)


def _state(tree):
    return from_jax_tree(jax.tree.map(np.array, tree))


def _state64(tree):
    """A JAX tree as a port state dict of float64 numpy arrays."""
    from bsvd_tpu_torch.convert.torch_generic import tree_to_state_dict
    return {k: np.asarray(v, np.float64) for k, v in tree_to_state_dict(
        jax.tree.map(lambda a: np.array(a, np.float64), tree)).items()}


def _paths(tmp_path):
    for d in ('m', 's', 'v'):
        os.makedirs(tmp_path / d, exist_ok=True)
    return {'models': str(tmp_path / 'm'),
            'training_states': str(tmp_path / 's'),
            'visualization': str(tmp_path / 'v')}


def _edvr_opt(tmp_path, **train_over):
    train = {'optim_g': {'type': 'Adam', 'lr': LR, 'betas': [0.9, 0.99]},
             'scheduler': {'type': 'CosineAnnealingRestartLR',
                           'periods': [2, 8], 'restart_weights': [1, 0.5],
                           'eta_min': 1e-7},
             'total_iter': 4, 'tsa_iter': 2, 'dcn_lr_mul': 1,
             'ema_decay': 0.9,
             'pixel_opt': {'type': 'CharbonnierLoss', 'loss_weight': 1.0,
                           'reduction': 'sum'}}
    train.update(train_over)
    return {'name': 'edvr', 'model_type': 'EDVRModel', 'is_train': True,
            'num_gpu': 1, 'manual_seed': 0, 'scale': 4,
            'network_g': dict(EDVR_NET), 'path': _paths(tmp_path),
            'train': train,
            'val': {'metrics': {'psnr': {'type': 'calculate_psnr',
                                         'crop_border': 0},
                                'ssim': {'type': 'calculate_ssim',
                                         'crop_border': 0}}},
            'logger': {}}


def _edvr_batch():
    return {'lq': _x((2, 3, 3, 16, 16), 4), 'gt': _x((2, 3, 64, 64), 5)}


@pytest.fixture(scope='module')
def jax_loss_grad():
    """JAX's EDVR and Charbonnier (sum) loss and gradient, jitted once for
    the module (called on float64 trees)."""
    import functools
    from bsvd_tpu.archs.edvr_arch import edvr_apply
    from bsvd_tpu.losses import build_loss
    cri = build_loss({'type': 'CharbonnierLoss', 'loss_weight': 1.0,
                      'reduction': 'sum'})
    fwd = functools.partial(edvr_apply, deformable_groups=2)

    def loss(p, lq, gt):
        out = jnp.transpose(fwd(p, jnp.transpose(lq, (0, 1, 3, 4, 2))),
                            (0, 3, 1, 2))
        return cri(out, gt)
    return jax.jit(jax.value_and_grad(loss))


def _grads(pm):
    return jax.tree.map(jnp.asarray, state_dict_to_tree(
        {n: torch.zeros_like(p) if p.grad is None else p.grad
         for n, p in pm.net.named_parameters()}, np.float64))


def _double(pm):
    """The port model's nets and both Adams' moments in float64."""
    for net in (pm.net, pm.net_g_ema):
        net.double()
    for optim in (pm.optimizer, pm.optimizer_dcn):
        optim.mu = [m.double() for m in optim.mu]
        optim.nu = [v.double() for v in optim.nu]


def _f64(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)


@pytest.mark.parametrize('dcn_lr_mul', [1, 0.5])
def test_edvr_model_steps_across_tsa_iter_match_jax(tmp_path, port_inits,
                                                    jax_loss_grad,
                                                    dcn_lr_mul):
    from bsvd_tpu.models import build_model as jbuild_model
    opt = _edvr_opt(tmp_path, dcn_lr_mul=dcn_lr_mul)
    jm = jbuild_model(opt)
    pm = _port(opt)
    start = {k: v.clone() for k, v in pm.net.state_dict().items()}
    for k, v in _state(jm.params).items():
        assert torch.equal(start[k], v), k
    _double(pm)
    batch = _edvr_batch()
    with jax.enable_x64(True):
        update = jax.jit(jm.tx.update)
        params = _f64(to_jax_tree(pm.net))
        ema = _f64(to_jax_tree(pm.net_g_ema))
        tx_state = jm.tx.init(params)
        for it in (1, 2, 3):
            # each step from the JAX transform's weights: optax takes its
            # bias corrections in float64 here, the port's Adam in fp32
            pm.net.load_state_dict({k: torch.from_numpy(v) for k, v in
                                    _state64(params).items()})
            ref_loss, ref_grads = jax_loss_grad(params, *_f64(
                (batch['lq'], batch['gt'])))
            ref_grads = _state64(ref_grads)
            pm.feed_data(batch)
            pm.lq, pm.gt = pm.lq.double(), pm.gt.double()
            pm.optimize_parameters(it)
            loss = float(pm.log_dict['l_pix'])
            assert abs(loss - float(ref_loss)) <= LOSS_REL * float(ref_loss)
            grads = _grads(pm)
            g_max = max(np.abs(v).max() for v in ref_grads.values())
            for k, v in _state64(grads).items():
                if it < 2 and not k.startswith('fusion.'):
                    assert not v.any(), k       # warm phase: no gradient
                    continue
                bound = GRAD_REL * np.abs(ref_grads[k]).max() + 1e-12 * g_max
                assert np.abs(v - ref_grads[k]).max() <= bound, (it, k)
            if it < 2:                          # JAX's gate
                grads = {k: v if k == 'fusion' else jax.tree.map(
                    lambda g: g * 0.0, v) for k, v in grads.items()}
            updates, tx_state = update(grads, tx_state, params)
            params = optax.apply_updates(params, updates)
            ema = jax.tree.map(lambda e, p: e * 0.9 + p * (1 - 0.9), ema,
                               params)
            for net, tree in ((pm.net, params), (pm.net_g_ema, ema)):
                got = net.state_dict()
                for k, v in _state64(tree).items():
                    err = np.abs(got[k].numpy() - v).max()
                    assert err <= STEP_REL * np.abs(v).max() + 1e-5 * LR, (
                        it, k, err)
            got = pm.net.state_dict()
            assert all(torch.equal(got[k], start[k].double())
                       != (it >= 2 or k.startswith('fusion.'))
                       for k in got), it
    assert pm.optimizer.count == pm.optimizer_dcn.count == 3
    assert {n.split('.')[0] for n in pm.optimizer_dcn.names} == {'pcd_align'}
    assert pm.get_current_learning_rate() == [float(jm.lr_schedule(3))]


def test_edvr_model_save_and_resume_continue_identically(tmp_path):
    from bsvd_tpu_torch.models.checkpoint import load_training_state
    opt = _edvr_opt(tmp_path, tsa_iter=3, dcn_lr_mul=0.25)
    pm = _port(opt)
    batch = _edvr_batch()
    for it in (1, 2):
        pm.feed_data(batch)
        pm.optimize_parameters(it)
    pm.save(0, 2)
    again_opt = dict(opt, path=dict(opt['path'], pretrain_network_g=str(
        tmp_path / 'm' / 'net_g_2.npz')))
    again = build_model(again_opt, device='cpu')
    again.resume_training(load_training_state(str(tmp_path / 's' /
                                                  '2.state')))
    assert again.optimizer_dcn.count == again.optimizer.count == 2
    for it in (3, 4):                   # 3 ends the warm phase
        for m in (pm, again):
            m.feed_data(batch)
            m.optimize_parameters(it)
    for a, b in ((pm.net, again.net), (pm.net_g_ema, again.net_g_ema)):
        sa, sb = a.state_dict(), b.state_dict()
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
    pm.feed_data({'lq': batch['lq'][0]})
    pm.test()
    assert pm.output.shape == (1, 3, 64, 64) and pm.gt is None


@pytest.fixture(scope='module')
def clips(tmp_path_factory):
    """gt/<clip>/NNNNNNNN.png (32 x 48) and lq (8 x 12, 4x4 means): clips
    of 3 and 5 frames."""
    root = tmp_path_factory.mktemp('edvr_val')
    rng = np.random.default_rng(3)
    for c, frames in enumerate((3, 5)):
        for i in range(frames):
            gt = rng.integers(0, 256, (32, 48, 3)).astype(np.uint8)
            lq = gt.reshape(8, 4, 12, 4, 3).mean((1, 3)).round()
            imwrite(gt, str(root / 'gt' / f'{c:03d}' / f'{i:08d}.png'))
            imwrite(lq.astype(np.uint8),
                    str(root / 'lq' / f'{c:03d}' / f'{i:08d}.png'))
    return {'gt': str(root / 'gt'), 'lq': str(root / 'lq')}


def test_video_base_model_validation_matches_jax(tmp_path, port_inits,
                                                 clips):
    from bsvd_tpu.data import build_dataset as jbuild_dataset
    from bsvd_tpu.models import build_model as jbuild_model
    from bsvd_tpu_torch.data import SimpleLoader, build_dataset
    opt = _edvr_opt(tmp_path)
    opt.update(model_type='VideoBaseModel', is_train=False)
    jm = jbuild_model(opt)
    jm.net.apply = jax.jit(jm.net.apply)   # it runs eagerly there
    pm = _port(opt)
    vopt = {'name': 'REDS4', 'type': 'VideoTestDataset', 'num_frame': 3,
            'dataroot_gt': clips['gt'], 'dataroot_lq': clips['lq']}
    got = pm.validation(SimpleLoader(build_dataset(vopt)), 3, None,
                        save_img=True)
    ref = jm.nondist_validation(SimpleLoader(jbuild_dataset(vopt)), 3, None,
                                False)
    assert set(got) == {'psnr', 'ssim'}
    assert abs(got['psnr'] - ref['psnr']) <= 1e-3, (got, ref)
    assert abs(got['ssim'] - ref['ssim']) <= 1e-5, (got, ref)
    saved = sorted(os.listdir(tmp_path / 'v' / 'REDS4' / '001'))
    assert saved == [f'{i}_edvr.png' for i in range(5)]
    # no metrics: nothing computed, {} (as the JAX model)
    opt['val'] = {}
    assert pm.validation(SimpleLoader(build_dataset(vopt)), 3, None) == {}


# BasicSR's options/train/EDVR/train_EDVR_M_x4_SR_REDS_M.yml (num_gpu auto:
# one process here, BasicSR's 8); the run's --force_yml changes the rest
EDVR_M_YML = """name: 100_EDVR_M_x4_SR_REDS_600k_B4G8_valREDS4
model_type: EDVRModel
scale: 4
num_gpu: auto
manual_seed: 10
datasets:
  train:
    name: REDS
    type: REDSDataset
    dataroot_gt: datasets/REDS/train_sharp_with_val.lmdb
    dataroot_lq: datasets/REDS/train_sharp_bicubic_with_val.lmdb
    dataroot_flow: ~
    meta_info_file: basicsr/data/meta_info/meta_info_REDS_GT.txt
    val_partition: REDS4
    io_backend:
      type: lmdb
    num_frame: 5
    gt_size: 256
    interval_list: [1]
    random_reverse: false
    use_hflip: true
    use_rot: true
    num_worker_per_gpu: 3
    batch_size_per_gpu: 4
    dataset_enlarge_ratio: 200
    prefetch_mode: ~
  val:
    name: REDS4
    type: VideoTestDataset
    dataroot_gt: datasets/REDS/train_sharp
    dataroot_lq: datasets/REDS/train_sharp_bicubic
    meta_info_file: basicsr/data/meta_info/meta_info_REDS4_test_GT.txt
    io_backend:
      type: disk
    cache_data: false
    num_frame: 5
    padding: reflection_circle
network_g:
  type: EDVR
  num_in_ch: 3
  num_out_ch: 3
  num_feat: 64
  num_frame: 5
  deformable_groups: 8
  num_extract_block: 5
  num_reconstruct_block: 10
  center_frame_idx: ~
  hr_in: false
  with_predeblur: false
  with_tsa: true
path:
  pretrain_network_g: experiments/pretrained_models/EDVR/EDVR_M_woTSA_x4_SR_REDS_official-1edf645c.pth
  strict_load_g: false
  resume_state: ~
train:
  optim_g:
    type: Adam
    lr: !!float 4e-4
    weight_decay: 0
    betas: [0.9, 0.99]
  scheduler:
    type: CosineAnnealingRestartLR
    periods: [50000, 100000, 150000, 150000, 150000]
    restart_weights: [1, 0.5, 0.5, 0.5, 0.5]
    eta_min: !!float 1e-7
  total_iter: 600000
  warmup_iter: -1
  tsa_iter: 50000
  dcn_lr_mul: 1
  pixel_opt:
    type: CharbonnierLoss
    loss_weight: 1.0
    reduction: sum
val:
  val_freq: !!float 5e3
  save_img: false
  metrics:
    psnr:
      type: calculate_psnr
      crop_border: 0
      test_y_channel: false
logger:
  print_freq: 100
  save_checkpoint_freq: !!float 5e3
  use_tb_logger: true
  wandb:
    project: ~
    resume_id: ~
dist_params:
  backend: nccl
  port: 29500
"""


@pytest.fixture(scope='module')
def reds(tmp_path_factory):
    """train/{gt,lq}/<clip>/NNNNNNNN.png (64 x 80 / 16 x 20): 2 clips of 6
    frames; val: 1 clip of 5."""
    root = tmp_path_factory.mktemp('reds')
    rng = np.random.default_rng(11)
    for part, clips, frames in (('train', 2, 6), ('val', 1, 5)):
        for c in range(clips):
            for i in range(frames):
                gt = rng.integers(0, 256, (64, 80, 3)).astype(np.uint8)
                lq = gt.reshape(16, 4, 20, 4, 3).mean((1, 3)).round()
                imwrite(gt, str(root / part / 'gt' / f'{c:03d}' /
                                f'{i:08d}.png'))
                imwrite(lq.astype(np.uint8), str(
                    root / part / 'lq' / f'{c:03d}' / f'{i:08d}.png'))
    return root


def test_train_cli_from_the_edvr_m_yml(tmp_path, reds):
    """``python -m bsvd_tpu_torch.train`` (train_pipeline) on BasicSR's
    EDVR-M REDS yml with --device cpu: --force_yml the folders (lmdb to
    disk), no pretrained file, 3 iterations across tsa_iter 2, the widths
    and the crop cut; the model, both Adams' counts, the checkpoint, the
    loss, the validation PSNR and its TensorBoard tag."""
    from bsvd_tpu_torch.train import train_pipeline
    from bsvd_tpu_torch.utils import tb_events
    yml = tmp_path / 'train_EDVR_M_x4_SR_REDS_M.yml'
    yml.write_text(EDVR_M_YML)
    force = [*(f'datasets:{ph}:dataroot_{k}={reds}/{ph}/{k}'
               for ph in ('train', 'val') for k in ('gt', 'lq')),
             'datasets:train:io_backend:type=disk',
             'path:pretrain_network_g=~', 'train:total_iter=3',
             'train:tsa_iter=2', 'network_g:num_feat=8',
             'network_g:deformable_groups=2',
             'network_g:num_extract_block=1',
             'network_g:num_reconstruct_block=1',
             'datasets:train:gt_size=32',
             'datasets:train:batch_size_per_gpu=2',
             'datasets:train:num_worker_per_gpu=1', 'val:val_freq=3',
             'logger:print_freq=1', 'logger:save_checkpoint_freq=3']
    model = train_pipeline(str(tmp_path), cmd=[
        '-opt', str(yml), '--device', 'cpu', '--force_yml', *force])
    assert type(model).__name__ == 'EDVRModel'
    assert model.optimizer.count == model.optimizer_dcn.count == 3
    assert model.tsa_iter == 2 and model.net.center_frame_idx == 2
    exp = tmp_path / 'experiments' / '100_EDVR_M_x4_SR_REDS_600k_B4G8_valREDS4'
    assert sorted(os.listdir(exp / 'models')) == ['net_g_3.npz',
                                                  'net_g_latest.npz']
    assert np.isfinite(model.get_current_log()['l_pix'])
    tags = {tag: v for _, _, tag, v in tb_events.read_dir(
        str(exp / 'tb_logger'))}
    assert np.isfinite(tags['metrics/psnr'])
