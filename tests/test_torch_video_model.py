"""VideoRecurrentModel of the port against the JAX package's on the CPU,
on the option dict of tests/test_video_model.py (BasicVSR num_feat 8,
num_block 1, fix_flow 2, flow_lr_mul 0.125, Charbonnier with eps 1e-12)
plus an EMA (ema_decay 0.9), from the same weights (the port's seeded
init carried to the JAX package's BasicVSR as a tree):

- steps 1, 2 and 3 (step 1 with SpyNet frozen, step 2 the unfreeze, step
  3 after it): each step's loss and gradients against JAX's
  ``value_and_grad`` of the JAX model's network and loss in float64 at
  the port's parameters (loss 1e-5 x |ref|, gradients 1e-3 x max|ref|
  per tensor, see GRAD_REL; the JAX fp32 gradient on XLA:CPU is itself
  up to 1.7e-3 off), SpyNet taking none while frozen; the port's
  gradients, with the JAX freeze rule, fed to the JAX model's own optax
  ``multi_transform`` (both Adams, the flow's bias correction at the
  unfreeze, the 0.125 multiplier), its parameters and the EMA after each
  step against the port's within 1e-6 x max|ref| per tensor; SpyNet's
  parameters the same bits as at the start after step 1 and moved after
  step 2. (The two packages' independent steps part further: Adam's first
  step divides by |g| + eps, so SpyNet's near-zero gradients at random
  weights carry their last bits into whole learning-rate steps.);
- the whole-clip validation PSNR on a clip tree, both models holding the
  port's weights (1e-3 dB: an output within rounding of a uint8 step
  may round the other way);
- a save and resume: a model rebuilt from the checkpoint and the
  training state continues for two steps with the same bits;
- ``train_pipeline`` from ``options/train/basicvsr_reds.yml`` on
  ``--device cpu`` with ``--force_yml`` (the folders,
  ``network_g:spynet_path=~``, tiny widths, 3 iterations), then
  ``--auto_resume`` to 4.
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
from bsvd_tpu_torch.utils.img_util import imwrite
from torch_threads import one_torch_thread  # noqa: F401

jax = pytest.importorskip('jax')
jnp = pytest.importorskip('jax.numpy')
optax = pytest.importorskip('optax')

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-4
# Charbonnier at eps 1e-12 is |out - gt|: an output element within fp32
# rounding of its GT can take the other sign of gradient in fp32 than in
# float64, which moves a weight's gradient by one pixel's share (6.7e-4 x
# max|g| of upconv2 at step 2 here; 2.6e-7 elsewhere)
GRAD_REL = 1e-3


@pytest.fixture(scope='module')
def clips(tmp_path_factory):
    """gt/<clip>/NNNNNNNN.png (40 x 48) and lq (10 x 12, 4x4 means): 2
    clips of 5 frames, smooth fields with noise."""
    root = tmp_path_factory.mktemp('vsr')
    rng = np.random.default_rng(3)
    for c in range(2):
        base = rng.uniform(0, 255, (5, 4, 3, 3))
        for i in range(5):
            img = np.kron(base[i], np.ones((10, 16, 1)))
            gt = np.clip(img + rng.normal(0, 6, img.shape), 0, 255)
            gt = gt.round().astype(np.uint8)
            lq = gt.reshape(10, 4, 12, 4, 3).mean((1, 3)).round()
            imwrite(gt, str(root / 'gt' / f'{c:03d}' / f'{i:08d}.png'))
            imwrite(lq.astype(np.uint8),
                    str(root / 'lq' / f'{c:03d}' / f'{i:08d}.png'))
    return {'gt': str(root / 'gt'), 'lq': str(root / 'lq')}


def _opt(tmp_path, **train_over):
    train = {'optim_g': {'type': 'Adam', 'lr': LR, 'betas': [0.9, 0.99]},
             'total_iter': 4, 'fix_flow': 2, 'flow_lr_mul': 0.125,
             'ema_decay': 0.9,
             'pixel_opt': {'type': 'CharbonnierLoss', 'loss_weight': 1.0,
                           'reduction': 'mean', 'eps': 1e-12}}
    train.update(train_over)
    opt = {'name': 'vsr', 'model_type': 'VideoRecurrentModel',
           'is_train': True, 'num_gpu': 1, 'manual_seed': 0, 'scale': 4,
           'network_g': {'type': 'BasicVSR', 'num_feat': 8, 'num_block': 1},
           'path': {'models': str(tmp_path / 'm'),
                    'training_states': str(tmp_path / 's'),
                    'visualization': str(tmp_path / 'v')},
           'train': train,
           'val': {'metrics': {'psnr': {'type': 'calculate_psnr',
                                        'crop_border': 0}}},
           'logger': {}}
    for d in ('m', 's'):
        os.makedirs(tmp_path / d, exist_ok=True)
    return opt


@pytest.fixture
def port_init(monkeypatch):
    """The JAX package's BasicVSR init replaced by the port's seeded
    weights as a JAX tree (its own init draws op by op)."""
    from bsvd_tpu.archs import basicvsr_arch as jb

    def init(key, num_feat=64, num_block=15):
        return jax.tree.map(jnp.asarray, to_jax_tree(build_network(
            {'type': 'BasicVSR', 'num_feat': num_feat,
             'num_block': num_block}, 'cpu')))
    monkeypatch.setattr(jb, 'basicvsr_init', init)


def _batch():
    rng = np.random.default_rng(4)
    return {'lq': rng.uniform(0, 1, (1, 3, 3, 16, 16)).astype(np.float32),
            'gt': rng.uniform(0, 1, (1, 3, 3, 64, 64)).astype(np.float32)}


def _state(tree):
    return from_jax_tree(jax.tree.map(np.array, tree))


def _rel(got, ref, rel):
    err = (got - ref).abs().max().item()
    assert err <= rel * ref.abs().max().item(), (err, ref.abs().max().item())


def _grads(pm):
    return jax.tree.map(jnp.asarray, state_dict_to_tree(
        {n: torch.zeros_like(p) if p.grad is None else p.grad
         for n, p in pm.net.named_parameters()}))


def test_steps_across_fix_flow_match_jax(tmp_path, port_init, clips):
    from bsvd_tpu.data import build_dataset as jbuild_dataset
    from bsvd_tpu.models import build_model as jbuild_model
    from bsvd_tpu_torch.data import SimpleLoader, build_dataset
    opt = _opt(tmp_path)
    jm = jbuild_model(opt)
    pm = build_model(opt, device='cpu')
    start = {k: v.clone() for k, v in pm.net.state_dict().items()}
    for k, v in _state(jm.params).items():
        assert torch.equal(start[k], v), k
    apply_fn, cri = jm.net.apply, jm.cri_pix
    loss_grad = jax.jit(jax.value_and_grad(
        lambda p, lq, gt: cri(apply_fn(p, lq), gt)))
    update = jax.jit(jm.tx.update)
    params = jax.tree.map(jnp.asarray, to_jax_tree(pm.net))
    ema = params
    tx_state = jm.tx.init(params)
    batch = _batch()
    worst = {}
    for it in (1, 2, 3):
        with jax.enable_x64(True):
            ref_loss, ref_grads = loss_grad(*jax.tree.map(
                lambda a: jnp.asarray(a, jnp.float64),
                (to_jax_tree(pm.net), batch['lq'], batch['gt'])))
            ref_loss = float(ref_loss)
            ref_grads = _state(ref_grads)
        pm.feed_data(batch)
        pm.optimize_parameters(it)
        assert abs(float(pm.log_dict['l_pix']) - ref_loss) <= 1e-5 * ref_loss
        grads = _grads(pm)
        for k, v in _state(grads).items():
            if it < 2 and k.startswith('spynet.'):
                assert not v.any(), k           # frozen: no gradient
                continue
            worst[k] = max(worst.get(k, 0), (v - ref_grads[k]).abs().max()
                           .item() / ref_grads[k].abs().max().item())
        grads['spynet'] = jax.tree.map(lambda g: g * float(it >= 2),
                                       grads['spynet'])
        updates, tx_state = update(grads, tx_state, params)
        params = optax.apply_updates(params, updates)
        ema = jax.tree.map(lambda e, p: e * 0.9 + p * (1 - 0.9), ema, params)
        for net, tree in ((pm.net, params), (pm.net_g_ema, ema)):
            got = net.state_dict()
            for k, v in _state(tree).items():
                _rel(got[k], v, 1e-6)
        got = pm.net.state_dict()
        assert all(torch.equal(got[k], start[k]) != (it >= 2)
                   for k in got if k.startswith('spynet.basic_module')), it
    k = max(worst, key=worst.get)
    assert worst[k] <= GRAD_REL, (k, worst[k])
    assert pm.optimizer.count == pm.optimizer_flow.count == 3
    assert pm.get_current_learning_rate() == [float(jm.lr_schedule(3))]
    # validation: the JAX model given the port's weights (its network's
    # apply jitted: it runs eagerly there, op by op)
    jm.net.apply = jax.jit(jm.net.apply)
    jm.params = jax.tree.map(jnp.asarray, to_jax_tree(pm.net))
    jm.ema_params = jax.tree.map(jnp.asarray, to_jax_tree(pm.net_g_ema))
    vopt = {'name': 'REDS4', 'type': 'VideoRecurrentTestDataset',
            'dataroot_gt': clips['gt'], 'dataroot_lq': clips['lq']}
    got = pm.validation(SimpleLoader(build_dataset(vopt)), 3, None)
    ref = jm.nondist_validation(SimpleLoader(jbuild_dataset(vopt)), 3, None,
                                False)
    assert set(got) == {'psnr'} and np.isfinite(got['psnr'])
    assert abs(got['psnr'] - ref['psnr']) <= 1e-3, (got, ref)


def test_save_and_resume_continue_identically(tmp_path):
    from bsvd_tpu_torch.models.checkpoint import load_training_state
    opt = _opt(tmp_path, fix_flow=3)
    pm = build_model(opt, device='cpu')
    batch = _batch()
    for it in (1, 2):
        pm.feed_data(batch)
        pm.optimize_parameters(it)
    pm.save(0, 2)
    again_opt = dict(opt, path=dict(opt['path'], pretrain_network_g=str(
        tmp_path / 'm' / 'net_g_2.npz')))
    again = build_model(again_opt, device='cpu')
    again.resume_training(load_training_state(str(tmp_path / 's' /
                                                  '2.state')))
    assert again.optimizer_flow.count == again.optimizer.count == 2
    for it in (3, 4):                   # 3 is the unfreeze
        for m in (pm, again):
            m.feed_data(batch)
            m.optimize_parameters(it)
    for a, b in ((pm.net, again.net), (pm.net_g_ema, again.net_g_ema)):
        sa, sb = a.state_dict(), b.state_dict()
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
    pm.feed_data({'lq': batch['lq'][0]})
    pm.test()
    assert pm.output.shape == (1, 3, 3, 64, 64) and pm.gt is None


def _cli(root, clips, *extra, iters=3):
    return ['-opt', os.path.join(ROOT, 'options', 'train',
                                 'basicvsr_reds.yml'),
            '--device', 'cpu', *extra, '--force_yml',
            f"datasets:train:dataroot_gt={clips['gt']}",
            f"datasets:train:dataroot_lq={clips['lq']}",
            f"datasets:val:dataroot_gt={clips['gt']}",
            f"datasets:val:dataroot_lq={clips['lq']}",
            'network_g:spynet_path=~', 'network_g:num_feat=8',
            'network_g:num_block=1', 'datasets:train:num_frame=3',
            'datasets:train:gt_size=32', f'train:total_iter={iters}',
            'train:fix_flow=2', 'val:val_freq=3', 'logger:print_freq=1',
            'logger:save_checkpoint_freq=3']


def test_train_cli_from_the_shipped_yml(tmp_path, clips):
    """``python -m bsvd_tpu_torch.train -opt options/train/basicvsr_reds.yml
    --device cpu`` (train_pipeline), 3 iterations, then --auto_resume to
    4: the model, both Adams' counts, the checkpoints, the loss, the
    validation PSNR and its TensorBoard tag."""
    from bsvd_tpu_torch.train import train_pipeline
    from bsvd_tpu_torch.utils import tb_events
    model = train_pipeline(str(tmp_path), cmd=_cli(tmp_path, clips))
    assert type(model).__name__ == 'VideoRecurrentModel'
    assert model.optimizer.count == model.optimizer_flow.count == 3
    exp = tmp_path / 'experiments' / 'basicvsr_reds'
    assert sorted(os.listdir(exp / 'models')) == ['net_g_3.npz',
                                                  'net_g_latest.npz']
    assert np.isfinite(model.get_current_log()['l_pix'])
    tags = {tag: v for _, _, tag, v in tb_events.read_dir(
        str(exp / 'tb_logger'))}
    assert np.isfinite(tags['metrics/psnr'])
    resumed = train_pipeline(str(tmp_path), cmd=_cli(
        tmp_path, clips, '--auto_resume', iters=4))
    assert resumed.optimizer.count == resumed.optimizer_flow.count == 4
