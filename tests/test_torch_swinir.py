"""SwinIR of the port against the JAX package on the CPU: the net on a
random JAX tree carried across by ``from_jax_tree`` for each upsampler x
residual connection, the shifted-window mask on a 20 x 12 input at window
4 (border windows in both axes), the window shrink, the reflect pad where
it reaches past the far side, a released-style ``.pth`` read by both
packages, SwinIRModel's train step, the train command line on
chip_smoke's ``SWINIR_YML`` and ``inference_swinir`` against the JAX
script.

Tolerances, with their reasons:

- forwards: 1e-5 x max|ref| (fp32 summation order; measured ~1e-6);
- gradients: 1e-4 x each tensor's max|ref| + 1e-6 x the net's largest
  |ref| (summation order through the softmax and LayerNorm backward;
  the floor covers tensors whose gradient is near 0); the Adam update
  1e-6 x max|ref| against the JAX model's optax transform fed the port's
  recorded inputs (``tests/torch_optax.py``);
- the inference script's PNGs: equal but for at most 1 LSB on at most
  0.1% of the pixels (an fp32 output within rounding of a .5 boundary
  may round either way).

JAX's SwinIR builds its SW-MSA mask with numpy on the values of a jnp
``window_partition`` (``bsvd_tpu/archs/swinir_arch.py:85-86``), which
raises under ``jax.jit`` as soon as a block shifts: the JAX apply runs
eagerly here, and JAX's jitted SwinIRModel step only where no block
shifts (pinned in ``test_jax_swinir_step_raises_under_jit_when_shifted``).
"""

import os
import sys

import numpy as np
import pytest
import torch

from bsvd_tpu_torch.archs import build_network
from bsvd_tpu_torch.archs import swinir_arch as port
from bsvd_tpu_torch.convert.torch_generic import (from_jax_tree,
                                                  load_torch_generic,
                                                  to_jax_tree)
from torch_optax import grads_close, recording, step_matches_optax, jax_grads
from torch_threads import one_torch_thread  # noqa: F401

jax = pytest.importorskip('jax')
jnp = pytest.importorskip('jax.numpy')

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FWD_TOL = 1e-5
GRAD_TOL, GRAD_FLOOR = 1e-4, 1e-6


def _arr(seed, shape, lo=0.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


def _rel(got, ref, tol=FWD_TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = float(np.abs(got - ref).max())
    assert err <= tol * float(np.abs(ref).max()), \
        (err, float(np.abs(ref).max()))


def _opt(upsampler='pixelshuffle', resi='1conv', scale=2, ws=4,
         depths=(2, 2), heads=(2, 3), embed=12):
    return dict(type='SwinIR', upscale=scale, in_chans=3, window_size=ws,
                depths=depths, embed_dim=embed, num_heads=heads,
                mlp_ratio=2, upsampler=upsampler, resi_connection=resi,
                img_range=1.)


def _pair(opt, seed=0):
    """(the JAX SwinIR at ``seed``, the port's module on its tree)."""
    from bsvd_tpu.archs import build_network as jbuild
    jn = jbuild(dict(opt, seed=seed))
    pn = build_network(opt, 'cpu')
    pn.load_state_dict(from_jax_tree(jax.tree.map(np.asarray, jn.params),
                                     pn))
    return jn, pn


@pytest.mark.parametrize('resi', ['1conv', '3conv'])
@pytest.mark.parametrize('upsampler,scale', [
    ('pixelshuffle', 2), ('pixelshuffledirect', 3), ('nearest+conv', 4),
    ('', 1)], ids=['pixelshuffle', 'pixelshuffledirect', 'nearest_conv',
                   'none'])
def test_swinir_matches_jax(upsampler, scale, resi):
    """Depths (2, 2) at embed 12, heads (2, 3), window 4, on a 20 x 12
    input: the second block of each RSTB shifts by 2, so the mask is added
    on windows at the shifted border of both axes."""
    jn, pn = _pair(_opt(upsampler, resi, scale))
    x = _arr(1, (2, 3, 20, 12))
    ref = np.asarray(jn.apply(jn.params, jnp.asarray(x)))
    with torch.no_grad():
        got = pn(torch.from_numpy(x))
    assert got.shape == (2, 3, 20 * scale, 12 * scale)
    _rel(got, ref)
    want = jax.tree.map(lambda a: a.shape, jn.params)
    assert jax.tree.map(lambda a: a.shape, to_jax_tree(pn)) == want


def test_mask_index_and_windows_equal_jax():
    """The SW-MSA mask of a 20 x 12 image at window 4 and shift 2 (15
    windows, nine regions), the relative position index, and the window
    partition / reverse, against the JAX helpers."""
    from bsvd_tpu.archs import swinir_arch as jsw
    for h, w, ws, shift in ((20, 12, 4, 2), (16, 24, 8, 4), (12, 20, 4, 2)):
        ref = np.asarray(jsw._attn_mask(h, w, ws, shift))
        got = port.attn_mask_np(h, w, ws, shift)
        assert got.shape == ((h // ws) * (w // ws), ws * ws, ws * ws)
        np.testing.assert_array_equal(got, ref)
        assert (got != 0).any()
    for ws in (4, 7, 8):
        np.testing.assert_array_equal(port.relative_position_index_np(ws),
                                      jsw._relative_position_index(ws))
    x = _arr(2, (2, 20, 12, 5))
    xw = port.window_partition(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(
        xw.numpy(), np.asarray(jsw.window_partition(jnp.asarray(x), 4)))
    np.testing.assert_array_equal(
        port.window_reverse(xw, 4, 20, 12).numpy(), x)


def test_window_shrinks_at_run_time_as_in_jax():
    """JAX's rule: a block whose image has min(h, w) <= window attends in
    one window of side min(h, w), unshifted, decided from the image at
    run time (torch SwinIR decides it from img_size at construction).
    A 4 x 8 image at window 8 against ``swinir_apply`` (window 4, the
    index of the shrunk window into the full table); an 8 x 16 image
    gives what the net gives with every shift set to 0, a 16 x 16 image
    does not."""
    from bsvd_tpu.archs.swinir_arch import swinir_apply
    opt = _opt(ws=8, depths=(2,), heads=(2,))
    jn, pn = _pair(opt, seed=3)
    x = _arr(4, (1, 3, 4, 8))
    ref = swinir_apply(jn.params, jnp.asarray(np.transpose(x, (0, 2, 3, 1))),
                       **jn.opt)
    with torch.no_grad():
        got = pn.apply_padded(torch.from_numpy(x))
    _rel(got, np.transpose(np.asarray(ref), (0, 3, 1, 2)))
    blocks = pn.layers[0].residual_group.blocks
    assert [b.shift_size for b in blocks] == [0, 4]
    with torch.no_grad():
        outs = {}
        for hw in ((8, 16), (16, 16)):
            xx = torch.from_numpy(_arr(5, (1, 3) + hw))
            shifted = pn(xx)
            blocks[1].shift_size = 0
            unshifted = pn(xx)
            blocks[1].shift_size = 4
            outs[hw] = torch.equal(shifted, unshifted)
    assert outs == {(8, 16): True, (16, 16): False}


@pytest.mark.parametrize('hw,ws', [((3, 5), 8), ((3, 5), 4), ((9, 2), 4)])
def test_reflect_pad_reaching_the_side_and_crop(hw, ws):
    """Pads to window multiples by numpy's reflect, also where the pad
    passes the far side (3 rows padded by 5: 0 1 2 1 0 1 2 1), where
    ``F.pad(mode='reflect')`` raises; the net's output against JAX's
    (its ``jnp.pad`` reflect), cropped back to the input's size x scale."""
    for n, pad in ((3, 5), (5, 3), (2, 2), (1, 3), (9, 3)):
        np.testing.assert_array_equal(
            port.reflect_index(n, pad),
            np.pad(np.arange(n), (0, pad), mode='reflect'))
    assert list(port.reflect_index(3, 5)) == [0, 1, 2, 1, 0, 1, 2, 1]
    with pytest.raises(RuntimeError):
        torch.nn.functional.pad(torch.zeros(1, 1, 3, 8), (0, 0, 0, 5),
                                mode='reflect')
    jn, pn = _pair(_opt(ws=ws, depths=(2,), heads=(2,)), seed=6)
    x = _arr(7, (1, 3) + hw)
    ref = np.asarray(jn.apply(jn.params, jnp.asarray(x)))
    with torch.no_grad():
        got = pn(torch.from_numpy(x))
    assert got.shape == (1, 3, 2 * hw[0], 2 * hw[1])
    _rel(got, ref)


def test_released_pth_loads_in_both_packages(tmp_path):
    """A ``.pth`` in a released SwinIR's layout (``params``, with the
    ``relative_position_index`` and ``attn_mask`` buffers torch SwinIR
    saves) read by ``SwinIR.load`` and the port's ``load_torch_generic``:
    the buffers are ignored, both nets give the writer's output."""
    from bsvd_tpu.archs import build_network as jbuild
    opt = _opt(depths=(2,), heads=(2,))
    src = build_network(dict(opt, seed=11), 'cpu')
    state = dict(src.state_dict())
    for i in range(2):
        pre = f'layers.0.residual_group.blocks.{i}.'
        state[pre + 'attn.relative_position_index'] = torch.as_tensor(
            port.relative_position_index_np(4))
        if i == 1:
            state[pre + 'attn_mask'] = torch.as_tensor(
                port.attn_mask_np(16, 16, 4, 2))
    path = str(tmp_path / 'swinir.pth')
    torch.save({'params': state}, path)
    jn = jbuild(opt).load(path, 'params')
    pn = load_torch_generic(path, build_network(opt, 'cpu'), 'params')
    x = _arr(8, (1, 3, 12, 8))
    with torch.no_grad():
        want = src(torch.from_numpy(x))
        got = pn(torch.from_numpy(x))
    assert torch.equal(got, want)
    _rel(want, np.asarray(jn.apply(jn.params, jnp.asarray(x))))


# ---------------------------------------------------------------------------
# SwinIRModel
# ---------------------------------------------------------------------------

def _model_opt(tmp_path, net):
    for k in ('m', 's'):
        os.makedirs(tmp_path / k, exist_ok=True)
    return {
        'name': 'swinir_parity', 'model_type': 'SwinIRModel',
        'is_train': True, 'num_gpu': 1, 'manual_seed': 0, 'scale': 2,
        'network_g': net,
        'path': {'models': str(tmp_path / 'm'),
                 'training_states': str(tmp_path / 's')},
        'train': {'optim_g': {'type': 'Adam', 'lr': 2e-4,
                              'betas': [0.9, 0.99]},
                  'scheduler': {'type': 'MultiStepLR',
                                'milestones': [250000, 400000],
                                'gamma': 0.5},
                  'total_iter': 3,
                  'pixel_opt': {'type': 'L1Loss', 'loss_weight': 1.0}},
        'logger': {}}


@pytest.fixture
def port_init(monkeypatch):
    """JAX's SwinIR init replaced by the port's seeded weights as a JAX
    tree: both engines start from the same weights."""
    from bsvd_tpu.archs import swinir_arch as jsw

    def init(key, in_chans, embed_dim, depths, num_heads, window_size,
             mlp_ratio, patch_norm, upscale, upsampler, resi_connection):
        net = build_network(dict(
            type='SwinIR', in_chans=in_chans, embed_dim=embed_dim,
            depths=depths, num_heads=num_heads, window_size=window_size,
            mlp_ratio=mlp_ratio, upscale=upscale, upsampler=upsampler,
            resi_connection=resi_connection), 'cpu')
        return jax.tree.map(jnp.asarray, to_jax_tree(net))
    monkeypatch.setattr(jsw, 'swinir_init', init)


def test_swinir_model_step_matches_jax(tmp_path, port_init):
    """One SwinIRModel step (L1, Adam (0.9, 0.99), MultiStepLR) on an
    unshifted net (4 x 4 LQ at window 4: JAX's step jits only there): the
    loss, the gradients against the JAX step's (read off its Adam
    moments), the update against the JAX model's optax transform on the
    port's recorded inputs; then SwinIRModel.test pads and crops."""
    from bsvd_tpu.models import build_model as jax_build_model
    from bsvd_tpu_torch.models.base_model import build_model
    opt = _model_opt(tmp_path, _opt(depths=(2, 2), heads=(2, 2)))
    jm = jax_build_model(dict(opt))
    pm = build_model(opt, device='cpu')
    assert type(pm).__name__ == 'SwinIRModel'
    records = recording(pm.optimizer)
    batch = {'lq': _arr(30, (2, 3, 4, 4)), 'gt': _arr(31, (2, 3, 8, 8))}
    before = jax.tree.map(np.array, jm.opt_state)
    jm.feed_data(batch)
    jm.optimize_parameters(1)
    pm.feed_data(batch)
    pm.optimize_parameters(1)
    _rel(np.float32(pm.get_current_log()['l_pix']),
         jm.log_dict['l_pix'], 1e-5)
    want = from_jax_tree(jax_grads(before, jm.opt_state, 0.9), pm.net)
    grads_close(records[-1]['grads'], want, GRAD_TOL, GRAD_FLOOR)
    step_matches_optax(jm.tx, records[-1], pm.optimizer)
    pm.feed_data({'lq': _arr(32, (3, 7, 5))})
    pm.test()
    assert pm.output.shape == (1, 3, 14, 10)


def test_swinir_grads_with_shifted_windows_match_jax_grad():
    """The port's L1 gradients where blocks shift (an 8 x 12 LQ at window
    4, both 20 x 12 border cases' kind) against ``jax.grad`` of JAX's
    eager apply (what JAX's jitted step cannot compute)."""
    jn, pn = _pair(_opt(depths=(2,), heads=(3,)), seed=13)
    lq, gt = _arr(40, (2, 3, 8, 12)), _arr(41, (2, 3, 16, 24))

    def loss(p):
        return jnp.mean(jnp.abs(jn.apply(p, jnp.asarray(lq))
                                - jnp.asarray(gt)))
    ref_loss, ref = jax.value_and_grad(loss)(jn.params)
    out = pn(torch.from_numpy(lq))
    got = torch.mean(torch.abs(out - torch.from_numpy(gt)))
    got.backward()
    _rel(got, ref_loss)
    want = from_jax_tree(jax.tree.map(np.asarray, ref), pn)
    grads_close({n: p.grad for n, p in pn.named_parameters()}, want,
                GRAD_TOL, GRAD_FLOOR)


def test_jax_swinir_step_raises_under_jit_when_shifted(tmp_path, port_init):
    """Reference-side fault the port does not copy: JAX's SwinIRModel step
    raises TracerArrayConversionError once a block shifts (an 8 x 8 LQ at
    window 4); the port's steps there."""
    from bsvd_tpu.models import build_model as jax_build_model
    from bsvd_tpu_torch.models.base_model import build_model
    opt = _model_opt(tmp_path, _opt(depths=(2,), heads=(2,)))
    batch = {'lq': _arr(50, (1, 3, 8, 8)), 'gt': _arr(51, (1, 3, 16, 16))}
    jm = jax_build_model(dict(opt))
    jm.feed_data(batch)
    with pytest.raises(jax.errors.TracerArrayConversionError):
        jm.optimize_parameters(1)
    pm = build_model(opt, device='cpu')
    pm.feed_data(batch)
    pm.optimize_parameters(1)
    assert pm.optimizer.count == 1
    assert np.isfinite(pm.get_current_log()['l_pix'])


# ---------------------------------------------------------------------------
# the command lines
# ---------------------------------------------------------------------------

def _pairs_folder(root, n, hw, rng):
    from bsvd_tpu_torch.utils.img_util import imwrite
    for sub in ('gt', 'lq'):
        os.makedirs(root / sub)
    for i in range(n):
        base = rng.integers(0, 256, (hw // 2, hw // 2, 3)).astype(np.uint8)
        gt = np.kron(base, np.ones((2, 2, 1))).astype(np.uint8)
        imwrite(gt, str(root / 'gt' / f'{i:04d}.png'))
        imwrite(base, str(root / 'lq' / f'{i:04d}.png'))


def test_train_cli_from_the_swinir_yml(tmp_path):
    """``python -m bsvd_tpu_torch.train -opt <SWINIR_YML> --device cpu``
    (train_pipeline) for 2 iterations at narrow widths: SwinIRModel, the
    yml's Adam, schedule, EMA and L1, a validation PSNR, the checkpoints."""
    sys.path.insert(0, ROOT)
    from chip_smoke import SWINIR_YML
    from bsvd_tpu_torch.train import train_pipeline
    rng = np.random.default_rng(60)
    _pairs_folder(tmp_path / 'train', 2, 32, rng)
    _pairs_folder(tmp_path / 'val', 1, 24, rng)
    yml = tmp_path / 'swinir.yml'
    yml.write_text(SWINIR_YML)
    model = train_pipeline(str(tmp_path), cmd=[
        '-opt', str(yml), '--device', 'cpu', '--force_yml',
        f'datasets:train:dataroot_gt={tmp_path}/train/gt',
        f'datasets:train:dataroot_lq={tmp_path}/train/lq',
        'datasets:train:meta_info_file=~', 'datasets:train:gt_size=16',
        f'datasets:val:dataroot_gt={tmp_path}/val/gt',
        f'datasets:val:dataroot_lq={tmp_path}/val/lq',
        'datasets:train:batch_size_per_gpu=2',
        'datasets:train:num_worker_per_gpu=1', 'train:total_iter=2',
        'val:val_freq=2', 'logger:print_freq=1',
        'logger:save_checkpoint_freq=2', 'network_g:embed_dim=12',
        'network_g:depths=[2]', 'network_g:num_heads=[2]',
        'network_g:window_size=4'])
    assert type(model).__name__ == 'SwinIRModel'
    assert model.optimizer.count == 2 and model.net_g_ema is not None
    assert (model.optimizer.b1, model.optimizer.b2) == (0.9, 0.99)
    assert float(model.optimizer.schedule(1)) == np.float32(2e-4)
    assert list(model.get_current_log()) == ['l_pix']
    exp = tmp_path / 'experiments' / model.opt['name'] / 'models'
    assert sorted(os.listdir(exp)) == ['net_g_2.npz', 'net_g_latest.npz']


def test_inference_swinir_matches_the_jax_script(tmp_path, monkeypatch):
    """The port's ``inference_swinir`` against the JAX script run
    in-process (``main`` with ``sys.argv`` patched), lightweight SR x2 on
    a 10 x 14 and an 8 x 8 PNG, one ``.pth`` of random weights under
    ``params``: the file names and the pixels (at most 1 LSB on 0.1%)."""
    import importlib.util
    from bsvd_tpu_torch.inference import inference_swinir as pinf
    from bsvd_tpu_torch.utils.img_util import imfrombytes, imwrite
    rng = np.random.default_rng(70)
    src = tmp_path / 'lr'
    os.makedirs(src)
    for name, hw in (('a', (10, 14)), ('b', (8, 8))):
        imwrite(rng.integers(0, 256, hw + (3,)).astype(np.uint8),
                str(src / f'{name}.png'))
    net = build_network(dict(pinf.task_network('lightweight_sr', 2),
                             seed=71), 'cpu')
    ckpt = str(tmp_path / 'swinir_light.pth')
    torch.save({'params': net.state_dict()}, ckpt)
    spec = importlib.util.spec_from_file_location(
        '_t_jax_inference_swinir',
        os.path.join(ROOT, 'inference', 'inference_swinir.py'))
    jmod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jmod)
    monkeypatch.setattr(sys, 'argv', [
        'x', '--model_path', ckpt, '--input', str(src), '--output',
        str(tmp_path / 'jax'), '--task', 'lightweight_sr', '--scale', '2'])
    jmod.main()
    pinf.main(['--model_path', ckpt, '--input', str(src), '--output',
               str(tmp_path / 'port'), '--task', 'lightweight_sr',
               '--scale', '2', '--device', 'cpu'])
    names = sorted(os.listdir(tmp_path / 'jax'))
    assert names == ['a_SwinIR.png', 'b_SwinIR.png']
    assert sorted(os.listdir(tmp_path / 'port')) == names
    for name in names:
        imgs = []
        for side in ('jax', 'port'):
            with open(tmp_path / side / name, 'rb') as f:
                imgs.append(imfrombytes(f.read(), 'color').astype(int))
        assert imgs[0].shape == imgs[1].shape
        diff = np.abs(imgs[0] - imgs[1])
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, name
