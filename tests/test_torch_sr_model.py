"""The zoo's image-SR training slice of the port against the JAX package on
the CPU: every loss of ``losses/`` (pixel, TV, PSNR, perceptual and
style, GAN in each type with ``is_disc``, multi-scale, feature matching,
the R1 / gradient / path-length penalties), ``imfrombytes`` against
``cv2.imdecode`` on the frame fixtures with every flag, the paired
dataset's items, the enlarged sampler's indices and the one-worker batch
loader's batches (and one rank's rows of them), SRModel and ESRGANModel over 3 steps (the gated G step
included), DenoisingModel's perceptual loss (first-step gradients against
JAX's in float64) and the SR train and test command lines.

Nets are tiny (8-16 features, 1-2 blocks, the VGG cut at conv1_1 where
the test chooses the layer). Tolerances, with their reasons:

- losses: 1e-5 x |ref| (summation order only);
- decoded images, dataset items, sampler indices, loader batches: equal
  bits;
- the SR engines: each step's losses within 1e-4 x |ref|; the
  parameters after step 1 within 1e-5 x max|ref| per tensor (SRModel)
  and, for the GAN engines, plus 2% of the learning rate (``_step_close``:
  Adam's first step divides by |g| + eps, so an element whose gradient
  is near 0 carries the gradient's last bits into its step); a gated G
  step leaves G's parameters and Adam's count the same bits;
- the perceptual DenoisingModel step's loss and gradients: 1e-4 x
  max|ref| per tensor against JAX's make_train_step in float64 (as
  tests/test_torch_train.py holds the pixel loss's).
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from bsvd_tpu_torch.convert.torch_generic import from_jax_tree
from bsvd_tpu_torch.losses import build_loss
from torch_threads import one_torch_thread  # noqa: F401

jax = pytest.importorskip('jax')
jnp = pytest.importorskip('jax.numpy')
cv2 = pytest.importorskip('cv2')

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, 'tests', 'fixtures')


def _arr(seed, shape, lo=0.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


def _t(a, grad=False):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


def _rel(got, ref, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = float(np.abs(got - ref).max())
    assert err <= tol * max(float(np.abs(ref).max()), 1e-30), \
        (err, float(np.abs(ref).max()))


def _vgg_npz(path, upto_idx=2, seed=9):
    """A torchvision-layout VGG19 state dict (features.0 and .2: conv1_1,
    conv1_2) that both packages read as pretrain_path."""
    rng = np.random.default_rng(seed)
    state = {'features.0.weight': rng.normal(0, 0.27, (64, 3, 3, 3)),
             'features.0.bias': rng.uniform(-0.1, 0.1, 64),
             'features.2.weight': rng.normal(0, 0.06, (64, 64, 3, 3)),
             'features.2.bias': rng.uniform(-0.1, 0.1, 64)}
    np.savez(path, **{k: v.astype(np.float32) for k, v in state.items()
                      if int(k.split('.')[1]) <= upto_idx})
    return str(path)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('case', [
    ({'type': 'WeightedTVLoss', 'loss_weight': 0.7}, 'NCHW', True),
    ({'type': 'WeightedTVLoss', 'reduction': 'sum',
      'data_format': 'NHWC'}, 'NHWC', False),
    ({'type': 'PSNRLoss', 'loss_weight': 0.5}, 'NCHW', False),
    ({'type': 'PSNRLoss', 'to_y': True}, 'NCHW', False),
    ({'type': 'PSNRLoss', 'to_y': True}, 'NTCHW', False)],
    ids=['tv_weighted', 'tv_sum_nhwc', 'psnr', 'psnr_y', 'psnr_y_video'])
def test_tv_and_psnr_losses_match_jax(case):
    from bsvd_tpu.losses import build_loss as jbuild
    opt, layout, weighted = case
    shape = {'NCHW': (2, 3, 6, 7), 'NHWC': (2, 6, 7, 3),
             'NTCHW': (2, 4, 3, 5, 6)}[layout]
    a, b, w = _arr(1, shape), _arr(2, shape), _arr(3, shape)
    if opt['type'] == 'WeightedTVLoss':
        args = (a,) + ((w,) if weighted else ())
    else:
        args = (a, b)
    got = build_loss(opt)(*[_t(v) for v in args])
    ref = jbuild(opt)(*[jnp.asarray(v) for v in args])
    _rel(got, ref, 1e-5)


@pytest.mark.parametrize('criterion,style', [('l1', 0.0), ('l2', 0.5),
                                             ('fro', 2.0)])
def test_perceptual_loss_matches_jax(criterion, style, tmp_path):
    """Perceptual and style (Gram) terms and the input gradient, the VGG
    read by both packages from one .npz, gt taking no gradient."""
    from bsvd_tpu.losses import build_loss as jbuild
    opt = {'type': 'PerceptualLoss', 'layer_weights': {'conv1_1': 0.6,
                                                       'conv1_2': 1.5},
           'perceptual_weight': 1.0 if criterion != 'l2' else 0.0,
           'style_weight': style, 'criterion': criterion,
           'pretrain_path': _vgg_npz(tmp_path / 'vgg.npz')}
    x, gt = _arr(4, (2, 3, 12, 12)), _arr(5, (2, 3, 12, 12))
    jloss = jbuild(opt)

    def jtotal(xx, yy):
        p, s = jloss(xx, yy)
        return sum(v for v in (p, s) if v is not None), (p, s)
    (_, (jp, js)), jg = jax.jit(jax.value_and_grad(jtotal, has_aux=True))(
        jnp.asarray(x), jnp.asarray(gt))
    loss = build_loss(opt)
    xt, gtt = _t(x, True), _t(gt, True)
    p, s = loss(xt, gtt)
    for got, ref in ((p, jp), (s, js)):
        assert (got is None) == (ref is None)
        if ref is not None:
            _rel(got, ref, 1e-5)
    sum(v for v in (p, s) if v is not None).backward()
    _rel(xt.grad, jg, 1e-5)
    assert gtt.grad is None


@pytest.mark.parametrize('gan_type', ['vanilla', 'lsgan', 'wgan',
                                      'wgan_softplus', 'hinge'])
def test_gan_losses_match_jax(gan_type):
    """GANLoss and MultiScaleGANLoss in every type, real and fake target,
    generator (weighted) and discriminator (not weighted) side."""
    from bsvd_tpu.losses import build_loss as jbuild
    x = _arr(6, (3, 1, 4, 4), -2, 2)
    ms = [_arr(7, (2, 1, 3, 3), -2, 2), [_arr(8, (2, 4)),
                                         _arr(9, (2, 1, 2, 2), -2, 2)]]
    for typ in ('GANLoss', 'MultiScaleGANLoss'):
        opt = {'type': typ, 'gan_type': gan_type, 'real_label_val': 0.9,
               'fake_label_val': 0.1, 'loss_weight': 0.3}
        port, ref = build_loss(opt), jbuild(opt)
        for real in (True, False):
            for disc in (True, False):
                _rel(port(_t(x), real, is_disc=disc),
                     ref(jnp.asarray(x), real, is_disc=disc), 1e-5)
                if typ == 'MultiScaleGANLoss':
                    got = port([_t(ms[0]), [_t(v) for v in ms[1]]], real,
                               disc)
                    want = ref([jnp.asarray(ms[0]),
                                [jnp.asarray(v) for v in ms[1]]], real, disc)
                    _rel(got, want, 1e-5)


@pytest.mark.parametrize('criterion', ['l1', 'l2', 'charbonnier'])
def test_gan_feat_loss_matches_jax(criterion):
    from bsvd_tpu.losses import build_loss as jbuild
    fake = [[_arr(10 + i, (2, 3, 4)), _arr(20 + i, (2, 5)),
             _arr(30 + i, (2, 1))] for i in range(2)]
    real = [[_arr(40 + i, (2, 3, 4)), _arr(50 + i, (2, 5)),
             _arr(60 + i, (2, 1))] for i in range(2)]
    opt = {'type': 'GANFeatLoss', 'criterion': criterion,
           'loss_weight': 2.0}
    got = build_loss(opt)([[_t(v) for v in d] for d in fake],
                          [[_t(v) for v in d] for d in real])
    ref = jbuild(opt)([[jnp.asarray(v) for v in d] for d in fake],
                      [[jnp.asarray(v) for v in d] for d in real])
    _rel(got, ref, 1e-5)


def test_penalties_match_jax(monkeypatch):
    """r1_penalty, gradient_penalty_loss (real == fake, so the draw of
    alpha does not matter; with a weight) and g_path_regularize (JAX's
    noise draw replaced by the port's), each differentiable."""
    from bsvd_tpu.losses import gan_loss as jgan
    from bsvd_tpu_torch.losses import (g_path_regularize,
                                       gradient_penalty_loss, r1_penalty)
    w = _arr(11, (1, 3, 1, 1), -1, 1)
    real = _arr(12, (2, 3, 5, 5))
    wt = _arr(13, (2, 3, 5, 5))
    scale = _t(np.float32(1.5), True)

    def d_port(x):
        return torch.tanh(x * _t(w) * scale).sum(dim=(1, 2, 3))

    def d_jax(x):
        return jnp.tanh(x * jnp.asarray(w) * 1.5).sum(axis=(1, 2, 3))
    r1 = r1_penalty(d_port, _t(real))
    _rel(r1, jax.jit(lambda v: jgan.r1_penalty(d_jax, v))(jnp.asarray(real)),
         1e-5)
    r1.backward()
    assert scale.grad is not None and torch.isfinite(scale.grad)
    gp = gradient_penalty_loss(d_port, _t(real), _t(real),
                               torch.Generator().manual_seed(0), _t(wt))
    _rel(gp, jax.jit(lambda a, b: jgan.gradient_penalty_loss(
        d_jax, a, a, jax.random.PRNGKey(0), b))(jnp.asarray(real),
                                               jnp.asarray(wt)), 1e-5)
    lat = _arr(14, (2, 3, 4), -1, 1)
    gen = torch.Generator().manual_seed(5)
    noise = torch.randn((2, 4, 4), generator=gen)
    monkeypatch.setattr(jgan.jax.random, 'normal',
                        lambda key, shape, dtype: jnp.asarray(noise.numpy()))
    m = _t(_arr(15, (4, 4)))

    def g_port(lt):
        return torch.tanh(lt.sum(1)[..., None] * m)

    def g_jax(lt):
        return jnp.tanh(lt.sum(1)[..., None] * jnp.asarray(m.numpy()))
    got = g_path_regularize(g_port, _t(lat), 0.3,
                            torch.Generator().manual_seed(5))
    ref = jax.jit(lambda v: jgan.g_path_regularize(
        g_jax, v, 0.3, jax.random.PRNGKey(0)))(jnp.asarray(lat))
    for a, b in zip(got, ref):
        _rel(a, b, 1e-5)


# ---------------------------------------------------------------------------
# imfrombytes, the paired dataset, the sampler and the batch loader
# ---------------------------------------------------------------------------

def _fixture_files():
    out = []
    for sub, ext in (('frames', ('.png', '.bmp')), ('jpeg', ('.jpg',))):
        d = os.path.join(FIXTURES, sub)
        out += [os.path.join(d, f) for f in sorted(os.listdir(d))
                if f.endswith(ext)]
    return out


@pytest.mark.parametrize('flag', ['color', 'grayscale', 'unchanged'])
def test_imfrombytes_equals_jax_on_fixtures(flag):
    """Every PNG / BMP / JPEG fixture, uint8 and float32, the same bits,
    shape and dtype as JAX's imfrombytes (cv2.imdecode); 16-bit PNGs stay
    uint16 unchanged and run past 1 in float32."""
    from bsvd_tpu.utils.img_util import imfrombytes as jax_imfrombytes
    from bsvd_tpu_torch.utils.img_util import imfrombytes
    files = _fixture_files()
    assert len(files) == 21
    for path in files:
        with open(path, 'rb') as f:
            data = f.read()
        for f32 in (False, True):
            got = imfrombytes(data, flag, f32)
            ref = jax_imfrombytes(data, flag, f32)
            assert got.dtype == ref.dtype and got.shape == ref.shape, \
                (path, got.shape, ref.shape, got.dtype, ref.dtype)
            assert np.array_equal(got, ref), path
    with open(os.path.join(FIXTURES, 'frames', 'rgb16.png'), 'rb') as f:
        sixteen = imfrombytes(f.read(), 'unchanged', True)
    assert sixteen.max() > 1 if flag == 'unchanged' else True
    with pytest.raises(ValueError, match='GIF89a'):
        imfrombytes(b'GIF89a\x01\x00', flag)


@pytest.fixture(scope='module')
def sr_folders(tmp_path_factory):
    """DIV2K-like paired PNG folders (x2: GT 24x20 and 20x24, LQ an area
    mean) and a validation pair set."""
    from bsvd_tpu_torch.utils.img_util import imwrite
    root = tmp_path_factory.mktemp('sr')
    rng = np.random.default_rng(0)
    for split, n in (('train', 5), ('val', 2)):
        for sub in ('gt', 'lq'):
            os.makedirs(root / split / sub)
        for i in range(n):
            h, w = (24, 20) if i % 2 else (20, 24)
            gt = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            lq = gt.reshape(h // 2, 2, w // 2, 2, 3).mean((1, 3)).round()
            imwrite(gt, str(root / split / 'gt' / f'{i:04d}.png'))
            imwrite(lq.astype(np.uint8), str(root / split / 'lq' /
                                             f'{i:04d}.png'))
    return root


def _ds_opt(root, phase, **over):
    opt = {'name': 'pairs', 'type': 'PairedImageDataset', 'phase': phase,
           'dataroot_gt': str(root / phase / 'gt'),
           'dataroot_lq': str(root / phase / 'lq'), 'scale': 2,
           'gt_size': 8, 'use_hflip': True, 'use_rot': True,
           'manual_seed': 3, 'io_backend': {'type': 'disk'}}
    opt.update(over)
    return opt


def _same_item(got, ref):
    assert sorted(got) == sorted(ref)
    for k in ref:
        if isinstance(ref[k], np.ndarray):
            assert got[k].dtype == ref[k].dtype and np.array_equal(
                got[k], ref[k]), k
        else:
            assert got[k] == ref[k], k


@pytest.mark.parametrize('phase,over', [
    ('train', {}), ('train', {'use_rot': False}),
    ('val', {'mean': [0.4, 0.5, 0.6], 'std': [0.2, 0.3, 0.25]})],
    ids=['train', 'train_hflip_only', 'val_mean_std'])
def test_paired_image_dataset_items_equal_jax(sr_folders, phase, over):
    """Items in order, twice over (one RNG per dataset draws every crop
    and flip)."""
    from bsvd_tpu.data.paired_image_dataset import PairedImageDataset as J
    from bsvd_tpu_torch.data.paired_image_dataset import PairedImageDataset
    opt = _ds_opt(sr_folders, phase, **over)
    port, ref = PairedImageDataset(dict(opt)), J(dict(opt))
    assert len(port) == len(ref) and port.paths == ref.paths
    assert not getattr(port, 'supports_parallel_read', False)
    for i in list(range(len(ref))) * 2:
        _same_item(port[i], ref[i])


def test_sampler_and_one_worker_loader_equal_jax(sr_folders):
    """EnlargedSampler's indices (ratio 3, two ranks and one), then
    build_dataloader's BatchLoader over two epochs: the same batches bit
    for bit, the sampler's epoch advanced by each pass."""
    from bsvd_tpu.data import build_dataloader as jax_loader
    from bsvd_tpu.data.paired_image_dataset import PairedImageDataset as J
    from bsvd_tpu.data.sampler import EnlargedSampler as JS
    from bsvd_tpu_torch.data import build_dataloader
    from bsvd_tpu_torch.data.paired_image_dataset import PairedImageDataset
    from bsvd_tpu_torch.data.sampler import BatchLoader, EnlargedSampler
    ds = list(range(7))
    for kw in ({'ratio': 3}, {'num_replicas': 2, 'rank': 1, 'ratio': 2}):
        port, ref = EnlargedSampler(ds, **kw), JS(ds, **kw)
        for epoch in (0, 4):
            port.set_epoch(epoch)
            ref.set_epoch(epoch)
            assert list(port) == list(ref) and len(port) == len(ref)
    opt = _ds_opt(sr_folders, 'train', batch_size_per_gpu=2,
                  num_worker_per_gpu=1, dataset_enlarge_ratio=2)
    loader = build_dataloader(PairedImageDataset(dict(opt)), opt, num_gpu=1)
    ref = jax_loader(J(dict(opt)), opt, num_gpu=1)
    assert isinstance(loader, BatchLoader) and len(loader) == len(ref) == 5
    for _ in range(2):
        got, want = list(loader), list(ref)
        assert len(got) == len(want) == 5
        for g, w in zip(got, want):
            _same_item(g, w)
    assert loader.sampler.epoch == 2


@pytest.mark.parametrize('rank', [0, 1])
def test_rank_loader_decodes_own_rows_of_jax_batches(sr_folders, rank,
                                                     monkeypatch):
    """BatchLoader of rank r of 2 (as build_dataloader makes it with
    ``dist``) over a global batch of 4: each batch is rows 2r, 2r + 1 of
    JAX's global batch bit for bit (the other rows' crops and flips drawn
    from the images' headers), and only those rows' files are decoded."""
    from bsvd_tpu.data import build_dataloader as jax_loader
    from bsvd_tpu.data.paired_image_dataset import PairedImageDataset as J
    from bsvd_tpu_torch.data.paired_image_dataset import PairedImageDataset
    from bsvd_tpu_torch.data.sampler import BatchLoader, EnlargedSampler
    from bsvd_tpu_torch.utils import img_util
    opt = _ds_opt(sr_folders, 'train', batch_size_per_gpu=2,
                  num_worker_per_gpu=1, dataset_enlarge_ratio=2)
    ref = jax_loader(J(dict(opt)), opt, num_gpu=2)
    ds = PairedImageDataset(dict(opt))
    loader = BatchLoader(ds, 4, sampler=EnlargedSampler(ds, ratio=2),
                         num_workers=1, rank=rank, num_ranks=2)
    decoded = []
    real = img_util.imfrombytes
    monkeypatch.setattr(img_util, 'imfrombytes',
                        lambda *a, **k: decoded.append(1) or real(*a, **k))
    assert len(loader) == len(ref) == 2
    for _ in range(2):
        got, want = list(loader), list(ref)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            _same_item(g, {k: v[2 * rank:2 * rank + 2] for k, v in
                           w.items()})
    assert len(decoded) == 2 * 2 * 2 * 2      # files x rows x batches x epochs
    with pytest.raises(ValueError, match='rank 2 of 2'):
        BatchLoader(ds, 4, rank=2, num_ranks=2)


# ---------------------------------------------------------------------------
# SRModel and ESRGANModel against JAX
# ---------------------------------------------------------------------------

def _model_opt(tmp_path, model_type, **train_over):
    opt = {
        'name': 'sr_parity', 'model_type': model_type, 'is_train': True,
        'num_gpu': 1, 'manual_seed': 0, 'scale': 4,
        'network_g': {'type': 'MSRResNet', 'num_in_ch': 3, 'num_out_ch': 3,
                      'num_feat': 8, 'num_block': 1, 'upscale': 4},
        'path': {'models': str(tmp_path / 'm'),
                 'training_states': str(tmp_path / 's')},
        'train': {'optim_g': {'type': 'Adam', 'lr': 2e-3,
                              'betas': [0.9, 0.99]},
                  'scheduler': {'type': 'CosineAnnealingRestartLR',
                                'periods': [2, 8], 'restart_weights': [1, 1],
                                'eta_min': 1e-5},
                  'total_iter': 3,
                  'pixel_opt': {'type': 'L1Loss', 'loss_weight': 1.0}},
        'logger': {}}
    opt['train'].update(train_over)
    for k in ('m', 's'):
        os.makedirs(tmp_path / k, exist_ok=True)
    return opt


def _step_close(got, ref, lr):
    """Parameters after one Adam step: within 1e-5 x max|ref| plus 2% of
    the step lr. The first step moves each element by lr x g / (|g| +
    eps): where |g| is within a few hundred eps of 0, the last bits of g
    (summation order) move it by up to a percent of lr (seen: 0.8% on
    one element of the SN U-Net discriminator's conv3)."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    err = float(np.abs(got - ref).max())
    assert err <= 1e-5 * float(np.abs(ref).max()) + 2e-2 * lr, err


@pytest.fixture
def port_inits(monkeypatch):
    """The JAX package's MSRResNet and VGG-style discriminator inits
    replaced by the port's seeded weights as JAX trees (its own init
    draws op by op and costs seconds a net): both packages' engines start
    from the same weights."""
    from bsvd_tpu.archs import discriminator_arch as jd
    from bsvd_tpu.archs import sr_archs as jsr
    from bsvd_tpu_torch.archs import build_network
    from bsvd_tpu_torch.convert.torch_generic import to_jax_tree

    def tree(opt):
        return jax.tree.map(jnp.asarray, to_jax_tree(build_network(
            opt, 'cpu')))

    monkeypatch.setattr(jsr.MSRResNet, 'init_fn', staticmethod(
        lambda key, **kw: tree(dict(kw, type='MSRResNet'))))
    monkeypatch.setattr(jd, 'vgg_discriminator_init', lambda key, cin, nf,
                        size: tree({'type': f'VGGStyleDiscriminator{size}',
                                    'num_in_ch': cin, 'num_feat': nf}))


def _commit(jm, *names):
    """The JAX engine's states put on the replicated sharding its step
    returns them in, so that step 2 reuses step 1's compilation."""
    from bsvd_tpu.parallel.mesh import replicated_sharding
    for name in names:
        if getattr(jm, name, None) is not None:
            setattr(jm, name, jax.device_put(getattr(jm, name),
                                             replicated_sharding(jm.mesh)))


def _same_start(jm, pm, nets):
    for net, jtree in nets:
        want = _port_state(jtree)
        for k, v in net.state_dict().items():
            if k in want:
                assert torch.equal(v, want[k]), k


def _jax_leaves(tree):
    return [np.array(v) for v in jax.tree.leaves(tree)]


def _port_state(jtree):
    return from_jax_tree(jax.tree.map(np.asarray, jtree))


def _step_both(jm, pm, batch, it):
    jm.feed_data(batch)
    jm.optimize_parameters(it)
    pm.feed_data(batch)
    pm.optimize_parameters(it)
    jl, pl = dict(jm.log_dict), dict(pm.get_current_log())
    assert sorted(jl) == sorted(pl), (sorted(jl), sorted(pl))
    for k in jl:
        _rel(np.float32(pl[k]), jl[k], 1e-4)


def test_sr_model_three_steps_match_jax(tmp_path, port_inits):
    """SRModel: L1 + perceptual (conv1_1, npz weights), EMA; losses of 3
    steps, parameters and EMA after step 1, the schedule at Adam's count,
    then save and a reload into a test-mode model (the EMA's output)."""
    from bsvd_tpu.models import build_model as jax_build_model
    from bsvd_tpu_torch.models.base_model import build_model
    vgg = _vgg_npz(tmp_path / 'vgg.npz', 0)
    opt = _model_opt(tmp_path, 'SRModel', ema_decay=0.9, perceptual_opt={
        'type': 'PerceptualLoss', 'layer_weights': {'conv1_1': 1.0},
        'style_weight': 0.3, 'pretrain_path': vgg})
    jm = jax_build_model(opt)
    pm = build_model(opt, device='cpu')
    _same_start(jm, pm, [(pm.net, jm.params), (pm.net_g_ema, jm.params)])
    _commit(jm, 'params', 'opt_state', 'ema_params')
    batch = {'lq': _arr(20, (2, 3, 8, 8)), 'gt': _arr(21, (2, 3, 32, 32))}
    _step_both(jm, pm, batch, 1)
    for got, ref in ((pm.net, jm.params), (pm.net_g_ema, jm.ema_params)):
        want = _port_state(ref)
        for k, v in got.state_dict().items():
            _rel(v, want[k].numpy(), 1e-5)
    for it in (2, 3):
        _step_both(jm, pm, batch, it)
    assert pm.optimizer.count == 3
    assert pm.get_current_learning_rate() == [float(jm.lr_schedule(3))]
    pm.save(0, 3)
    test_opt = dict(opt, is_train=False)
    test_opt['path'] = dict(opt['path'], pretrain_network_g=str(
        tmp_path / 'm' / 'net_g_3.npz'), param_key_g='params_ema')
    again = build_model(test_opt, device='cpu')
    pm.feed_data(batch)
    pm.test()
    again.feed_data(batch)
    again.test()
    assert np.array_equal(again.output, pm.output)


def _gan_opt(tmp_path, model_type, **gate):
    opt = _model_opt(tmp_path, model_type, gan_opt={
        'type': 'GANLoss', 'gan_type': 'vanilla', 'real_label_val': 1.0,
        'fake_label_val': 0.0, 'loss_weight': 0.1},
        optim_d={'type': 'Adam', 'lr': 1e-3, 'betas': [0.9, 0.99]}, **gate)
    opt['network_d'] = {'type': 'VGGStyleDiscriminator128', 'num_feat': 4}
    return opt


def _gan_batch():
    return {'lq': _arr(22, (2, 3, 32, 32)), 'gt': _arr(23, (2, 3, 128, 128))}


def _g_changed(pm, before):
    return not all(torch.equal(v, before[k])
                   for k, v in pm.net.state_dict().items())


def test_esrgan_model_three_steps_match_jax(tmp_path, port_inits):
    """ESRGANModel (relativistic) with net_d_init_iters 1, G then D, 3
    steps: every step's G and D losses against JAX's, D's parameters and
    BN running statistics and G's after step 1, the gated G step (G's
    parameters and Adam's count unchanged in both packages), D's count,
    and the resume state's two optimizers."""
    from bsvd_tpu.models import build_model as jax_build_model
    from bsvd_tpu_torch.models.base_model import build_model
    from bsvd_tpu_torch.models.checkpoint import load_training_state
    opt = _gan_opt(tmp_path, 'ESRGANModel', net_d_iters=1,
                   net_d_init_iters=1)
    jm = jax_build_model(opt)
    pm = build_model(opt, device='cpu')
    _same_start(jm, pm, [(pm.net, jm.params), (pm.net_d, jm.d_params)])
    _commit(jm, 'params', 'opt_state', 'd_params', 'opt_state_d')
    batch = _gan_batch()
    for it in (1, 2, 3):
        g_before = {k: v.clone() for k, v in pm.net.state_dict().items()}
        j_before = _jax_leaves(jm.params)
        _step_both(jm, pm, batch, it)
        j_same = all(np.array_equal(a, b) for a, b in
                     zip(_jax_leaves(jm.params), j_before))
        assert _g_changed(pm, g_before) == (it > 1) != j_same, it
        assert pm.optimizer.count == it - 1
        if it == 1:
            for got, ref in ((pm.net_d, jm.d_params), (pm.net, jm.params)):
                want = _port_state(ref)
                got_state = got.state_dict()
                assert set(want) <= set(got_state)
                lr = 1e-3 if got is pm.net_d else 2e-3
                for k, v in want.items():
                    _step_close(got_state[k], v.numpy(), lr)
    assert pm.optimizer_d.count == 3
    pm.save(0, 3)
    assert (tmp_path / 'm' / 'net_d_3.npz').exists()
    st = load_training_state(str(tmp_path / 's' / '3.state'))
    assert st['opt_state']['count'] == 2
    assert st['extra']['opt_state_d']['count'] == 3
    fresh = build_model(opt, device='cpu')
    fresh.resume_training(st)
    assert fresh.optimizer.count == 2 and fresh.optimizer_d.count == 3


def test_srgan_model_gated_every_other_iteration(tmp_path):
    """SRGANModel with net_d_iters 2: G steps on even iterations only (its
    parameters and Adam's count the same bits on odd ones, the schedule
    read at that count), D every iteration, D's BN running statistics
    moving; the losses finite and logged on gated iterations too."""
    from bsvd_tpu_torch.models.base_model import build_model
    pm = build_model(_gan_opt(tmp_path, 'SRGANModel', net_d_iters=2,
                              net_d_init_iters=0), device='cpu')
    batch = _gan_batch()
    var0 = pm.net_d.bn0_1.running_var.clone()
    for it in (1, 2, 3, 4):
        before = {k: v.clone() for k, v in pm.net.state_dict().items()}
        pm.feed_data(batch)
        pm.optimize_parameters(it)
        assert _g_changed(pm, before) == (it % 2 == 0), it
        assert pm.optimizer.count == it // 2 and pm.optimizer_d.count == it
        log = pm.get_current_log()
        assert list(log) == ['l_g_pix', 'l_g_gan', 'l_d_real', 'l_d_fake',
                             'out_d_real', 'out_d_fake']
        assert all(np.isfinite(v) for v in log.values())
    assert not torch.equal(pm.net_d.bn0_1.running_var, var0)


# ---------------------------------------------------------------------------
# DenoisingModel's perceptual loss
# ---------------------------------------------------------------------------

def test_denoising_model_perceptual_grads_match_jax(tmp_path):
    """The first step of DenoisingModel with perceptual_opt (MSE + VGG
    conv1_2 perceptual + style) against the JAX package's
    ``make_train_step`` on the same WNet and VGG weights (the JAX model's
    own cfg, losses and parameters; its ``tx`` hands the step's gradients
    back as its state): the logged loss terms and every parameter's
    gradient. The JAX step runs the WNet in float64 (its parameters and
    lq cast) and casts the output to fp32 before the losses, as it does
    for every dtype, so its VGG runs in fp32."""
    import optax
    from bsvd_tpu.models.denoising_model import DenoisingModel as JaxModel
    from bsvd_tpu.models.denoising_model import make_train_step
    from bsvd_tpu_torch.archs.wnet_arch import _map_tree, _to_tree
    from bsvd_tpu_torch.convert.torch_ckpt import from_jax_params
    from bsvd_tpu_torch.models.denoising_model import DenoisingModel
    net2d = {'chns': [8, 16, 32], 'mid_ch': 8, 'norm': 'none',
             'interm_ch': 8, 'act': 'relu6'}
    percep = {'type': 'PerceptualLoss', 'layer_weights': {'conv1_2': 1.0},
              'style_weight': 0.5, 'pretrain_path':
              _vgg_npz(tmp_path / 'vgg.npz')}
    t = 3
    opt = {'name': 'percep', 'model_type': 'DenoisingModel', 'num_gpu': 1,
           'is_train': True,
           'network_g': {'type': 'TSN', 'num_segments': t,
                         'base_model': 'WNet_multistage',
                         'shift_type': 'TSM', 'shift_div': 8, 'seed': 2,
                         'net2d_opt': net2d},
           'path': {}, 'train': {
               'optim_g': {'type': 'Adam', 'lr': 1e-3, 'betas': [0.9, 0.99]},
               'total_iter': 1,
               'pixel_opt': {'type': 'MSELoss', 'loss_weight': 1.0},
               'perceptual_opt': percep}}
    rng = np.random.default_rng(3)
    gt = rng.uniform(0, 1, (1, t, 3, 16, 16)).astype(np.float32)
    lq = (gt + rng.normal(0, 0.1, gt.shape)).astype(np.float32)
    nm = np.full((1, t, 1, 16, 16), 0.1, np.float32)
    jm = JaxModel(dict(opt))
    jparams = jax.tree.map(np.asarray, jm.params)
    model = DenoisingModel(dict(opt), device='cpu')
    model.net.load_params(from_jax_params(jparams, model.cfg))
    seen = {}

    def capture():
        seen.update(grads=_map_tree(_to_tree(model.net.params),
                                    lambda p: p.grad.clone()))
    model.optimizer.step = capture
    model.feed_data({'lq': lq, 'gt': gt, 'noise_map': nm})
    model.optimize_parameters(1)
    log = model.get_current_log()
    assert list(log) == ['l_pix', 'l_percep', 'l_style']

    grads_as_state = optax.GradientTransformation(
        lambda p: (), lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g),
                                            g))
    x = np.transpose(np.concatenate([lq, nm], 2), (0, 1, 3, 4, 2))
    y = np.transpose(gt, (0, 1, 3, 4, 2))
    with jax.enable_x64(True):
        def f64(tree):
            return jax.tree.map(
                lambda a: jnp.asarray(np.asarray(a), jnp.float64), tree)
        step = make_train_step(jm.cfg, grads_as_state, jm.cri_pix,
                               cri_perceptual=jm.cri_perceptual)
        _, jgrads, _, jlosses = jax.jit(step)(
            f64(jparams), (), None, {'lq': f64(x), 'gt': jnp.asarray(y)}, 1,
            0.)
        jlosses = {k: float(v) for k, v in jlosses.items()}
        jgrads = jax.tree.map(np.asarray, jgrads)
    assert sorted(jlosses) == sorted(log)
    for k, ref in jlosses.items():
        _rel(np.float64(log[k]), ref, 1e-4)
    refs = dict(_flat(from_jax_params(jgrads, model.cfg)))
    got = dict(_flat(seen['grads']))
    assert sorted(got) == sorted(refs) and len(refs) > 20
    for name, ref in refs.items():
        _rel(got[name], ref.numpy(), 1e-4)


def _flat(tree, prefix=''):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f'{prefix}/{k}')
    else:
        yield prefix, tree


# ---------------------------------------------------------------------------
# the command lines
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def div2k(tmp_path_factory):
    """x4 paired folders: 2 GT of 128 x 128 (a 32 x 32 patch of a smooth
    field, upscaled 4x) and their 4x4 area means; and a 2-image val set
    (GT 48 x 48, a multiple of 12)."""
    from bsvd_tpu_torch.utils.img_util import imwrite
    root = tmp_path_factory.mktemp('div2k')
    rng = np.random.default_rng(1)
    for split, n, hw in (('train', 2, 128), ('val', 2, 48)):
        for sub in ('gt', 'lq'):
            os.makedirs(root / split / sub)
        for i in range(n):
            base = rng.integers(0, 256, (hw // 4, hw // 4, 3)).astype(
                np.float64)
            gt = np.kron(base, np.ones((4, 4, 1))).astype(np.uint8)
            lq = gt.reshape(hw // 4, 4, hw // 4, 4, 3).mean((1, 3)).round()
            imwrite(gt, str(root / split / 'gt' / f'{i:04d}.png'))
            imwrite(lq.astype(np.uint8), str(root / split / 'lq' /
                                             f'{i:04d}.png'))
    return root


def _sr_cmd(yml, data, *extra):
    narrow = {'msrresnet_x4': ['network_g:num_feat=8',
                               'network_g:num_block=1'],
              'esrgan_x4': ['network_g:num_feat=8', 'network_g:num_block=1',
                            'network_g:num_grow_ch=4',
                            'network_d:num_feat=4']}[yml]
    return ['-opt', os.path.join(ROOT, 'options', 'train', f'{yml}.yml'),
            '--device', 'cpu', *extra, '--force_yml',
            f'datasets:train:dataroot_gt={data}/train/gt',
            f'datasets:train:dataroot_lq={data}/train/lq',
            f'datasets:val:dataroot_gt={data}/val/gt',
            f'datasets:val:dataroot_lq={data}/val/lq',
            'datasets:train:batch_size_per_gpu=2',
            'datasets:train:num_worker_per_gpu=1', 'train:total_iter=2',
            'val:val_freq=2', 'logger:print_freq=1',
            'logger:save_checkpoint_freq=2', *narrow]


@pytest.mark.parametrize('yml', ['msrresnet_x4', 'esrgan_x4'])
def test_sr_train_cli_from_the_shipped_yml(div2k, tmp_path, monkeypatch,
                                           capsys, yml):
    """Two iterations of ``python -m bsvd_tpu_torch.train -opt
    options/train/<yml>.yml --device cpu`` (train_pipeline) on PNG
    folders: the model type, the checkpoints, the validation PSNR, the
    losses of the option file; ESRGAN's EMA, D's files and the random
    VGG's warning. Then the test CLI's main() on the saved network."""
    from bsvd_tpu_torch import test as test_mod
    from bsvd_tpu_torch.train import train_pipeline
    monkeypatch.delenv('BSVD_VGG_PRETRAIN_PATH', raising=False)
    model = train_pipeline(str(tmp_path), cmd=_sr_cmd(yml, div2k))
    name = {'msrresnet_x4': 'SRModel', 'esrgan_x4': 'ESRGANModel'}[yml]
    assert type(model).__name__ == name and model.optimizer.count == 2
    models = sorted(os.listdir(tmp_path / 'experiments' / yml / 'models'))
    log = model.get_current_log()
    if yml == 'esrgan_x4':
        assert model.net_g_ema is not None
        assert models == ['net_d_2.npz', 'net_d_latest.npz', 'net_g_2.npz',
                          'net_g_latest.npz']
        assert {'l_g_pix', 'l_g_percep', 'l_g_gan', 'l_d_real',
                'l_d_fake'} <= set(log)
        log_file, = (tmp_path / 'experiments' / yml).glob('train_*.log')
        assert 'no pretrained VGG weights' in log_file.read_text()
    else:
        assert models == ['net_g_2.npz', 'net_g_latest.npz']
        assert list(log) == ['l_pix']
    assert all(np.isfinite(v) for v in log.values())
    ckpt = tmp_path / 'experiments' / yml / 'models' / 'net_g_latest.npz'
    test_yml = tmp_path / 'sr_test.yml'
    test_yml.write_text(json.dumps({
        'name': f'{yml}_test', 'model_type': name, 'scale': 4,
        'num_gpu': 1, 'manual_seed': 0,
        'datasets': {'test_1': {'name': 'Set5', 'type':
                                'PairedImageDataset',
                                'dataroot_gt': str(div2k / 'val' / 'gt'),
                                'dataroot_lq': str(div2k / 'val' / 'lq')}},
        'network_g': model.opt['network_g'],
        'path': {'pretrain_network_g': str(ckpt),
                 'param_key_g': 'params_ema' if model.net_g_ema else
                 'params'},
        'val': {'save_img': True, 'metrics': {'psnr': {
            'type': 'calculate_psnr', 'crop_border': 4}}}}))
    monkeypatch.setattr(test_mod, 'ROOT', str(tmp_path))
    monkeypatch.setattr(sys, 'argv', ['test', '-opt', str(test_yml),
                                      '--device', 'cpu'])
    capsys.readouterr()
    test_mod.main()
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(out['Set5']['psnr'])
    saved = tmp_path / 'results' / f'{yml}_test' / 'visualization' / 'Set5'
    assert sorted(os.listdir(saved)) == ['0000_' + yml + '_test.png',
                                         '0001_' + yml + '_test.png']
    model.feed_data({'lq': np.zeros((3, 12, 12), np.float32)})
    model.test()
    assert model.output.shape == (1, 3, 48, 48)

