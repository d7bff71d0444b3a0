"""The TF-FID InceptionV3, FID, LPIPS and their four scripts of the port
against the JAX package on the CPU. No pretrained file is in the
repository: every check runs on random state dicts written in the layouts
the JAX loaders read (torchvision's InceptionV3 and VGG16, the lpips
package's heads), made from seeds with numpy.

Tolerances, with their reasons:

- Inception feature maps, the features of the scripts, LPIPS distances:
  1e-5 x max|ref| (fp32 summation order through up to 94 convs;
  measured ~1.5e-6);
- the FID statistics of the scripts: means and covariances 1e-5 x
  max|ref|; FID is then computed by both packages on the same statistics
  and must be the same bits (``sqrtm`` amplifies feature noise, so two
  end-to-end FIDs are not compared);
- ``calculate_fid``: bit-equal on the same inputs;
- the converters: equal bits.

``calculate_stylegan2_fid`` draws its codes from a seeded
``torch.Generator`` on the device, JAX's script from ``jax.random``: the
two sample other images of one net by design. The generator-and-features
path is held on the same codes; the scripts' own numbers only for their
shape and finiteness.
"""

import contextlib
import importlib.util
import io
import os
import sys

import numpy as np
import pytest
import torch

from bsvd_tpu_torch.archs.inception_arch import (InceptionV3,
                                                 convert_torch_state_dict)
from torch_threads import one_torch_thread  # noqa: F401

jax = pytest.importorskip('jax')
jnp = pytest.importorskip('jax.numpy')

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5


def _rel(got, ref, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = float(np.abs(got - ref).max())
    assert err <= tol * float(np.abs(ref).max()), \
        (err, float(np.abs(ref).max()))


def _nchw(a):
    return np.transpose(np.asarray(a), (0, 3, 1, 2))


@pytest.fixture(scope='module')
def inception_pth(tmp_path_factory):
    """A torchvision-layout FID Inception state dict (fc and
    num_batches_tracked included, as the released file has them): convs
    He-normal, BN statistics and affine random; as arrays and as a
    ``.pth`` of tensors."""
    rng = np.random.default_rng(0)
    state = {}
    for k, v in InceptionV3().state_dict().items():
        if 'num_batches_tracked' in k:
            state[k] = np.zeros((), np.int64)
        elif 'running_var' in k:
            state[k] = rng.uniform(0.5, 1.5, v.shape)
        elif k.endswith('bn.weight'):
            state[k] = 1 + 0.1 * rng.standard_normal(v.shape)
        elif 'conv.weight' in k:
            state[k] = rng.standard_normal(v.shape) * np.sqrt(
                2.0 / v[0].numel())
        else:
            state[k] = 0.1 * rng.standard_normal(v.shape)
    state['fc.weight'] = rng.standard_normal((1008, 2048))
    state['fc.bias'] = np.zeros(1008)
    state = {k: v.astype(np.int64 if 'num_batches' in k else np.float32)
             for k, v in state.items()}
    path = tmp_path_factory.mktemp('inception') / 'pt_inception.pth'
    torch.save({k: torch.from_numpy(v) for k, v in state.items()}, str(path))
    return state, str(path)


def _port_inception(state, blocks, resize, normalize):
    net = InceptionV3(blocks, resize, normalize)
    net.load_state_dict(convert_torch_state_dict(state), strict=False)
    return net


def test_convert_torch_state_dict_matches_jax(inception_pth):
    """The port's converter against JAX's tree: every conv (OIHW against
    HWIO) and BN vector of the 94 BasicConv2d, fc.* and
    num_batches_tracked dropped."""
    from bsvd_tpu.archs.inception_arch import \
        convert_torch_state_dict as jconvert
    state, _ = inception_pth
    got = convert_torch_state_dict(state)
    tree = jconvert(state)
    n = 0
    for key, val in got.items():
        *mod, leaf, kind = key.split('.')
        node = tree
        for m in mod:
            node = node[m]
        if leaf == 'conv':
            np.testing.assert_array_equal(
                val.numpy(), np.transpose(np.asarray(node['w']),
                                          (3, 2, 0, 1)))
            n += 1
        else:
            name = {'weight': 'scale', 'bias': 'bias', 'running_mean': 'mean',
                    'running_var': 'var'}[kind]
            np.testing.assert_array_equal(val.numpy(), node['bn'][name])
    assert n == 94 and not any(k.startswith('fc') or 'num_batches' in k
                               for k in got)
    net = InceptionV3()
    missing, unexpected = net.load_state_dict(got, strict=False)
    assert not unexpected
    assert all(k.endswith('num_batches_tracked') for k in missing)


def test_inception_blocks_0_to_3_match_jax(inception_pth):
    """output_blocks 0-3 at 2 x 96 x 96 in [-1, 1], no resize, no
    normalisation (pool1, pool2, Mixed_6e, the pooled Mixed_7c)."""
    from bsvd_tpu.archs.inception_arch import (convert_torch_state_dict as
                                               jconvert, inception_v3_apply)
    state, _ = inception_pth
    x = np.random.default_rng(1).uniform(-1, 1, (2, 3, 96, 96)).astype(
        np.float32)
    ref = jax.jit(lambda p, v: inception_v3_apply(p, v, (0, 1, 2, 3), False,
                                                  False))(
        jconvert(state), jnp.asarray(np.transpose(x, (0, 2, 3, 1))))
    with torch.no_grad():
        got = _port_inception(state, (0, 1, 2, 3), False, False)(
            torch.from_numpy(x))
    assert [tuple(g.shape) for g in got] == [
        (2, 64, 22, 22), (2, 192, 9, 9), (2, 768, 4, 4), (2, 2048, 1, 1)]
    for g, r in zip(got, ref):
        _rel(g, _nchw(r))


def test_inception_resize_and_normalize_match_jax(inception_pth):
    """The resize to 299 (the shared two-matmul bilinear resize) and 2x - 1
    once, on a 37 x 53 input in [0, 1], pool3 features."""
    from bsvd_tpu.archs.inception_arch import (convert_torch_state_dict as
                                               jconvert, inception_v3_apply,
                                               resize_bilinear as jresize)
    from bsvd_tpu_torch.archs.inception_arch import resize_bilinear
    state, _ = inception_pth
    x = np.random.default_rng(2).uniform(0, 1, (1, 3, 37, 53)).astype(
        np.float32)
    xh = jnp.asarray(np.transpose(x, (0, 2, 3, 1)))
    _rel(resize_bilinear(torch.from_numpy(x), 299, 299),
         _nchw(jresize(xh, 299, 299)), 1e-6)
    ref = jax.jit(lambda p, v: inception_v3_apply(p, v, (3,), True, True))(
        jconvert(state), xh)[0]
    with torch.no_grad():
        got = _port_inception(state, (3,), True, True)(torch.from_numpy(x))[0]
    _rel(got, _nchw(ref))


def test_extract_features_nhwc_and_nchw_match_jax(inception_pth):
    """``extract_inception_features`` on NCHW and NHWC numpy batches and a
    torch batch (JAX's layout rule), against JAX's with the patched
    configuration loaded from the same ``.pth``."""
    from bsvd_tpu.metrics import fid as jfid
    from bsvd_tpu_torch.metrics import fid as pfid
    _, path = inception_pth
    rng = np.random.default_rng(3)
    nchw = [rng.uniform(-1, 1, (2, 3, 24, 20)).astype(np.float32)
            for _ in range(2)]
    nhwc = [np.ascontiguousarray(np.transpose(b, (0, 2, 3, 1)))
            for b in nchw]
    ref = jfid.extract_inception_features(
        iter(nchw), jfid.load_patched_inception_v3(pretrain_path=path))
    net = pfid.load_patched_inception_v3(pretrain_path=path, device='cpu')
    assert net.resize_input and not net.normalize_input
    for batches in (nchw, nhwc, [torch.from_numpy(b) for b in nchw]):
        got = pfid.extract_inception_features(iter(batches), net)
        assert got.shape == (4, 2048) and got.dtype == np.float32
        _rel(got, ref)
    with pytest.raises(FileNotFoundError, match='BSVD_INCEPTION'):
        pfid.load_patched_inception_v3(pretrain_path=path + '.absent',
                                       device='cpu')


def test_calculate_fid_is_bit_equal_to_jax():
    from bsvd_tpu.metrics.fid import calculate_fid as jfid
    from bsvd_tpu_torch.metrics.fid import calculate_fid
    rng = np.random.default_rng(4)
    f1 = rng.standard_normal((64, 16))
    f2 = rng.standard_normal((80, 16)) + 0.3
    args = (f1.mean(0), np.cov(f1, rowvar=False), f2.mean(0),
            np.cov(f2, rowvar=False))
    assert calculate_fid(*args) == jfid(*args)
    assert calculate_fid(*args[:2], *args[:2]) == pytest.approx(0, abs=1e-6)
    few = rng.standard_normal((5, 16))          # singular covariances
    sing = (few.mean(0), np.cov(few, rowvar=False))
    assert calculate_fid(*sing, *args[2:]) == jfid(*sing, *args[2:])


# ---------------------------------------------------------------- LPIPS
@pytest.fixture(scope='module')
def lpips_files(tmp_path_factory):
    """A torchvision-layout VGG16 (convs through conv5_3, He-normal) and
    the lpips package's five heads, as ``.pth`` files of tensors."""
    from bsvd_tpu_torch.archs.vgg_arch import vgg_names
    from bsvd_tpu_torch.metrics.lpips import CHNS
    rng = np.random.default_rng(5)
    vgg, cin = {}, 3
    for idx, name in enumerate(vgg_names('vgg16')[:30]):
        if name.startswith('conv'):
            cout = min(64 * 2 ** (int(name[4]) - 1), 512)
            vgg[f'features.{idx}.weight'] = torch.from_numpy(
                (rng.standard_normal((cout, cin, 3, 3))
                 * np.sqrt(2 / (9 * cin))).astype(np.float32))
            vgg[f'features.{idx}.bias'] = torch.from_numpy(
                rng.uniform(-0.1, 0.1, cout).astype(np.float32))
            cin = cout
    lins = {f'lin{i}.model.1.weight': torch.from_numpy(
        rng.uniform(-0.02, 0.1, (1, c, 1, 1)).astype(np.float32))
        for i, c in enumerate(CHNS)}
    root = tmp_path_factory.mktemp('lpips')
    torch.save(vgg, str(root / 'vgg16.pth'))
    torch.save(lins, str(root / 'lpips_vgg.pth'))
    return str(root / 'lpips_vgg.pth'), str(root / 'vgg16.pth')


def test_lpips_matches_jax(lpips_files):
    """LPIPS from the same weight files (heads with negative entries,
    clamped at apply) on two 40 x 36 pairs in [-1, 1]; a pair with
    itself is 0; the missing files raise as JAX's do."""
    from bsvd_tpu.metrics.lpips import load_lpips as jload
    from bsvd_tpu_torch.metrics.lpips import LPIPS, load_lpips
    lin_path, vgg_path = lpips_files
    rng = np.random.default_rng(6)
    x0, x1 = (rng.uniform(-1, 1, (2, 3, 40, 36)).astype(np.float32)
              for _ in range(2))
    params, fn = jload(lin_path, vgg_path)
    ref = fn(params, *(jnp.asarray(np.transpose(x, (0, 2, 3, 1)))
                       for x in (x0, x1)))
    net = load_lpips(lin_path, vgg_path, device='cpu')
    with torch.no_grad():
        got = net(torch.from_numpy(x0), torch.from_numpy(x1))
        same = net(torch.from_numpy(x0), torch.from_numpy(x0))
    assert got.shape == (2,) and (got > 0).all()
    _rel(got, ref)
    assert float(same.abs().max()) < 1e-6
    with torch.no_grad():
        rand = LPIPS(seed=1)(torch.from_numpy(x0), torch.from_numpy(x1))
    assert rand.shape == (2,) and torch.isfinite(rand).all()
    for bad in ((lin_path + '.x', vgg_path), (lin_path, vgg_path + '.x')):
        with pytest.raises(FileNotFoundError, match='BSVD_LPIPS'):
            load_lpips(*bad, device='cpu')


# ---------------------------------------------------------------- scripts
def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f'_t_jax_{name}', os.path.join(ROOT, 'scripts', 'metrics',
                                       f'{name}.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(fn, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = fn(*args)
    return res, out.getvalue()


def _folder(root, n, hw, seed):
    """n PNGs of 4 x 4 random colour blocks (features that differ from
    image to image after the resize to 299)."""
    from bsvd_tpu_torch.utils.img_util import imwrite
    os.makedirs(root)
    rng = np.random.default_rng(seed)
    for i in range(n):
        blocks = rng.integers(0, 256, (4, 4, 3)).astype(np.uint8)
        img = np.kron(blocks, np.ones((hw[0] // 4, hw[1] // 4, 1)))
        imwrite(img.astype(np.uint8), os.path.join(root, f'{i:03d}.png'))
    return str(root)


class _Capture:
    """Records each call's arguments and what ``fn`` returned."""

    def __init__(self, fn):
        self.fn, self.args, self.out = fn, [], []

    def __call__(self, *args):
        self.args.append(args)
        self.out.append(self.fn(*args))
        return self.out[-1]


class _Record:
    """A JAX script's ``calculate_fid`` that records its statistics and
    returns nan: its ``sqrtm`` of 2048 x 2048 takes ~15 s on one core, and
    ``calculate_fid`` is held bit-equal to the port's in
    ``test_calculate_fid_is_bit_equal_to_jax``."""

    def __init__(self):
        self.args = []

    def __call__(self, *args):
        self.args.append(args)
        return float('nan')


def test_fid_scripts_match_jax(inception_pth, tmp_path, monkeypatch):
    """calculate_fid_stats_from_datasets (5 FFHQ images, batch 2, in the
    working directory), then calculate_fid_folder against those
    statistics: the features of each run against JAX's, the ``.npz``
    keys, the statistics each script takes from its features and from
    the ``.npz`` or ``.pth`` stats file, and the port's FID of them."""
    from bsvd_tpu.metrics import fid as jfid
    from bsvd_tpu_torch.metrics.fid import calculate_fid
    from bsvd_tpu_torch.scripts.metrics import (
        calculate_fid_folder as pfolder,
        calculate_fid_stats_from_datasets as pstats)
    _, path = inception_pth
    import bsvd_tpu.archs.inception_arch as jinc
    import bsvd_tpu_torch.archs.inception_arch as pinc
    monkeypatch.setattr(jinc, 'INCEPTION_PRETRAIN_PATH', path)
    monkeypatch.setattr(pinc, 'INCEPTION_PRETRAIN_PATH', path)
    jfeat = _Capture(jfid.extract_inception_features)
    pfeat = _Capture(pstats.extract_inception_features)
    monkeypatch.setattr(jfid, 'extract_inception_features', jfeat)
    monkeypatch.setattr(pstats, 'extract_inception_features', pfeat)
    monkeypatch.setattr(pfolder, 'extract_inception_features', pfeat)
    faces = _folder(tmp_path / 'ffhq', 5, (32, 32), 7)
    restored = _folder(tmp_path / 'restored', 4, (24, 28), 8)
    saved = {}
    for side, run in (('jax', lambda a: _jax_script(
            'calculate_fid_stats_from_datasets').main()),
            ('port', lambda a: pstats.main(a))):
        os.makedirs(tmp_path / side)
        monkeypatch.chdir(tmp_path / side)
        argv = ['--dataroot', faces, '--size', '32', '--batch_size', '2',
                '--num_sample', '5']
        monkeypatch.setattr(sys, 'argv', ['x', *argv])
        _, out = _run(run, argv + ['--device', 'cpu'])
        assert 'Extracted 5 features, use the first 5' in out
        with np.load(tmp_path / side / 'inception_FFHQ_32.npz') as z:
            saved[side] = {k: z[k] for k in z.files}
    assert sorted(saved['port']) == ['cov', 'mean', 'name', 'size']
    assert saved['port']['name'] == saved['jax']['name'] == 'FFHQ'
    assert saved['port']['size'] == saved['jax']['size'] == 32
    _rel(pfeat.out[0], jfeat.out[0])
    np.testing.assert_array_equal(saved['port']['mean'],
                                  np.mean(pfeat.out[0], 0))
    np.testing.assert_array_equal(saved['port']['cov'],
                                  np.cov(pfeat.out[0], rowvar=False))
    stats_npz = str(tmp_path / 'port' / 'inception_FFHQ_32.npz')
    stats_pth = str(tmp_path / 'stats.pth')
    torch.save({k: torch.from_numpy(saved['port'][k]) for k in
                ('mean', 'cov')}, stats_pth)
    for stats in (stats_npz, stats_pth):
        got = pfolder.load_stats(stats)
        for a, b in zip(got, _jax_script('calculate_fid_folder').load_stats(
                stats)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(got[1], saved['port']['cov'])
    jdist, pdist = _Record(), _Capture(calculate_fid)
    monkeypatch.setattr(jfid, 'calculate_fid', jdist)
    monkeypatch.setattr(pfolder, 'calculate_fid', pdist)
    argv = [restored, '--fid_stats', stats_pth, '--batch_size', '3']
    monkeypatch.setattr(sys, 'argv', ['x', *argv])
    _, jout = _run(_jax_script('calculate_fid_folder').main)
    fid, pout = _run(pfolder.main, argv + ['--device', 'cpu'])
    assert jout.splitlines()[0] == pout.splitlines()[0] == (
        'Extracted 4 features, use the first 4 features to calculate stats.')
    _rel(pfeat.out[-1], jfeat.out[-1])
    feats = pfeat.out[-1]
    want = (np.mean(feats, 0), np.cov(feats, rowvar=False),
            *pfolder.load_stats(stats_npz))
    for a, b in zip(pdist.args[-1], want):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jdist.args[-1][2:], want[2:]):
        np.testing.assert_array_equal(a, b)
    assert np.isfinite(fid) and fid == pdist.out[-1]
    assert pout.splitlines()[-1] == f'fid: {fid}'


def test_stylegan2_fid_generator_and_features_match_jax(inception_pth,
                                                        tmp_path,
                                                        monkeypatch):
    """The generator-and-features path on the same codes (a 16 px
    StyleGAN2, channel multiplier 1, the ``.npz`` ``params_ema`` both
    packages load, truncation 0.7 on a given latent), then both scripts
    once for the shape and finiteness of their FIDs (their codes differ by
    design; JAX's distance is not computed, see ``_Record``)."""
    from bsvd_tpu.archs.stylegan2_arch import StyleGAN2Generator as JG
    from bsvd_tpu.metrics import fid as jfid
    from bsvd_tpu_torch.archs.stylegan2_arch import StyleGAN2Generator
    from bsvd_tpu_torch.convert.torch_generic import to_jax_tree
    from bsvd_tpu_torch.metrics import fid as pfid
    from bsvd_tpu_torch.models.checkpoint import save_npz_params
    from bsvd_tpu_torch.scripts.metrics import calculate_stylegan2_fid as psg
    _, path = inception_pth
    g = StyleGAN2Generator(16, num_style_feat=512, num_mlp=8,
                           channel_multiplier=1, seed=12)
    ckpt = str(tmp_path / 'g.npz')
    save_npz_params(ckpt, {'params_ema': to_jax_tree(g)})
    jg = JG(out_size=16, num_style_feat=512, num_mlp=8, channel_multiplier=1,
            resample_kernel=(1, 3, 3, 1))
    jg.load(ckpt, 'params_ema')
    rng = np.random.default_rng(13)
    z = rng.standard_normal((2, 512)).astype(np.float32)
    lat = rng.standard_normal((1, 512)).astype(np.float32)
    jimg = jax.jit(lambda p, v: jg.apply(
        p, [v], truncation=0.7, truncation_latent=jnp.asarray(lat),
        randomize_noise=False)[0])(jg.params, jnp.asarray(z))
    ref = jfid.extract_inception_features(
        iter([np.asarray(jimg)]),
        jfid.load_patched_inception_v3(pretrain_path=path))
    net = pfid.load_patched_inception_v3(pretrain_path=path, device='cpu')
    g.eval()
    got = pfid.extract_inception_features(psg.samples(
        g, [torch.from_numpy(z)], 0.7, torch.from_numpy(lat)), net)
    _rel(got, ref)
    stats = str(tmp_path / 'stats.npz')
    feats = rng.standard_normal((6, 2048))
    np.savez(stats, mean=feats.mean(0), cov=np.cov(feats, rowvar=False))
    import bsvd_tpu.archs.inception_arch as jinc
    import bsvd_tpu_torch.archs.inception_arch as pinc
    monkeypatch.setattr(jinc, 'INCEPTION_PRETRAIN_PATH', path)
    monkeypatch.setattr(pinc, 'INCEPTION_PRETRAIN_PATH', path)
    argv = [ckpt, stats, '--size', '16', '--channel_multiplier', '1',
            '--batch_size', '2', '--num_sample', '3', '--truncation', '0.7',
            '--truncation_mean', '8']
    monkeypatch.syspath_prepend(os.path.join(ROOT, 'scripts', 'metrics'))
    monkeypatch.setattr(sys, 'argv', ['x', *argv])
    jdist = _Record()
    monkeypatch.setattr(jfid, 'calculate_fid', jdist)
    _, jout = _run(_jax_script('calculate_stylegan2_fid').main)
    fid, pout = _run(psg.main, argv + ['--device', 'cpu'])
    for out in (jout, pout):
        assert 'Extracted 4 features, use the first 3' in out
    mean, cov = jdist.args[0][:2]
    assert mean.shape == (2048,) and cov.shape == (2048, 2048)
    assert np.isfinite(mean).all() and np.isfinite(cov).all()
    assert np.isfinite(fid) and pout.splitlines()[-1] == f'fid: {fid}'


def test_lpips_script_matches_jax(lpips_files, tmp_path, monkeypatch):
    """calculate_lpips on three 32 x 24 pairs (suffix ``_x``) read by the
    port's codecs, against the JAX script's cv2 reads: each printed
    distance within 1e-5 relative, the average line."""
    from bsvd_tpu_torch.scripts.metrics import calculate_lpips as plp
    import bsvd_tpu.metrics.lpips as jl
    import bsvd_tpu_torch.metrics.lpips as pl
    from bsvd_tpu_torch.utils.img_util import imwrite
    lin_path, vgg_path = lpips_files
    for mod in (jl, pl):
        monkeypatch.setattr(mod, 'LPIPS_PRETRAIN_PATH', lin_path)
        monkeypatch.setattr(mod, 'VGG16_PRETRAIN_PATH', vgg_path)
    gt, res = tmp_path / 'gt', tmp_path / 'res'
    os.makedirs(gt)
    os.makedirs(res)
    rng = np.random.default_rng(9)
    for i in range(3):
        img = rng.integers(0, 256, (32, 24, 3)).astype(np.uint8)
        imwrite(img, str(gt / f'{i}.png'))
        noisy = np.clip(img + rng.normal(0, 20, img.shape), 0, 255)
        imwrite(noisy.astype(np.uint8), str(res / f'{i}_x.png'))
    argv = ['--gt', str(gt), '--restored', str(res), '--suffix', '_x']
    monkeypatch.setattr(sys, 'argv', ['x', *argv])
    _, jout = _run(_jax_script('calculate_lpips').main)
    vals, pout = _run(plp.main, argv + ['--device', 'cpu'])
    jv = [float(line.split('LPIPS: ')[1].rstrip('.'))
          for line in jout.splitlines() if '. \tLPIPS' in line]
    assert len(vals) == len(jv) == 3
    np.testing.assert_allclose(vals, jv, rtol=1e-5, atol=1e-6)
    assert pout.splitlines()[-1].startswith('Average: LPIPS: ')
    assert [line.split('LPIPS')[0] for line in pout.splitlines()] == \
        [line.split('LPIPS')[0] for line in jout.splitlines()]
