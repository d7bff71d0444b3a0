"""The video family's data and inference script of the port against the
JAX package's on the CPU:

- ``Vimeo90KDataset`` and ``Vimeo90KRecurrentDataset`` (with and without
  ``flip_sequence``) item by item on a small septuplet tree, the same
  ``manual_seed`` (reversal, crop and flips drawn alike), one GT frame
  EXIF-turned by 180 degrees; ``skip`` makes an item's draws without
  decoding it; the lmdb backend builds its clients on the stores' paths
  (its items: ``tests/test_torch_lmdb.py``);
- ``VideoTestVimeo90KDataset`` and ``VideoTestDUFDataset`` (with and
  without ``use_duf_downsampling``, frames whose sides are not multiples
  of the scale) item by item;
- ``data_util.duf_downsample`` at scales 2, 3 and 4 and
  ``generate_gaussian_kernel``;
- ``python -m bsvd_tpu_torch.inference.inference_basicvsr`` against the
  JAX repo's ``inference/inference_basicvsr.py`` (run in-process with
  ``sys.argv`` patched) on a 4-frame folder in chunks of 3, on the same
  random full-width weights.

Tolerances: dataset items and the downsampling the same bits (the same
scipy calls); the inference images within one uint8 level, at under 1%
of the pixels (the two BasicVSRs agree to ~1e-6 in fp32, and a value
within that of a rounding boundary of ``tensor2img`` may round either
way).
"""

import importlib.util
import os
import sys

import numpy as np
import pytest

from exif_util import png_with, tiff
from bsvd_tpu_torch.archs import build_network
from bsvd_tpu_torch.convert.torch_generic import to_jax_tree
from bsvd_tpu_torch.data import build_dataset
from bsvd_tpu_torch.data import data_util
from bsvd_tpu_torch.models.checkpoint import save_npz_params
from bsvd_tpu_torch.utils.img_util import encode_png, imfrombytes, imwrite
from torch_threads import one_torch_thread  # noqa: F401

jax = pytest.importorskip('jax')
jnp = pytest.importorskip('jax.numpy')
cv2 = pytest.importorskip('cv2')

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _same_item(got, ref):
    assert set(got) == set(ref)
    for k, v in ref.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
        else:
            assert got[k] == v, k


@pytest.fixture(scope='module')
def vimeo(tmp_path_factory):
    """gt/<clip>/<seq>/im1..7.png (24 x 32), lq (6 x 8, 4x4 means), three
    septuplets in a meta-info file; one GT frame tagged orientation 3."""
    root = tmp_path_factory.mktemp('vimeo')
    rng = np.random.default_rng(7)
    keys = ['00001/0001', '00001/0002', '00002/0001']
    for key in keys:
        for i in range(1, 8):
            gt = rng.integers(0, 256, (24, 32, 3)).astype(np.uint8)
            lq = gt.reshape(6, 4, 8, 4, 3).mean((1, 3)).round()
            path = root / 'gt' / key / f'im{i}.png'
            if key == keys[1] and i == 4:
                os.makedirs(path.parent, exist_ok=True)
                # stored 24 x 32 upside down, read upright
                path.write_bytes(png_with(encode_png(gt[::-1, ::-1].copy()),
                                          tiff(3)))
            else:
                imwrite(gt, str(path))
            imwrite(lq.astype(np.uint8), str(root / 'lq' / key /
                                             f'im{i}.png'))
    meta = root / 'meta.txt'
    meta.write_text(''.join(f'{k} 7 (24,32,3)\n' for k in keys))
    return {'gt': str(root / 'gt'), 'lq': str(root / 'lq'),
            'meta': str(meta)}


VIMEO = {
    'vimeo90k': {'type': 'Vimeo90KDataset', 'num_frame': 5,
                 'random_reverse': True},
    'vimeo90k_7_no_flips': {'type': 'Vimeo90KDataset', 'num_frame': 7,
                            'use_hflip': False, 'use_rot': False},
    'recurrent': {'type': 'Vimeo90KRecurrentDataset', 'num_frame': 5,
                  'random_reverse': True},
    'recurrent_flip_sequence': {'type': 'Vimeo90KRecurrentDataset',
                                'num_frame': 3, 'flip_sequence': True},
}


@pytest.mark.parametrize('case', sorted(VIMEO))
def test_vimeo90k_datasets_equal_jax(vimeo, case):
    from bsvd_tpu.data import build_dataset as jbuild
    opt = dict(VIMEO[case], name=case, dataroot_gt=vimeo['gt'],
               dataroot_lq=vimeo['lq'], meta_info_file=vimeo['meta'],
               io_backend={'type': 'disk'}, gt_size=16, scale=4,
               manual_seed=5, phase='train')
    got, ref = build_dataset(opt), jbuild(opt)
    assert len(got) == len(ref) == 3
    order = [0, 1, 1, 2, 0]
    for i in order:
        _same_item(got[i], ref[i])
    again = build_dataset(opt)
    for i in order[:3]:
        again.skip(i)
    _same_item(again[order[3]], _nth(jbuild(opt), order, 3))
    lmdb = build_dataset(dict(opt, io_backend={'type': 'lmdb'}))
    assert lmdb.io_backend_opt == {'type': 'lmdb', 'client_keys': [
        'lq', 'gt'], 'db_paths': [vimeo['lq'], vimeo['gt']]}
    assert lmdb.io_backend_opt == jbuild(dict(
        opt, io_backend={'type': 'lmdb'})).io_backend_opt


def _nth(ds, order, n):
    """The n-th item of ``order`` read in turn from a fresh dataset."""
    for i in order[:n]:
        ds[i]
    return ds[order[n]]


@pytest.fixture(scope='module')
def clips(tmp_path_factory):
    """gt/<clip>/NNNNNNNN.png (34 x 38: not multiples of 4) and lq, two
    clips of 5 and 6 frames."""
    root = tmp_path_factory.mktemp('duf')
    rng = np.random.default_rng(8)
    for c, frames in enumerate((5, 6)):
        for i in range(frames):
            imwrite(rng.integers(0, 256, (34, 38, 3)).astype(np.uint8),
                    str(root / 'gt' / f'{c:03d}' / f'{i:08d}.png'))
            imwrite(rng.integers(0, 256, (8, 9, 3)).astype(np.uint8),
                    str(root / 'lq' / f'{c:03d}' / f'{i:08d}.png'))
    return {'gt': str(root / 'gt'), 'lq': str(root / 'lq')}


@pytest.mark.parametrize('duf', [False, True], ids=['lq', 'duf_downsample'])
def test_video_test_duf_dataset_equals_jax(clips, duf):
    from bsvd_tpu.data import build_dataset as jbuild
    opt = {'type': 'VideoTestDUFDataset', 'name': 'duf', 'num_frame': 5,
           'padding': 'reflection_circle', 'use_duf_downsampling': duf,
           'scale': 4, 'dataroot_gt': clips['gt'], 'dataroot_lq': clips['lq']}
    got, ref = build_dataset(opt), jbuild(opt)
    assert len(got) == len(ref) == 11
    for i in range(len(ref)):
        _same_item(got[i], ref[i])
    assert got[0]['gt'].shape == (3, 32, 36)
    assert got[0]['lq'].shape == (5, 3, 8, 9)


def test_video_test_vimeo90k_dataset_equals_jax(vimeo):
    from bsvd_tpu.data import build_dataset as jbuild
    for nf in (7, 3):
        opt = {'type': 'VideoTestVimeo90KDataset', 'name': 'vimeo',
               'num_frame': nf, 'dataroot_gt': vimeo['gt'],
               'dataroot_lq': vimeo['lq'], 'meta_info_file': vimeo['meta']}
        got, ref = build_dataset(opt), jbuild(opt)
        assert len(got) == len(ref) == 3
        for i in range(3):
            _same_item(got[i], ref[i])
    with pytest.raises(NotImplementedError, match='cache_data'):
        build_dataset(dict(opt, cache_data=True))


@pytest.mark.parametrize('scale', [2, 3, 4])
def test_duf_downsample_equals_jax(scale):
    from bsvd_tpu.data import data_util as jdu
    x = np.random.default_rng(scale).uniform(0, 1, (2, 3, 30, 37)).astype(
        np.float32)
    got = data_util.duf_downsample(x, kernel_size=13, scale=scale)
    ref = jdu.duf_downsample(x, kernel_size=13, scale=scale)
    assert got.dtype == ref.dtype and np.array_equal(got, ref)
    k = data_util.generate_gaussian_kernel(13, 0.4 * scale)
    assert np.array_equal(k, jdu.generate_gaussian_kernel(13, 0.4 * scale))
    assert abs(k.sum() - 1) < 1e-6
    with pytest.raises(AssertionError, match='scale'):
        data_util.duf_downsample(x, scale=5)


def _run_jax_script(monkeypatch, argv):
    monkeypatch.setattr(sys, 'path', list(sys.path))
    monkeypatch.setattr(sys, 'argv', ['inference_basicvsr.py', *argv])
    spec = importlib.util.spec_from_file_location(
        '_jax_inference_basicvsr',
        os.path.join(ROOT, 'inference', 'inference_basicvsr.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main()


def test_inference_basicvsr_matches_the_jax_script(tmp_path, monkeypatch):
    from bsvd_tpu.archs import basicvsr_arch as jb
    from bsvd_tpu_torch.inference import inference_basicvsr as mod
    net = build_network({'type': 'BasicVSR', 'num_feat': 64,
                         'num_block': 30, 'seed': 4}, 'cpu')
    ckpt = str(tmp_path / 'basicvsr.npz')
    save_npz_params(ckpt, {'params': to_jax_tree(net)})
    rng = np.random.default_rng(9)
    for i in range(4):
        imwrite(rng.integers(0, 256, (12, 16, 3)).astype(np.uint8),
                str(tmp_path / 'frames' / f'{i:04d}.png'))
    argv = ['--model_path', ckpt, '--input_path', str(tmp_path / 'frames'),
            '--interval', '3']
    mod.main([*argv, '--save_path', str(tmp_path / 'port'), '--device',
              'cpu'])
    # the JAX init draws op by op (its weights are replaced by the file's)
    monkeypatch.setattr(jb, 'basicvsr_init', lambda key, num_feat=64,
                        num_block=15: to_jax_tree(net))
    # its BasicVSR runs eagerly there; jitted here for time
    monkeypatch.setattr(jb.BasicVSR, '__call__',
                        lambda self, x: jax.jit(self.apply)(self.params, x))
    _run_jax_script(monkeypatch, [*argv, '--save_path',
                                  str(tmp_path / 'jax')])
    names = sorted(os.listdir(tmp_path / 'jax'))
    assert names == [f'{i:08d}_BasicVSR.png' for i in range(4)]
    assert sorted(os.listdir(tmp_path / 'port')) == names
    for f in names:
        imgs = []
        for side in ('port', 'jax'):
            with open(tmp_path / side / f, 'rb') as fh:
                imgs.append(imfrombytes(fh.read(), 'unchanged').astype(int))
        assert imgs[0].shape == (48, 64, 3)
        diff = np.abs(imgs[0] - imgs[1])
        assert diff.max() <= 1 and (diff > 0).mean() < 0.01, f
