"""The port's data, MATLAB, conversion and launcher scripts against the JAX
repo's scripts on the CPU, each run in-process on the same tiny tree
(``python -m bsvd_tpu_torch.scripts.<folder>.<name>``'s ``main(argv)``;
the JAX script's ``main`` with ``sys.argv`` patched, or its function):

- ``extract_subimages``: the same file names and pixels (a PNG with the
  'x4' suffix, a gray one, a JPEG, a window flush with the far edge past
  ``thresh_size``, a file that does not decode); ``generate_meta_info``:
  the same lines; ``regroup_reds_dataset``: the same tree;
- ``generate_bicubic_img`` and ``generate_LR_Vimeo90K`` on the CPU: the
  mod-crops equal; the bicubic LR / upsampled files within one uint8
  level at under 0.1% of the pixels, where the two float64 ``imresize``
  sums (numpy's and torch's einsum) land on either side of a .5 rounding
  boundary (measured here: none of the pixels differ);
- ``extract_images_from_tfrecords``: FFHQ and CelebA records written as
  ``tests/test_scripts.py`` writes them, to PNG folders equal to JAX's,
  and to lmdb (JAX's lmdb output imports a ``LmdbMaker`` its
  ``lmdb_util`` lacks: pinned), read back by the JAX package's
  FileClient;
- ``convert_to_npz``: the generic route's ``.npz`` equal in keys and
  arrays to JAX's script's for an MSRResNet; the ``--tsn`` route's equal
  to JAX's ``load_params`` of the same ``.pth`` saved by JAX's
  ``save_npz_params`` (JAX's script calls ``load_params`` without its
  configuration and raises TypeError: pinned), for norms 'bn' and
  'none';
- ``dist_train.sh``: one torchrun process with ``--device cpu`` for one
  iteration of the msrresnet_x4 yml.
"""

import importlib.util
import os
import shutil
import socket
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

from bsvd_tpu_torch.utils.img_util import imfrombytes
from torch_threads import one_torch_thread  # noqa: F401

cv2 = pytest.importorskip('cv2')

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_script(rel):
    name = '_t_jax_' + rel.replace('/', '_')[:-3]
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, 'scripts', rel))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _tree(root):
    """{relative path: pixels (IMREAD_UNCHANGED) or bytes} of a folder."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
            out[os.path.relpath(path, root)] = (
                img if img is not None else open(path, 'rb').read())
    return out


def _same_tree(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, bytes):
            assert got[k] == v, k
        else:
            assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k


@pytest.fixture(scope='module')
def images(tmp_path_factory):
    root = tmp_path_factory.mktemp('sub') / 'src'
    os.makedirs(root)
    rng = np.random.default_rng(0)
    cv2.imwrite(str(root / 'imgx4.png'),
                rng.integers(0, 256, (50, 70, 3), dtype=np.uint8))
    cv2.imwrite(str(root / 'gray.png'),
                rng.integers(0, 256, (41, 37), dtype=np.uint8))
    cv2.imwrite(str(root / 'photo.jpg'),
                rng.integers(0, 256, (33, 40, 3), dtype=np.uint8))
    (root / 'broken.png').write_bytes(b'\x89PNG\r\n\x1a\nnot a png')
    return root


@pytest.mark.parametrize('thresh', [0, 6])
def test_extract_subimages_and_meta_info_equal_jax(images, tmp_path,
                                                   thresh):
    from bsvd_tpu_torch.scripts.data_preparation import (extract_subimages,
                                                         generate_meta_info)
    jex = _jax_script('data_preparation/extract_subimages.py')
    jmi = _jax_script('data_preparation/generate_meta_info.py')
    args = ['--input', str(images), '--crop_size', '16', '--step', '12',
            '--thresh_size', str(thresh), '--n_thread', '2',
            '--compression_level', '5']
    extract_subimages.main(args + ['--output', str(tmp_path / 'port')])
    jex.extract_subimages(str(images), str(tmp_path / 'jax'), 16, 12,
                          thresh, 2, 5)
    got = _tree(tmp_path / 'port')
    _same_tree(got, _tree(tmp_path / 'jax'))
    # 50 x 70 at crop 16 / step 12: rows 0, 12, 24 and 34 (10 pixels
    # left), columns 0-48 and 54 only where 6 pixels left exceed thresh
    assert ('img_s021.png' in got) == (thresh == 0)
    assert 'img_s020.png' in got
    assert 'photo_s001.png' in got and not any('broken' in k for k in got)
    generate_meta_info.main(['--input', str(tmp_path / 'port'),
                             '--meta_info', str(tmp_path / 'port.txt')])
    jmi.generate_meta_info(str(tmp_path / 'port'), str(tmp_path / 'jax.txt'))
    lines = (tmp_path / 'port.txt').read_text()
    assert lines == (tmp_path / 'jax.txt').read_text()
    assert 'gray_s001.png (16,16,1)\n' in lines


def test_regroup_reds_equals_jax(tmp_path):
    from bsvd_tpu_torch.scripts.data_preparation import regroup_reds_dataset
    jrg = _jax_script('data_preparation/regroup_reds_dataset.py')
    for side in ('port', 'jax'):
        os.makedirs(tmp_path / side / 'train' / '000')
        (tmp_path / side / 'train' / '000' / 'a.png').write_bytes(b'0')
        for i in (0, 3):
            os.makedirs(tmp_path / side / 'val' / f'{i:03d}')
            (tmp_path / side / 'val' / f'{i:03d}' / 'f.png').write_bytes(
                bytes([i]))
    regroup_reds_dataset.main(['--train', str(tmp_path / 'port' / 'train'),
                               '--val', str(tmp_path / 'port' / 'val')])
    jrg.regroup_reds_dataset(str(tmp_path / 'jax' / 'train'),
                             str(tmp_path / 'jax' / 'val'))
    got = _tree(tmp_path / 'port' / 'train')
    assert sorted(got) == ['000/a.png', '240/f.png', '243/f.png']
    _same_tree(got, _tree(tmp_path / 'jax' / 'train'))


def _close_uint8(got, want):
    """Within one level, at under 0.1% of the values."""
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3


def test_generate_bicubic_img_equals_jax(tmp_path):
    from bsvd_tpu_torch.scripts.matlab_scripts import generate_bicubic_img
    jgb = _jax_script('matlab_scripts/generate_bicubic_img.py')
    src = tmp_path / 'src'
    os.makedirs(src)
    rng = np.random.default_rng(5)
    cv2.imwrite(str(src / 'pic.png'),
                rng.integers(0, 256, (61, 53, 3), dtype=np.uint8))
    cv2.imwrite(str(src / 'g.png'),
                rng.integers(0, 256, (40, 30), dtype=np.uint8))
    (src / 'readme.txt').write_text('skipped')
    outs = {}
    for side in ('port', 'jax'):
        outs[side] = {k: str(tmp_path / side / k)
                      for k in ('mod', 'lr', 'bic')}
    generate_bicubic_img.main([
        '--input', str(src), '--mod_scale', '12', '--up_scale', '3',
        '--save_mod', outs['port']['mod'], '--save_lr', outs['port']['lr'],
        '--save_bic', outs['port']['bic'], '--device', 'cpu'])
    jgb.process_folder(str(src), 12, 3, outs['jax']['mod'],
                       outs['jax']['lr'], outs['jax']['bic'])
    for k in ('mod', 'lr', 'bic'):
        got, want = _tree(outs['port'][k]), _tree(outs['jax'][k])
        assert sorted(got) == sorted(want) == ['g.png', 'pic.png']
        for name in want:
            _close_uint8(got[name], want[name])
    assert _tree(outs['port']['mod'])['pic.png'].shape == (60, 48, 3)
    assert _tree(outs['port']['lr'])['g.png'].shape == (12, 8)


def test_generate_lr_vimeo90k_equals_jax(tmp_path, monkeypatch):
    from bsvd_tpu_torch.scripts.matlab_scripts import generate_LR_Vimeo90K
    monkeypatch.syspath_prepend(ROOT)
    jlr = _jax_script('matlab_scripts/generate_LR_Vimeo90K.py')
    rng = np.random.default_rng(6)
    for side in ('port', 'jax'):
        for i in (1, 2):
            path = tmp_path / side / 'vimeo_septuplet' / 'sequences' / \
                '00001' / '0001' / f'im{i}.png'
            os.makedirs(path.parent, exist_ok=True)
            cv2.imwrite(str(path), np.random.default_rng(i).integers(
                0, 256, (18, 22, 3), dtype=np.uint8))
    del rng
    generate_LR_Vimeo90K.main(['--root', str(
        tmp_path / 'port' / 'vimeo_septuplet'), '--device', 'cpu'])
    jlr.process_tree(str(tmp_path / 'jax' / 'vimeo_septuplet'))
    got = _tree(tmp_path / 'port' / 'vimeo_septuplet_matlabLRx4')
    want = _tree(tmp_path / 'jax' / 'vimeo_septuplet_matlabLRx4')
    assert sorted(got) == sorted(want) == [
        'sequences/00001/0001/im1.png', 'sequences/00001/0001/im2.png']
    for k in want:
        assert got[k].shape == (4, 5, 3)
        _close_uint8(got[k], want[k])


# ---------------------------------------------------------------------------
# TFRecords, as tests/test_scripts.py writes them
# ---------------------------------------------------------------------------

def _varint(n):
    out = b''
    while True:
        b7 = n & 0x7F
        n >>= 7
        out += bytes([b7 | (0x80 if n else 0)])
        if not n:
            return out


def _pb_field(num, wire, payload):
    key = _varint((num << 3) | wire)
    if wire == 2:
        return key + _varint(len(payload)) + payload
    return key + _varint(payload)


def _tf_example(shape, data, packed=False):
    if packed:
        int64_list = _pb_field(1, 2, b''.join(_varint(v) for v in shape))
    else:
        int64_list = b''.join(_pb_field(1, 0, v) for v in shape)
    floats = _pb_field(1, 2, struct.pack('<2f', 0.5, -1.25))
    entry_s = _pb_field(1, 2, b'shape') + _pb_field(
        2, 2, _pb_field(3, 2, int64_list))
    entry_d = _pb_field(1, 2, b'data') + _pb_field(
        2, 2, _pb_field(1, 2, _pb_field(1, 2, data)))
    entry_f = _pb_field(1, 2, b'scores') + _pb_field(
        2, 2, _pb_field(2, 2, floats))
    features = (_pb_field(1, 2, entry_s) + _pb_field(1, 2, entry_d)
                + _pb_field(1, 2, entry_f))
    return _pb_field(1, 2, features)


def _write_tfrecord(path, payloads):
    with open(path, 'wb') as f:
        for p in payloads:
            f.write(struct.pack('<Q', len(p)) + b'\0\0\0\0' + p + b'\0\0\0\0')


@pytest.mark.parametrize('dataset', ['ffhq', 'celeba'])
def test_extract_images_from_tfrecords_equal_jax(tmp_path, dataset):
    from bsvd_tpu_torch.scripts.data_preparation import \
        extract_images_from_tfrecords as port
    jtf = _jax_script('data_preparation/extract_images_from_tfrecords.py')
    rng = np.random.default_rng(4)
    if dataset == 'ffhq':
        imgs = [rng.integers(0, 256, (3, 8, 8), dtype=np.uint8)
                for _ in range(3)]
        rec = tmp_path / 'ffhq-r03.tfrecords'
        bgr = [im.transpose(1, 2, 0)[:, :, ::-1] for im in imgs]
    else:
        imgs = [rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)
                for _ in range(3)]
        rec = tmp_path / 'validation-r03.tfrecords'
        bgr = [im[:, :, ::-1] for im in imgs]
    _write_tfrecord(str(rec), [_tf_example(list(im.shape), im.tobytes(),
                                           packed=i == 1)
                               for i, im in enumerate(imgs)])
    feats = port.parse_example(_tf_example([3, 8, 8], b'xy'))
    assert feats == jtf.parse_example(_tf_example([3, 8, 8], b'xy'))
    assert feats['scores'] == [0.5, -1.25]
    base = 'ffhq_8' if dataset == 'ffhq' else 'celeba_8_validation'
    port.main(['--dataset', dataset, '--tf_file', str(rec),
               '--log_resolution', '3', '--save_root', str(tmp_path / 'p')])
    jtf.main(['--dataset', dataset, '--tf_file', str(rec),
              '--log_resolution', '3', '--save_root', str(tmp_path / 'j')])
    got = _tree(tmp_path / 'p' / base)
    _same_tree(got, _tree(tmp_path / 'j' / base))
    for i, want in enumerate(bgr):
        assert np.array_equal(got[f'{i:08d}.png'], want)
    port.main(['--dataset', dataset, '--tf_file', str(rec),
               '--log_resolution', '3', '--save_root', str(tmp_path / 'p'),
               '--save_type', 'lmdb', '--compress_level', '2'])
    from bsvd_tpu.utils.file_client import FileClient
    store = str(tmp_path / 'p' / f'{base}.lmdb')
    client = FileClient('lmdb', db_paths=[store], client_keys=['x'])
    for i, want in enumerate(bgr):
        buf = client.get(f'{i:08d}/r03', 'x')
        assert np.array_equal(cv2.imdecode(np.frombuffer(buf, np.uint8),
                                           cv2.IMREAD_COLOR), want)
    assert open(os.path.join(store, 'meta_info.txt')).read() == ''.join(
        f'{i:08d}/r03.png (8,8,3) 2\n' for i in range(3))
    with pytest.raises(ImportError, match='LmdbMaker'):
        jtf.main(['--dataset', dataset, '--tf_file', str(rec),
                  '--log_resolution', '3', '--save_root',
                  str(tmp_path / 'j'), '--save_type', 'lmdb'])


def test_make_ffhq_lmdb_from_imgs(tmp_path):
    from bsvd_tpu_torch.scripts.data_preparation import \
        extract_images_from_tfrecords as port
    rng = np.random.default_rng(8)
    os.makedirs(tmp_path / 'faces')
    imgs = [rng.integers(0, 256, (6, 6, 3), dtype=np.uint8)
            for _ in range(2)]
    for i, img in enumerate(imgs):
        cv2.imwrite(str(tmp_path / 'faces' / f'{i}.png'), img)
    port.make_ffhq_lmdb_from_imgs(str(tmp_path / 'faces'), 2,
                                  str(tmp_path))
    from bsvd_tpu.utils.file_client import FileClient
    client = FileClient('lmdb', db_paths=str(tmp_path /
                                             'ffhq_4_crop1.2.lmdb'))
    for i, img in enumerate(imgs):
        buf = client.get(f'{i:08d}/r02')
        assert np.array_equal(imfrombytes(buf, 'color'), img)


# ---------------------------------------------------------------------------
# convert_to_npz
# ---------------------------------------------------------------------------

def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _same_npz(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(
            got[k], want[k]), k


def test_convert_to_npz_generic_equals_jax(tmp_path, monkeypatch):
    from bsvd_tpu_torch.archs import build_network
    from bsvd_tpu_torch.scripts.model_conversion import convert_to_npz
    arch = {'type': 'MSRResNet', 'num_in_ch': 3, 'num_out_ch': 3,
            'num_feat': 8, 'num_block': 1, 'upscale': 4}
    net = build_network(dict(arch), device='cpu')
    torch.save({'params': net.state_dict()}, str(tmp_path / 'tiny.pth'))
    convert_to_npz.main(['--arch', repr(arch), '--input',
                         str(tmp_path / 'tiny.pth'), '--output',
                         str(tmp_path / 'port.npz')])
    monkeypatch.syspath_prepend(ROOT)
    jcv = _jax_script('model_conversion/convert_to_npz.py')
    monkeypatch.setattr(sys, 'argv', [
        'convert_to_npz.py', '--arch', repr(arch), '--input',
        str(tmp_path / 'tiny.pth'), '--output', str(tmp_path / 'jax.npz')])
    jcv.main()
    got = _npz(tmp_path / 'port.npz')
    _same_npz(got, _npz(tmp_path / 'jax.npz'))
    assert got['params/conv_first/w'].shape == (3, 3, 3, 8)
    with pytest.raises(SystemExit):
        convert_to_npz.main(['--input', 'a.pth', '--output', 'b.npz'])


@pytest.mark.parametrize('norm', ['bn', 'none'])
def test_convert_to_npz_tsn_equals_jax(tmp_path, monkeypatch, norm):
    from bsvd_tpu.convert.torch_ckpt import load_params
    from bsvd_tpu.models.checkpoint import save_npz_params
    from bsvd_tpu_torch.archs import build_network
    from bsvd_tpu_torch.convert.torch_ckpt import to_tsn_state_dict
    from bsvd_tpu_torch.scripts.model_conversion import convert_to_npz
    arch = {'type': 'BSVD', 'chns': [8, 16, 16], 'mid_ch': 8,
            'interm_ch': 8, 'norm': norm, 'seed': 3}
    from bsvd_tpu_torch.archs.wnet_arch import _to_tree
    net = build_network(dict(arch), device='cpu')
    state = to_tsn_state_dict(_to_tree(net.params), net.cfg)
    pth = str(tmp_path / 'tsn.pth')
    torch.save({'params': {f'module.{k}': v for k, v in state.items()}}, pth)
    convert_to_npz.main(['--tsn', '--arch', repr(arch), '--input', pth,
                         '--output', str(tmp_path / 'port.npz')])
    save_npz_params(str(tmp_path / 'jax.npz'),
                    {'params': load_params(pth, _jax_cfg(net.cfg))})
    got = _npz(tmp_path / 'port.npz')
    _same_npz(got, _npz(tmp_path / 'jax.npz'))
    if norm == 'none':
        assert 'params/stage0/inc/n1/__empty_dict__' in got
    monkeypatch.syspath_prepend(ROOT)
    jcv = _jax_script('model_conversion/convert_to_npz.py')
    monkeypatch.setattr(sys, 'argv', ['convert_to_npz.py', '--tsn',
                                      '--input', pth, '--output',
                                      str(tmp_path / 'x.npz')])
    with pytest.raises(TypeError, match='cfg'):
        jcv.main()


def _jax_cfg(cfg):
    import dataclasses
    from bsvd_tpu.archs.wnet_arch import WNetConfig
    fields = {f.name for f in dataclasses.fields(WNetConfig)}
    return WNetConfig(**{k: v for k, v in dataclasses.asdict(cfg).items()
                         if k in fields})


def test_convert_to_npz_tsn_default_arch_is_bsvd_c64():
    from bsvd_tpu_torch.scripts.model_conversion import convert_to_npz
    arch = convert_to_npz.tsn_arch()
    assert arch['type'] == 'BSVD' and 'pretrain_ckpt' not in arch
    assert list(arch['chns']) == [64, 128, 256]


# ---------------------------------------------------------------------------
# dist_train.sh
# ---------------------------------------------------------------------------

def test_dist_train_sh_one_process_on_the_cpu(tmp_path):
    from bsvd_tpu_torch.utils.img_util import imwrite
    rng = np.random.default_rng(1)
    for split in ('train', 'val'):
        for i in range(2):
            gt = rng.integers(0, 256, (48, 48, 3), dtype=np.uint8)
            imwrite(gt, str(tmp_path / split / 'gt' / f'{i}.png'))
            imwrite(gt[::4, ::4].copy(), str(tmp_path / split / 'lq' /
                                             f'{i}.png'))
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        port = sock.getsockname()[1]
    name = f'dist_sh_{os.getpid()}_{port}'
    d = tmp_path
    env = dict(os.environ, PORT=str(port), OMP_NUM_THREADS='1',
               CUDA_VISIBLE_DEVICES='',
               PATH=os.path.dirname(sys.executable) + os.pathsep
               + os.environ.get('PATH', ''))
    cmd = ['bash', os.path.join(ROOT, 'bsvd_tpu_torch', 'scripts',
                                'dist_train.sh'), '1',
           os.path.join(ROOT, 'options', 'train', 'msrresnet_x4.yml'),
           '--device', 'cpu', '--force_yml', f'name={name}',
           f'datasets:train:dataroot_gt={d}/train/gt',
           f'datasets:train:dataroot_lq={d}/train/lq',
           f'datasets:val:dataroot_gt={d}/val/gt',
           f'datasets:val:dataroot_lq={d}/val/lq', 'datasets:train:gt_size=32',
           'datasets:train:batch_size_per_gpu=2',
           'datasets:train:num_worker_per_gpu=1', 'train:total_iter=1',
           'val:val_freq=~', 'logger:print_freq=1',
           'logger:use_tb_logger=false',
           'logger:save_checkpoint_freq=1', 'network_g:num_feat=8',
           'network_g:num_block=1', 'num_gpu=1']
    exp = os.path.join(ROOT, 'experiments', name)
    try:
        res = subprocess.run(cmd, cwd=str(tmp_path), env=env,
                             capture_output=True, text=True, timeout=240)
        assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
        assert sorted(os.listdir(os.path.join(exp, 'models'))) == [
            'net_g_1.npz', 'net_g_latest.npz']
        log = open([os.path.join(exp, f) for f in os.listdir(exp)
                    if f.startswith('train_')][0]).read()
        assert "'dist': True" in log or "dist: True" in log
    finally:
        shutil.rmtree(exp, ignore_errors=True)
