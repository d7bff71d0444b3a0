"""The port's lmdb path against the JAX package's on the CPU (neither
machine has the ``lmdb`` package, so both run on their record logs):

- ``utils/_lmdb_compat``: the same puts in the same order give the same
  ``data.mdb`` bytes in both packages; each reads the other's; readonly
  rules, batched commits, a later put winning, a real LMDB file refused;
- ``utils/lmdb_util.make_lmdb_from_imgs`` and the ``create_lmdb`` script
  against JAX's on one small folder (colour, gray, a JPEG and a nested
  folder): ``meta_info.txt`` byte-equal, the same keys in the same
  order, each value decoding (by the other package too) to the pixels
  cv2's IMREAD_UNCHANGED reads; the PNG bytes themselves differ (zlib's
  and cv2's encoders); the suffix ValueError and the exit on an existing
  folder; ``LmdbMaker``;
- ``FileClient('lmdb')`` on stores of either package, several client
  keys, a missing key; the path readers of ``data_util``;
- ``PairedImageDataset`` (train crops and val), ``SingleImageDataset``,
  ``FFHQDataset``, ``Vimeo90KDataset`` and ``Vimeo90KRecurrentDataset``
  on lmdb, item by item bit-equal to JAX's on one store and seed, and
  the lmdb items equal to the folder items where the frames carry no
  EXIF orientation.
"""

import importlib.util
import os
import struct
import sys

import numpy as np
import pytest

from bsvd_tpu_torch.data import build_dataset, data_util
from bsvd_tpu_torch.utils import _lmdb_compat, lmdb_util
from bsvd_tpu_torch.utils.file_client import FileClient
from bsvd_tpu_torch.utils.img_util import imfrombytes, imwrite
from torch_threads import one_torch_thread  # noqa: F401

cv2 = pytest.importorskip('cv2')
jax_compat = pytest.importorskip('bsvd_tpu.utils._lmdb_compat')

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_jax_script(rel, name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, 'scripts', rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _puts(kv, path, batch):
    env = kv.open(path, map_size=1 << 20)
    txn = env.begin(write=True)
    rng = np.random.default_rng(3)
    items = [(f'k{i % 7}/{i}'.encode(), rng.bytes(int(rng.integers(0, 300))))
             for i in range(11)] + [(b'k0/0', b'later')]
    for i, (k, v) in enumerate(items):
        txn.put(k, v)
        if (i + 1) % batch == 0:
            txn.commit()
            txn = env.begin(write=True)
    txn.commit()
    env.close()
    return dict(items)


@pytest.mark.parametrize('batch', [1, 4, 100])
def test_compat_log_bytes_equal_and_cross_read(tmp_path, batch):
    want = _puts(_lmdb_compat, str(tmp_path / 'port.lmdb'), batch)
    assert _puts(jax_compat, str(tmp_path / 'jax.lmdb'), batch) == want
    port = (tmp_path / 'port.lmdb' / 'data.mdb').read_bytes()
    assert port == (tmp_path / 'jax.lmdb' / 'data.mdb').read_bytes()
    assert port[:8] == b'BSVDKV01' and struct.unpack('<I', port[8:12]) == (4,)
    for reader, store in ((_lmdb_compat, 'jax'), (jax_compat, 'port')):
        env = reader.open(str(tmp_path / f'{store}.lmdb'), readonly=True)
        with env.begin(write=False) as txn:
            assert all(txn.get(k) == v for k, v in want.items())
            assert txn.get(b'k0/0') == b'later' and txn.get(b'no') is None
        assert env.stat() == {'entries': len(want)}
        with pytest.raises(PermissionError):
            env.begin(write=True)


def test_compat_readonly_and_format_rules(tmp_path):
    for kv in (_lmdb_compat, jax_compat):
        missing = tmp_path / f'{kv.__name__}.lmdb'
        with pytest.raises(FileNotFoundError):
            kv.open(str(missing), readonly=True)
        assert not missing.exists()
    real = tmp_path / 'real.lmdb'
    os.makedirs(real)
    # a real LMDB file starts with its meta page, not the log's magic
    (real / 'data.mdb').write_bytes(b'\0' * 16 + struct.pack('<I', 0xBEEFC0DE))
    with pytest.raises(ValueError, match='lmdb package'):
        _lmdb_compat.open(str(real), readonly=True)
    with pytest.raises(ValueError, match='lmdb package'):
        FileClient('lmdb', db_paths=str(real))


@pytest.fixture(scope='module')
def folder(tmp_path_factory):
    """Colour 12 x 10 PNGs, a gray PNG, a JPEG and a nested PNG."""
    root = tmp_path_factory.mktemp('imgs') / 'src'
    os.makedirs(root / 'sub')
    rng = np.random.default_rng(0)
    for i in range(4):
        cv2.imwrite(str(root / f'img_{i:02d}.png'),
                    rng.integers(0, 256, (12, 10, 3), dtype=np.uint8))
    cv2.imwrite(str(root / 'gray.png'),
                rng.integers(0, 256, (9, 7), dtype=np.uint8))
    cv2.imwrite(str(root / 'photo.jpg'),
                rng.integers(0, 256, (16, 16, 3), dtype=np.uint8))
    cv2.imwrite(str(root / 'sub' / 'deep.png'),
                rng.integers(0, 256, (5, 6, 3), dtype=np.uint8))
    return root


def _create(script, folder, out, suffix, monkeypatch):
    monkeypatch.setattr(sys, 'argv', ['create_lmdb', '--input', str(folder),
                                      '--output', str(out), '--suffix',
                                      suffix])
    script.main()


@pytest.mark.parametrize('suffix', ['png', 'jpg'])
def test_create_lmdb_equals_jax(folder, tmp_path, monkeypatch, suffix):
    from bsvd_tpu_torch.scripts.data_preparation import create_lmdb
    jax_script = _load_jax_script('data_preparation/create_lmdb.py',
                                  '_t_jax_create_lmdb')
    port, ref = tmp_path / 'port.lmdb', tmp_path / 'jax.lmdb'
    _create(create_lmdb, folder, port, suffix, monkeypatch)
    _create(jax_script, folder, ref, suffix, monkeypatch)
    meta = (port / 'meta_info.txt').read_text()
    assert meta == (ref / 'meta_info.txt').read_text()
    keys = [line.split('.')[0] for line in meta.splitlines()]
    if suffix == 'png':
        assert keys == ['gray', 'img_00', 'img_01', 'img_02', 'img_03',
                        'sub/deep']
        assert meta.splitlines()[0] == 'gray.png (9,7,1) 1'
    else:
        assert meta == 'photo.png (16,16,3) 1\n'
    from bsvd_tpu.utils.file_client import FileClient as JaxClient
    clients = [FileClient('lmdb', db_paths=[str(port), str(ref)],
                          client_keys=['port', 'jax']),
               JaxClient('lmdb', db_paths=[str(port), str(ref)],
                         client_keys=['port', 'jax'])]
    for key in keys:
        want = cv2.imread(str(folder / f'{key}.{suffix}'),
                          cv2.IMREAD_UNCHANGED)
        for client in clients:
            for store in ('port', 'jax'):
                buf = client.get(key, store)
                np.testing.assert_array_equal(
                    imfrombytes(buf, 'unchanged'), want)
                np.testing.assert_array_equal(cv2.imdecode(
                    np.frombuffer(buf, np.uint8), cv2.IMREAD_UNCHANGED), want)
        assert clients[0].get(key + 'x', 'port') is None
    assert data_util.paths_from_lmdb(str(port)) == keys
    with pytest.raises(SystemExit) as e:
        _create(create_lmdb, folder, port, suffix, monkeypatch)
    assert e.value.code == 1


def test_make_lmdb_batches_and_errors(folder, tmp_path):
    from bsvd_tpu.utils.lmdb_util import make_lmdb_from_imgs as jax_make
    names = [f'img_{i:02d}.png' for i in range(4)]
    keys = [f'a/{i}' for i in range(4)]
    for make, out in ((lmdb_util.make_lmdb_from_imgs, 'port.lmdb'),
                      (jax_make, 'jax.lmdb')):
        make(str(folder), str(tmp_path / out), names, keys, batch=3,
             compress_level=4)
        with pytest.raises(ValueError, match='.lmdb'):
            make(str(folder), str(tmp_path / 'x'), names, keys)
    assert (tmp_path / 'port.lmdb' / 'meta_info.txt').read_text() == \
        (tmp_path / 'jax.lmdb' / 'meta_info.txt').read_text() == \
        ''.join(f'{k}.png (12,10,3) 4\n' for k in keys)
    env = _lmdb_compat.open(str(tmp_path / 'port.lmdb'), readonly=True)
    assert list(env._index) == [k.encode() for k in keys]
    # LmdbMaker: BasicSR's maker, the one the TFRecord extractor uses
    maker = lmdb_util.LmdbMaker(str(tmp_path / 'maker.lmdb'), batch=2)
    img = cv2.imread(str(folder / 'gray.png'), cv2.IMREAD_UNCHANGED)
    for i in range(3):
        maker.put(cv2.imencode('.png', img)[1], f'{i:08d}/r03', (9, 7, 1))
    maker.close()
    assert (tmp_path / 'maker.lmdb' / 'meta_info.txt').read_text() == \
        ''.join(f'{i:08d}/r03.png (9,7,1) 1\n' for i in range(3))
    buf = FileClient('lmdb', db_paths=str(tmp_path / 'maker.lmdb')).get(
        '00000002/r03')
    np.testing.assert_array_equal(imfrombytes(buf, 'unchanged'), img)


# ---------------------------------------------------------------------------
# the datasets on lmdb
# ---------------------------------------------------------------------------

def _store(src, out, names, keys):
    lmdb_util.make_lmdb_from_imgs(str(src), str(out), names, keys)
    return str(out)


@pytest.fixture(scope='module')
def pairs(tmp_path_factory):
    """5 GT of 24 x 20, their LQ at x2 (12 x 10), as folders and stores."""
    root = tmp_path_factory.mktemp('pairs')
    rng = np.random.default_rng(2)
    names = [f'{i:04d}.png' for i in range(5)]
    for name in names:
        gt = rng.integers(0, 256, (24, 20, 3), dtype=np.uint8)
        imwrite(gt, str(root / 'gt' / name))
        imwrite(gt[::2, ::2].copy(), str(root / 'lq' / name))
    keys = [n[:-4] for n in names]
    return {'gt': str(root / 'gt'), 'lq': str(root / 'lq'),
            'gt_lmdb': _store(root / 'gt', root / 'gt.lmdb', names, keys),
            'lq_lmdb': _store(root / 'lq', root / 'lq.lmdb', names, keys)}


def _same_item(got, ref):
    assert set(got) == set(ref)
    for k, v in ref.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
        else:
            assert got[k] == v, k


def _items(ds, order):
    return [ds[i] for i in order]


PAIRED = {'train': {'phase': 'train', 'gt_size': 8},
          'val': {'phase': 'val'}}


@pytest.mark.parametrize('case', sorted(PAIRED))
def test_paired_image_dataset_on_lmdb_equals_jax(pairs, case):
    from bsvd_tpu.data import build_dataset as jbuild
    from bsvd_tpu.data.data_util import paired_paths_from_lmdb as jpaths
    opt = dict(PAIRED[case], name='pairs', type='PairedImageDataset',
               scale=2, dataroot_gt=pairs['gt_lmdb'],
               dataroot_lq=pairs['lq_lmdb'], io_backend={'type': 'lmdb'},
               manual_seed=4)
    got, ref = build_dataset(opt), jbuild(opt)
    assert got.paths == ref.paths == jpaths(
        [pairs['lq_lmdb'], pairs['gt_lmdb']], ['lq', 'gt'])
    order = [0, 3, 3, 1, 4]
    for a, b in zip(_items(got, order), _items(ref, order)):
        _same_item(a, b)
    # the same draws and pixels as from the folders (no EXIF here)
    disk = build_dataset(dict(opt, dataroot_gt=pairs['gt'],
                              dataroot_lq=pairs['lq'],
                              io_backend={'type': 'disk'}))
    for a, b in zip(_items(build_dataset(opt), order), _items(disk, order)):
        assert np.array_equal(a['gt'], b['gt'])
        assert np.array_equal(a['lq'], b['lq'])
    if case == 'train':
        again = build_dataset(opt)
        again.skip(order[0])
        _same_item(again[order[1]], _items(jbuild(opt), order[:2])[1])


def test_lmdb_path_readers_raise_as_jax(pairs, tmp_path):
    from bsvd_tpu.data import data_util as jdu
    for mod in (data_util, jdu):
        with pytest.raises(ValueError, match='lmdb'):
            mod.paired_paths_from_lmdb([pairs['lq'], pairs['gt_lmdb']],
                                       ['lq', 'gt'])
        with pytest.raises(ValueError, match='lmdb format'):
            mod.paths_from_lmdb(pairs['gt'])
    odd = tmp_path / 'odd.lmdb'
    os.makedirs(odd)
    (odd / 'meta_info.txt').write_text('0000.png (12,10,3) 1\n')
    for mod in (data_util, jdu):
        with pytest.raises(ValueError, match='differ'):
            mod.paired_paths_from_lmdb([str(odd), pairs['gt_lmdb']],
                                       ['lq', 'gt'])


@pytest.mark.parametrize('kind', ['SingleImageDataset', 'FFHQDataset'])
def test_single_image_datasets_on_lmdb_equal_jax(pairs, kind):
    from bsvd_tpu.data import build_dataset as jbuild
    opt = {'name': 'single', 'type': kind, 'dataroot_lq': pairs['lq_lmdb'],
           'dataroot_gt': pairs['gt_lmdb'], 'io_backend': {'type': 'lmdb'},
           'manual_seed': 9, 'mean': [0.5, 0.4, 0.3], 'std': [0.2, 0.3, 0.4]}
    got, ref = build_dataset(opt), jbuild(opt)
    assert got.paths == ref.paths == ['0000', '0001', '0002', '0003', '0004']
    for a, b in zip(_items(got, [4, 0, 2, 2]), _items(ref, [4, 0, 2, 2])):
        _same_item(a, b)


@pytest.fixture(scope='module')
def vimeo(tmp_path_factory):
    """GT/LQ septuplet trees (16 x 16 GT, 4 x 4 LQ) of 2 sequences, their
    stores as create_lmdb makes them, and a meta-info file."""
    root = tmp_path_factory.mktemp('vimeo')
    rng = np.random.default_rng(5)
    keys = ['00001/0001', '00002/0007']
    names = []
    for key in keys:
        for i in range(1, 8):
            gt = rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)
            imwrite(gt, str(root / 'gt' / key / f'im{i}.png'))
            imwrite(gt[::4, ::4].copy(), str(root / 'lq' / key / f'im{i}.png'))
            names.append(f'{key}/im{i}.png')
    (root / 'meta.txt').write_text(''.join(f'{k} (16,16,3)\n' for k in keys))
    lmdb_keys = [n[:-4] for n in names]
    return {'gt': str(root / 'gt'), 'lq': str(root / 'lq'),
            'meta': str(root / 'meta.txt'),
            'gt_lmdb': _store(root / 'gt', root / 'gt.lmdb', names,
                              lmdb_keys),
            'lq_lmdb': _store(root / 'lq', root / 'lq.lmdb', names,
                              lmdb_keys)}


@pytest.mark.parametrize('kind', ['Vimeo90KDataset',
                                  'Vimeo90KRecurrentDataset'])
def test_vimeo90k_on_lmdb_equals_jax_and_folders(vimeo, kind):
    from bsvd_tpu.data import build_dataset as jbuild
    opt = {'name': 'vimeo', 'type': kind, 'num_frame': 5,
           'random_reverse': True, 'dataroot_gt': vimeo['gt_lmdb'],
           'dataroot_lq': vimeo['lq_lmdb'], 'meta_info_file': vimeo['meta'],
           'io_backend': {'type': 'lmdb'}, 'gt_size': 8, 'scale': 4,
           'manual_seed': 6, 'phase': 'train'}
    order = [1, 0, 1, 1]
    got = _items(build_dataset(opt), order)
    for a, b in zip(got, _items(jbuild(opt), order)):
        _same_item(a, b)
    disk = _items(build_dataset(dict(opt, dataroot_gt=vimeo['gt'],
                                     dataroot_lq=vimeo['lq'],
                                     io_backend={'type': 'disk'})), order)
    for a, b in zip(got, disk):
        _same_item(a, b)
    again = build_dataset(opt)
    again.skip(order[0])
    _same_item(again[order[1]], got[1])
