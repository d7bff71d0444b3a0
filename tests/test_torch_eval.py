"""The port's evaluation path on CPU against the JAX package: metrics
(PSNR / SSIM / float PSNR), tensor2img, the PNG and JPEG writers, frame
reading (the zlib PNG reader, the standard-C++ JPEG decoder,
open_sequence, ValFolderDataset), DenoisingModel's padding / test / validation,
test_pipeline from an option file and validation during training.

Tolerances: host arithmetic that is the same numpy on both sides is equal
bit for bit (tensor2img, frames, noise, padding); PSNR within 1e-10 dB and
SSIM within 1e-8 (SSIM sums its window in another order than cv2's
filter2D); network outputs 1e-4 (fp32 summation order); the pipelines'
psnr_float within 1e-3 dB, psnr and ssim within 0.02 (a pixel of fp32
output within 1e-6 of a .5 boundary may round the other way in uint8).
"""

import copy
import csv
import glob
import os
import sys

import numpy as np
import pytest
import torch

from bsvd_tpu_torch.convert.torch_ckpt import (from_jax_params,
                                               load_tsn_state_dict)
from bsvd_tpu_torch.data import build_dataset
from bsvd_tpu_torch.data import jpeg_decode, png_decode
from bsvd_tpu_torch.data.utils_common import open_sequence
from bsvd_tpu_torch.metrics import calculate_metric
from bsvd_tpu_torch.metrics.psnr_ssim import (calculate_psnr,
                                              calculate_psnr_float,
                                              calculate_ssim)
from bsvd_tpu_torch.models.denoising_model import DenoisingModel
from bsvd_tpu_torch.utils.img_util import imwrite, tensor2img

from golden_util import golden
from reference_util import SMALL_NET2D_OPT
from torch_threads import one_torch_thread  # noqa: F401

jax = pytest.importorskip('jax')
jnp = pytest.importorskip('jax.numpy')
cv2 = pytest.importorskip('cv2')
yaml = pytest.importorskip('yaml')

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'tools'))

NET = {'type': 'BSVD', 'chns': [16, 32, 64], 'mid_ch': 16,
       'shift_input': False, 'norm': 'none', 'interm_ch': 16,
       'act': 'relu6', 'pretrain_ckpt': None}
METRICS = {
    'psnr': {'type': 'calculate_psnr', 'crop_border': 2,
             'test_y_channel': False},
    'psnr_float': {'type': 'calculate_psnr_float', 'crop_border': 2,
                   'test_y_channel': False},
    'ssim': {'type': 'calculate_ssim', 'crop_border': 2,
             'test_y_channel': False}}
TOL_UINT8 = {'psnr': 0.02, 'psnr_float': 1e-3, 'ssim': 0.02}


@pytest.fixture(scope='module')
def synth_data(tmp_path_factory):
    from make_synth_dataset import main as make_ds
    root = tmp_path_factory.mktemp('synthset')
    make_ds(str(root), num_clips=2, t=8, h=48, w=48, seed=0)
    return str(root)


# ---------------------------------------------------------------------------
# metrics and images
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('crop,y', [(0, False), (2, False), (0, True),
                                    (2, True)])
def test_metrics_match_jax(crop, y):
    from bsvd_tpu.metrics import psnr_ssim as jm
    rng = np.random.default_rng(crop + 3 * y)
    a = rng.integers(0, 256, (40, 36, 3), dtype=np.uint8)
    b = np.clip(a + rng.normal(0, 12, a.shape), 0, 255).astype(np.uint8)
    kw = dict(crop_border=crop, test_y_channel=y)
    assert abs(calculate_psnr(a, b, **kw) - jm.calculate_psnr(a, b, **kw)) \
        < 1e-10
    assert abs(calculate_ssim(a, b, **kw) - jm.calculate_ssim(a, b, **kw)) \
        < 1e-8
    fa = rng.uniform(0, 1, (3, 40, 36)).astype(np.float32)
    fb = np.clip(fa + rng.normal(0, 0.05, fa.shape), 0, 1).astype(np.float32)
    assert abs(calculate_psnr_float(fa, fb, **kw)
               - jm.calculate_psnr_float(fa, fb, **kw)) < 1e-10
    got = calculate_metric({'img': a, 'img2': b},
                           dict(type='calculate_ssim', **kw))
    assert got == calculate_ssim(a, b, **kw)


def test_identical_images_give_infinite_psnr():
    a = np.full((16, 16, 3), 7, np.uint8)
    assert calculate_psnr(a, a, crop_border=0) == float('inf')
    assert calculate_ssim(a, a, crop_border=0) == pytest.approx(1.0)


def test_tensor2img_matches_jax_on_half_ties():
    """Round half to even, as the JAX package (numpy's round): the values
    whose x255 lands exactly on .5 are kept and checked on both sides."""
    from bsvd_tpu.utils.img_util import tensor2img as jax_tensor2img
    k = np.arange(255)
    cand = ((k + 0.5) / 255).astype(np.float32)
    ties = cand[cand * np.float32(255.0) == k + 0.5]
    assert ties.size > 20
    rng = np.random.default_rng(0)
    img = np.concatenate([ties, rng.uniform(-0.2, 1.2, 3 * 16 * 16 -
                                            ties.size)]).astype(np.float32)
    img = img.reshape(3, 16, 16)
    got = tensor2img(img)
    np.testing.assert_array_equal(got, jax_tensor2img(img))
    assert got.dtype == np.uint8 and got.shape == (16, 16, 3)
    flat = np.transpose(got[..., ::-1], (2, 0, 1)).reshape(-1)[:ties.size]
    np.testing.assert_array_equal(flat, np.round(ties * np.float32(255.0)))
    assert set(flat % 2) == {0}                    # every tie went to even
    np.testing.assert_array_equal(tensor2img(img[0]), jax_tensor2img(img[0]))


@pytest.mark.parametrize('shape', [(23, 31, 3), (17, 9)])
def test_png_writer_round_trips_through_cv2(tmp_path, shape):
    img = np.random.default_rng(1).integers(0, 256, shape, dtype=np.uint8)
    path = str(tmp_path / 'a' / 'b' / 'f.png')
    imwrite(img, path)
    flag = cv2.IMREAD_UNCHANGED
    np.testing.assert_array_equal(cv2.imread(path, flag), img)


def test_png_writer_refuses_other_formats(tmp_path):
    """imwrite writes PNG, JPEG and TIFF by the extension (the JPEG read
    back by cv2 as cv2's own file at quality 95, 4:2:0); other formats,
    float images and flags the format does not read raise ValueError."""
    img = np.random.default_rng(2).integers(0, 256, (12, 20, 3),
                                            dtype=np.uint8)
    imwrite(img, str(tmp_path / 'f.jpg'))
    _, ref = cv2.imencode('.jpg', img)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / 'f.jpg')),
                                  cv2.imdecode(ref, cv2.IMREAD_COLOR))
    for name in ('f.bmp', 'f.gif', 'f'):
        with pytest.raises(ValueError, match='PNG, JPEG and TIFF only'):
            imwrite(img, str(tmp_path / name))
    for name in ('f.png', 'f.jpg'):
        with pytest.raises(ValueError, match='uint8'):
            imwrite(img.astype(np.float32), str(tmp_path / name))
    with pytest.raises(ValueError, match='flag 1 '):
        imwrite(img, str(tmp_path / 'f.png'), [1, 90])
    with pytest.raises(ValueError, match='flag 2 '):
        imwrite(img, str(tmp_path / 'f.jpg'), [2, 1])


# ---------------------------------------------------------------------------
# frames
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('fmt', ['png', 'jpg'])
def test_native_decoder_matches_cv2_and_jax(tmp_path, fmt):
    """Each frame's reader (PNG: the zlib reader; JPEG: the standard-C++
    decoder) reads what cv2 reads, and open_sequence equals the JAX
    package's bit for bit."""
    from make_synth_dataset import main as make_ds
    from bsvd_tpu.data.utils_common import open_sequence as jax_open
    make_ds(str(tmp_path), num_clips=1, t=5, h=40, w=56, seed=3, fmt=fmt)
    folder = str(tmp_path / 'clip00')
    paths = sorted(glob.glob(os.path.join(folder, f'*.{fmt}')))
    seq = (png_decode if fmt == 'png' else jpeg_decode).load_seq(paths)
    assert seq.shape == (5, 40, 56, 3) and seq.dtype == np.uint8
    for i, p in enumerate(paths):
        np.testing.assert_array_equal(
            seq[i], cv2.cvtColor(cv2.imread(p), cv2.COLOR_BGR2RGB))
    got, eh, ew = open_sequence(folder, max_num_fr=4)
    ref, _, _ = jax_open(folder, max_num_fr=4)
    assert got.dtype == np.float32 and got.shape == (4, 3, 40, 56)
    assert (eh, ew) == (False, False)
    np.testing.assert_array_equal(got, ref)


def test_open_sequence_orders_by_digits_and_refuses_gray(tmp_path):
    """Frames in the order of the digits in their names (10 after 9), as
    the JAX package reads them; gray frames (cv2's IMREAD_GRAYSCALE) equal
    JAX's too, with and without the odd-size expansion; an empty folder
    raises."""
    from bsvd_tpu.data.utils_common import open_sequence as jax_open
    rng = np.random.default_rng(4)
    frames = rng.integers(0, 256, (11, 21, 33, 3), dtype=np.uint8)
    for i, f in enumerate(frames):
        imwrite(f, str(tmp_path / 'clip' / f'f{i}.png'))
    got, _, _ = open_sequence(str(tmp_path / 'clip'))
    np.testing.assert_array_equal(got, jax_open(str(tmp_path / 'clip'))[0])
    np.testing.assert_array_equal(
        got, np.transpose(frames[..., ::-1], (0, 3, 1, 2)) / np.float32(255))
    for expand in (False, True):
        got = open_sequence(str(tmp_path / 'clip'), gray_mode=True,
                            expand_if_needed=expand)
        ref = jax_open(str(tmp_path / 'clip'), gray_mode=True,
                       expand_if_needed=expand)
        assert got[1:] == ref[1:] == (expand, expand)
        assert got[0].dtype == ref[0].dtype and got[0].shape == (
            11, 1, 21 + expand, 33 + expand)
        np.testing.assert_array_equal(got[0], ref[0])
    with pytest.raises(IOError):
        open_sequence(str(tmp_path))


def test_native_decoder_build_failure_raises_with_compiler_output(
        tmp_path, monkeypatch):
    bad = tmp_path / 'jpeg_decode.cpp'
    bad.write_text('this is not C++\n')
    monkeypatch.setattr(jpeg_decode, 'SOURCE', bad)
    monkeypatch.setattr(jpeg_decode, '_PKG', tmp_path)
    with pytest.raises(RuntimeError, match='error'):
        jpeg_decode.build()
    with pytest.raises(IOError):
        jpeg_decode.image_dims(str(tmp_path / 'missing.jpg'))


@pytest.mark.parametrize('blind', [False, True])
def test_val_folder_dataset_matches_jax(synth_data, blind):
    from bsvd_tpu.data import build_dataset as jax_build
    opt = {'name': 's', 'type': 'ValFolderDataset', 'valsetdir': synth_data,
           'num_validation_frames': 6, 'valnoisestd': 20, 'manual_seed': 7,
           'blind': blind}
    ds, jds = build_dataset(opt), jax_build(opt)
    assert len(ds) == len(jds) == 2
    assert ds.base_folder == jds.base_folder
    assert ds.num_frames == jds.num_frames == [6, 6]
    for i in range(2):
        a, b = ds[i], jds[i]
        assert sorted(a) == sorted(b)
        assert a['folder'] == b['folder'] and a['index'] == b['index'] == i
        for k in ('lq', 'gt', 'noise_map'):
            if k in b:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
    assert len(build_dataset(dict(opt, scene_name='clip01'))) == 1


# ---------------------------------------------------------------------------
# DenoisingModel: padding, test
# ---------------------------------------------------------------------------

def _model_opt(val, **extra):
    return dict({'is_train': False, 'model_type': 'DenoisingModel',
                 'num_gpu': 1, 'name': 'eval', 'network_g': dict(NET),
                 'path': {'pretrain_network_g': None}, 'val': val}, **extra)


def _models(val, seed=30):
    from bsvd_tpu.archs.wnet_arch import wnet_init
    from bsvd_tpu.models import build_model as jax_build_model
    jm = jax_build_model(_model_opt(val))
    jparams = wnet_init(jax.random.PRNGKey(seed), jm.cfg)
    jm.params = jm.net.params = jparams
    pm = DenoisingModel(_model_opt(val), device='cpu')
    pm.net.load_params(from_jax_params(jax.tree.map(np.asarray, jparams),
                                       pm.cfg))
    return jm, pm


def test_padding_and_cropping_match_jax():
    jm, pm = _models({'temp_psz': -1})
    seq = np.random.default_rng(2).uniform(0, 1, (3, 3, 37, 50)).astype(
        np.float32)
    got, pads = pm.padding_input(torch.from_numpy(seq))
    ref, jpads = jm.padding_input(seq)
    assert pads == jpads == [0, 14, 0, 11, 0, 0]
    assert got.shape == (3, 3, 48, 64)
    np.testing.assert_array_equal(got.numpy(), ref)
    pm.output = got.numpy()[None]
    pm.crop_output(pads)
    np.testing.assert_array_equal(pm.output[0], seq)


@pytest.mark.parametrize('psz,future', [(-1, 0), (4, 2)])
def test_model_test_matches_jax(psz, future):
    val = {'temp_psz': psz, 'future_buffer_len': future, 'fp16': False}
    jm, pm = _models(val)
    rng = np.random.default_rng(3)
    item = {'lq': rng.uniform(0, 1, (1, 9, 3, 37, 50)).astype(np.float32),
            'noise_map': np.full((1, 9, 1, 37, 50), 25 / 255, np.float32)}
    jm.feed_data(item)
    jm.test()
    pm.feed_data(item)
    pm.test()
    assert pm.output.shape == (1, 9, 3, 37, 50)
    np.testing.assert_allclose(pm.output, jm.output, rtol=1e-4, atol=1e-4)


def test_model_test_bf16_and_streaming_eval_run():
    """val.fp16 runs bf16 (within bf16's reach of fp32), streaming_eval the
    frame-by-frame path (equal to MIMO in fp32)."""
    rng = np.random.default_rng(4)
    item = {'lq': rng.uniform(0, 1, (1, 5, 3, 16, 16)).astype(np.float32),
            'noise_map': np.full((1, 5, 1, 16, 16), 0.1, np.float32)}
    outs = {}
    for key, val in (('fp32', {}), ('bf16', {'fp16': True}),
                     ('stream', {'streaming_eval': True})):
        _, pm = _models(val)
        pm.feed_data(item)
        pm.test()
        outs[key] = pm.output
    np.testing.assert_allclose(outs['stream'], outs['fp32'], rtol=1e-4,
                               atol=1e-4)
    err = np.abs(outs['bf16'] - outs['fp32']).max()
    assert 0 < err < 0.1, err


def test_reference_ema_branch_matches_pinned_output():
    """``val.reference_ema_branch`` with an EMA: one plain forward of the
    EMA parameters on the unpadded input, no clamp (ema_eval_branch.npz,
    see test_arch_parity.test_reference_ema_branch_exact)."""
    from bsvd_tpu.archs.wnet_arch import WNetConfig as JaxConfig
    from bsvd_tpu.archs.wnet_arch import wnet_init
    from bsvd_tpu.convert.torch_ckpt import params_to_tsn_state_dict
    opt2d = dict(SMALL_NET2D_OPT)
    kw = {k: opt2d[k] for k in ('chns', 'mid_ch', 'interm_ch', 'norm',
                                'act')}
    jcfg = JaxConfig(**dict(kw, chns=tuple(kw['chns'])))
    state = params_to_tsn_state_dict(wnet_init(jax.random.PRNGKey(14), jcfg),
                                     jcfg)
    rng = np.random.default_rng(7)
    t, h, w = 6, 16, 16
    lq = rng.uniform(0, 1, (1, t, 3, h, w)).astype(np.float32)
    sigma = 30 / 255.0
    ref = golden('ema_eval_branch', lambda: pytest.skip('fixture missing'))
    opt = _model_opt({'reference_ema_branch': True, 'temp_psz': -1,
                      'fp16': False})
    opt['network_g'] = dict(type='BSVD', pretrain_ckpt=None, **kw)
    pm = DenoisingModel(opt, device='cpu')
    pm.ema_params = load_tsn_state_dict(state, pm.cfg)
    pm.feed_data({'lq': lq, 'noise_map': np.full((1, t, 1, h, w), sigma,
                                                 np.float32)})
    pm.test()
    np.testing.assert_allclose(pm.output, ref['ref_out'], rtol=1e-4,
                               atol=1e-4)
    assert (pm.output < 0).any() or (pm.output > 1).any()   # no clamp


# ---------------------------------------------------------------------------
# test_pipeline, CSVs, validation without metrics
# ---------------------------------------------------------------------------

def _pipeline_opts(synth_data, root, ckpt, **val_over):
    """The JAX package's options (tests/test_eval_pipeline.py's) as a YAML
    under ``root``, and what its parse_options makes of them."""
    from bsvd_tpu.utils.options import parse_options
    opt = {
        'name': 'smoke_eval', 'model_type': 'DenoisingModel', 'num_gpu': 1,
        'manual_seed': 10,
        'datasets': {'val_1': {'name': 'synth_20', 'type': 'ValFolderDataset',
                               'valsetdir': synth_data,
                               'num_validation_frames': 8,
                               'valnoisestd': 20}},
        'network_g': dict(NET),
        'path': {'pretrain_network_g': ckpt, 'strict_load_g': True,
                 'resume_state': None},
        'val': dict({'save_img': True, 'temp_psz': -1,
                     'future_buffer_len': 0, 'fp16': False,
                     'metrics': copy.deepcopy(METRICS)}, **val_over),
        'logger': {'print_freq': 100, 'save_checkpoint_freq': 5000,
                   'use_tb_logger': False}}
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, 'opt.yml')
    with open(path, 'w') as f:
        yaml.safe_dump(opt, f)
    parsed, _ = parse_options(root, is_train=False, opt_path=path)
    return path, parsed


def _shared_ckpt(tmp_path, cfg_net=NET, seed=31):
    """One .npz checkpoint both packages load (path.pretrain_network_g)."""
    from bsvd_tpu.archs.wnet_arch import WNetConfig as JaxConfig
    from bsvd_tpu.archs.wnet_arch import wnet_init
    from bsvd_tpu.models.checkpoint import save_npz_params
    cfg = JaxConfig(chns=tuple(cfg_net['chns']), mid_ch=cfg_net['mid_ch'],
                    interm_ch=cfg_net['interm_ch'], norm='none',
                    act=cfg_net['act'])
    path = str(tmp_path / 'net_g.npz')
    save_npz_params(path, {'params': wnet_init(jax.random.PRNGKey(seed),
                                               cfg)})
    return path


def _read_csv(path):
    with open(path, newline='') as f:
        rows = list(csv.reader(f))
    return rows[0], np.array([[float(v) for v in r[1:]] for r in rows[1:]])


@pytest.mark.parametrize('psz,future', [(-1, 0), (4, 2)])
def test_test_pipeline_matches_jax(synth_data, tmp_path, psz, future):
    from bsvd_tpu.test import test_pipeline as jax_test_pipeline
    from bsvd_tpu_torch.test import test_pipeline
    ckpt = _shared_ckpt(tmp_path)
    jpath, _ = _pipeline_opts(synth_data, str(tmp_path / 'jax'), ckpt,
                              temp_psz=psz, future_buffer_len=future)
    ppath, _ = _pipeline_opts(synth_data, str(tmp_path / 'port'), ckpt,
                              temp_psz=psz, future_buffer_len=future)
    ref = jax_test_pipeline(str(tmp_path / 'jax'), opt_path=jpath)
    got = test_pipeline(str(tmp_path / 'port'), cmd=['-opt', ppath,
                                                     '--device', 'cpu'])
    assert set(got) == {'synth_20'} and set(got['synth_20']) == set(METRICS)
    for m, tol in TOL_UINT8.items():
        assert abs(got['synth_20'][m] - ref['synth_20'][m]) < tol, m
    jroot = tmp_path / 'jax' / 'results' / 'smoke_eval'
    root = tmp_path / 'port' / 'results' / 'smoke_eval'
    assert sorted(p.name for p in root.glob('*.csv')) == \
        sorted(p.name for p in jroot.glob('*.csv')) == \
        ['synth_20_clip00.csv', 'synth_20_clip01.csv']
    for p in root.glob('*.csv'):
        head, vals = _read_csv(p)
        jhead, jvals = _read_csv(jroot / p.name)
        assert head == jhead == ['', f'{p.stem[9:]}_0', f'{p.stem[9:]}_1',
                                 f'{p.stem[9:]}_2']
        assert vals.shape == jvals.shape == (8, 3)
        for m, tol in enumerate(TOL_UINT8.values()):
            np.testing.assert_allclose(vals[:, m], jvals[:, m], rtol=0,
                                       atol=tol)
    pngs = sorted(str(p.relative_to(root)) for p in root.rglob('*.png'))
    assert pngs == sorted(str(p.relative_to(jroot))
                          for p in jroot.rglob('*.png'))
    assert len(pngs) == 16 and len(list(root.glob('test_*.log'))) == 1


def test_test_pipeline_reads_yaml_options(synth_data, tmp_path):
    """The option file read by the port's own YAML reader (``opt_path``,
    the device by argument), and center_frame_only scoring one frame a
    clip."""
    from bsvd_tpu_torch.test import test_pipeline
    path, _ = _pipeline_opts(synth_data, str(tmp_path),
                             _shared_ckpt(tmp_path), save_img=False)
    with open(path, 'a') as f:
        f.write('center_frame_only: true\n')
    res = test_pipeline(str(tmp_path), opt_path=path,
                        device='cpu')['synth_20']
    assert all(np.isfinite(v) for v in res.values()) and res['psnr'] > 3
    root = tmp_path / 'results' / 'smoke_eval'
    assert _read_csv(root / 'synth_20_clip00.csv')[1].shape == (1, 3)
    assert not list(root.rglob('*.png'))


def test_validation_without_metrics(synth_data, tmp_path):
    """The train yml's ``val`` names no metrics. The JAX package then
    raises in _log_validation_metric_values (it reads metric_results,
    never set); the port denoises and saves every clip and logs no metric,
    as BasicSR does. Both behaviours pinned."""
    from bsvd_tpu.data import build_dataloader as jax_loader
    from bsvd_tpu.data import build_dataset as jax_dataset
    from bsvd_tpu_torch.data import build_dataloader
    ds_opt = {'name': 'synth', 'type': 'ValFolderDataset',
              'valsetdir': synth_data, 'num_validation_frames': 4,
              'valnoisestd': 20, 'phase': 'val'}
    val = {'temp_psz': 2, 'future_buffer_len': 1, 'fp16': False}
    path = {'log': str(tmp_path), 'visualization': str(tmp_path / 'vis')}
    jm, pm = _models(val)
    jm.opt['path'].update(path)
    pm.opt['path'].update(path)
    with pytest.raises(AttributeError, match='metric_results'):
        jm.validation(jax_loader(jax_dataset(ds_opt), ds_opt), 1, None)
    got = pm.validation(build_dataloader(build_dataset(ds_opt), ds_opt), 1,
                        None, save_img=True)
    assert got is None
    assert len(list((tmp_path / 'vis').rglob('*.png'))) == 8
    assert not list(tmp_path.glob('*.csv'))
    assert set(pm.val_seconds) == {'read', 'denoise', 'metrics', 'save'}


def test_train_pipeline_validates_at_val_freq_and_at_the_end(synth_data,
                                                              tmp_path,
                                                              monkeypatch):
    from bsvd_tpu_torch.data.video_train_loader import SyntheticVideoLoader
    from bsvd_tpu_torch.train import train_loop
    calls = []
    orig = DenoisingModel.validation

    def spy(self, loader, current_iter, tb_logger, save_img=False):
        calls.append(current_iter)
        res = orig(self, loader, current_iter, tb_logger, save_img)
        assert set(res) == {'psnr'} and np.isfinite(res['psnr'])
        return res

    monkeypatch.setattr(DenoisingModel, 'validation', spy)
    opt = {
        'name': 'val_train', 'model_type': 'DenoisingModel', 'num_gpu': 1,
        'manual_seed': 10,
        'network_g': {'type': 'TSN', 'num_segments': 3,
                      'base_model': 'WNet_multistage', 'shift_type': 'TSM',
                      'shift_div': 8, 'net2d_opt': {
                          k: NET[k] for k in ('chns', 'mid_ch', 'norm',
                                              'interm_ch', 'act')}},
        'datasets': {'train': {'name': 'unused'},
                     'val_1': {'name': 'synth', 'type': 'ValFolderDataset',
                               'valsetdir': synth_data,
                               'num_validation_frames': 4,
                               'valnoisestd': 20}},
        'path': {'strict_load_g': True, 'models': str(tmp_path / 'm'),
                 'training_states': str(tmp_path / 's'),
                 'log': str(tmp_path), 'visualization': str(tmp_path / 'v')},
        'train': {'optim_g': {'type': 'Adam', 'lr': 1e-3},
                  'scheduler': {'type': 'MultiStepLR', 'milestones': [10],
                                'gamma': 0.5},
                  'total_iter': 4, 'warmup_iter': -1, 'ema_decay': 0.9,
                  'pixel_opt': {'type': 'MSELoss', 'loss_weight': 1.0,
                                'reduction': 'mean'}},
        'val': {'val_freq': 2, 'save_img': False, 'temp_psz': 2,
                'future_buffer_len': 1, 'fp16': False,
                'metrics': {'psnr': dict(METRICS['psnr'])}},
        'logger': {'print_freq': 100, 'save_checkpoint_freq': 100}}
    loader = SyntheticVideoLoader(
        {'batch_size_per_gpu': 1, 'temp_patch_size': 3, 'patch_size': 16,
         'noise_ival': [5, 55], 'noise_shape': 'N', 'manual_seed': 3},
        epoch_size=3)
    model = train_loop(opt, loader, device='cpu')
    assert calls == [2, 4, 4]
    assert model.current_iter == 4
    assert sorted(p.name for p in tmp_path.glob('*.csv')) == [
        'synth_clip00.csv', 'synth_clip01.csv']
