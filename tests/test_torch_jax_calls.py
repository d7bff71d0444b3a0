"""The calls the JAX package's own code makes into its data and utils API,
made on the port with the same arguments (bsvd_tpu/train.py:27, :45, :86,
:114;
bsvd_tpu/test.py:18, :29; bsvd_tpu/data/val_folder_dataset.py:47-49;
bsvd_tpu/data/video_test_dataset.py:42-43; bsvd_tpu/models/
denoising_model.py's tensor2img / imwrite / print_network /
save_training_state / get_current_visuals), and the other parameters of
those functions. Where both packages return data, the port's equals the
JAX package's on CPU.

Tolerances: none for frames, images, loaders and training states (the same
integer decodes and numpy arithmetic); network outputs 1e-4 (fp32
summation order); bf16 streams 2^-6 x max(1, max|ref|) (every value is
rounded to bf16, 2^-8 relative, and the net compounds it over its layers).
"""

import logging

import numpy as np
import pytest
import torch

from bsvd_tpu_torch.data import build_dataloader, build_dataset
from bsvd_tpu_torch.data.utils_common import open_image, open_sequence
from bsvd_tpu_torch.utils.img_util import imwrite, tensor2img
from bsvd_tpu_torch.utils.logger import get_root_logger

cv2 = pytest.importorskip('cv2')
jax = pytest.importorskip('jax')
jnp = pytest.importorskip('jax.numpy')

NET = {'type': 'BSVD', 'chns': [8, 16, 32], 'mid_ch': 8,
       'shift_input': False, 'norm': 'none', 'interm_ch': 8,
       'act': 'relu6', 'pretrain_ckpt': None}


@pytest.fixture(scope='module')
def folders(tmp_path_factory):
    """Two clips of 3 frames (a 3-frame clip is what JAX's ``seq, _, _ =
    open_sequence(...)`` splits if the call returns the bare array), as
    PNG and as JPEG, at an odd size."""
    root = tmp_path_factory.mktemp('jax_calls')
    rng = np.random.default_rng(40)
    for ext in ('png', 'jpg'):
        for c in range(2):
            folder = root / ext / f'clip{c}'
            folder.mkdir(parents=True)
            for k in range(3):
                f = rng.integers(0, 256, (21, 31, 3), dtype=np.uint8)
                cv2.imwrite(str(folder / f'{k:03d}.{ext}'), f)
    return root


def _val_opt(folder):
    return {'name': 'calls', 'type': 'ValFolderDataset', 'phase': 'val',
            'valsetdir': str(folder), 'num_validation_frames': 3,
            'valnoisestd': 20, 'manual_seed': 10}


def _eq_tuple(got, ref):
    assert len(got) == len(ref) == 3
    assert tuple(got[1:]) == tuple(ref[1:])
    assert got[0].dtype == ref[0].dtype and got[0].shape == ref[0].shape
    np.testing.assert_array_equal(got[0], ref[0])


@pytest.mark.parametrize('ext', ['png', 'jpg'])
@pytest.mark.parametrize('site', ['val_folder_dataset', 'video_test_dataset',
                                  'expand'])
def test_open_sequence_returns_jaxs_tuple(folders, ext, site):
    from bsvd_tpu.data.utils_common import open_sequence as jax_open
    d = str(folders / ext / 'clip0')
    if site == 'val_folder_dataset':        # val_folder_dataset.py:47-49
        args, kw = (d, False), {'expand_if_needed': False, 'max_num_fr': 3}
    elif site == 'video_test_dataset':      # video_test_dataset.py:42-43
        args, kw = (d,), {'max_num_fr': 10**6}
    else:
        args, kw = (d, False, True, 2), {}
    seq, _, _ = open_sequence(*args, **kw)
    assert seq.shape[0] == (2 if site == 'expand' else 3)
    _eq_tuple(open_sequence(*args, **kw), jax_open(*args, **kw))


@pytest.mark.parametrize('kw', [{}, {'normalize_data': False},
                                {'expand_if_needed': True},
                                {'expand_if_needed': True,
                                 'normalize_data': False}],
                         ids=['default', 'uint8', 'expand', 'expand_uint8'])
def test_open_image_equals_jax(folders, kw):
    from bsvd_tpu.data.utils_common import open_image as jax_open_image
    for ext in ('png', 'jpg'):
        path = str(folders / ext / 'clip1' / f'001.{ext}')
        _eq_tuple(open_image(path, False, **kw),
                  jax_open_image(path, False, **kw))


@pytest.mark.parametrize('site', ['train.py:86', 'test.py:18', 'named'])
def test_get_root_logger_takes_jaxs_arguments(tmp_path, site):
    log_file = str(tmp_path / 'run.log')
    if site == 'named':
        logger = get_root_logger('bsvd_tpu_torch.calls', logging.DEBUG,
                                 log_file)
        assert logger.name == 'bsvd_tpu_torch.calls'
        logger.debug('a debug line')
        assert logger.level == logging.DEBUG
    else:
        logger = get_root_logger(log_level=logging.INFO, log_file=log_file)
        assert logger.level == logging.INFO
        logger.info(f'from {site}')
    for h in logger.handlers:
        h.flush()
    text = open(log_file).read()
    assert ('a debug line' if site == 'named' else f'from {site}') in text


@pytest.mark.parametrize('site', ['train.py:45', 'test.py:29'])
def test_build_dataloader_val_equals_jax(folders, site):
    """The val / test loaders over the same folders give the same items."""
    from bsvd_tpu.data import build_dataloader as jax_loader
    from bsvd_tpu.data import build_dataset as jax_dataset
    opt = _val_opt(folders / 'jpg')
    got = build_dataloader(build_dataset(opt), opt, num_gpu=1)
    ref = jax_loader(jax_dataset(dict(opt)), dict(opt), num_gpu=1)
    assert len(got) == len(ref) == 2
    for a, b in zip(got, ref):
        assert sorted(a) == sorted(b)
        for k in ('gt', 'lq', 'noise_map'):
            np.testing.assert_array_equal(a[k], b[k])
        assert a['gt'].shape == (1, 3, 3, 21, 31)


def test_build_dataloader_train_passes_through(folders):
    """train.py:27: the self-iterating train loader is its own loader, in
    both packages."""
    from bsvd_tpu.data import build_dataloader as jax_loader
    from bsvd_tpu_torch.data.video_train_loader import train_video_loader
    opt = {'trainset_dir': str(folders / 'jpg'), 'batch_size_per_gpu': 1,
           'temp_patch_size': 3, 'patch_size': [16, 16], 'noise_ival':
           [5, 55], 'num_workers': 1, 'manual_seed': 3, 'phase': 'train'}
    loader = train_video_loader(opt)
    try:
        assert build_dataloader(loader, opt, num_gpu=1) is loader
        assert build_dataloader(loader, opt, 1, False, None, 7) is loader
    finally:
        loader.close()
    sentinel = type('Iterating', (), {'__next__': lambda self: {}})()
    assert jax_loader(sentinel, opt, num_gpu=1) is sentinel


@pytest.mark.parametrize('kw,loader_kw,err,match', [
    ({'num_gpu': 2, 'dist': True}, {}, ValueError, 'num_gpu 2'),
    ({'dist': True}, {'num_devices': 2, 'rank': 1}, ValueError,
     'rank 1 of 2'),
    ({'sampler': object()}, {}, NotImplementedError, 'sampler')],
    ids=['num_gpu', 'dist', 'sampler'])
def test_build_dataloader_refuses_what_it_does_not_run(folders, kw,
                                                       loader_kw, err,
                                                       match):
    """A train loader made for another rank or mesh than the one it is
    handed to, and a sampler, raise; a val dataset is read whole on every
    rank, whatever num_gpu and dist say (the JAX package's loader too)."""
    from bsvd_tpu_torch.data import SimpleLoader
    from bsvd_tpu_torch.data.video_train_loader import train_video_loader
    opt = _val_opt(folders / 'png')
    assert isinstance(build_dataloader(build_dataset(opt), opt, num_gpu=2,
                                       dist=True), SimpleLoader)
    topt = dict({'trainset_dir': str(folders / 'jpg'),
                 'batch_size_per_gpu': 1, 'temp_patch_size': 3,
                 'patch_size': [16, 16], 'noise_ival': [5, 55],
                 'num_workers': 1, 'manual_seed': 3, 'phase': 'train'},
                **loader_kw)
    loader = train_video_loader(topt)
    try:
        with pytest.raises(err, match=match):
            build_dataloader(loader, topt, **kw)
    finally:
        loader.close()


TENSOR2IMG = {
    'denoising_model': ((), {}),
    'rgb': ((), {'rgb2bgr': False}),
    'min_max': ((), {'min_max': (-1, 1)}),
    'positional': ((False, (-0.5, 1.5)), {}),
}


@pytest.mark.parametrize('case', sorted(TENSOR2IMG))
def test_tensor2img_equals_jax(case):
    from bsvd_tpu.utils.img_util import tensor2img as jax_t2i
    args, kw = TENSOR2IMG[case]
    rng = np.random.default_rng(41)
    img = rng.uniform(-1.2, 1.7, (3, 9, 13)).astype(np.float32)
    for x in (img, img[0], [img, img[1:]], [img]):
        got, ref = tensor2img(x, *args, **kw), jax_t2i(x, *args, **kw)
        got = got if isinstance(got, list) else [got]
        ref = ref if isinstance(ref, list) else [ref]
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype == np.uint8
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('ext,params', [
    ('png', None), ('jpg', None),
    ('png', [cv2.IMWRITE_PNG_COMPRESSION, 9]),
    ('jpg', [cv2.IMWRITE_JPEG_QUALITY, 75]),
    ('jpg', [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
             cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444]),
    ('jpeg', [cv2.IMWRITE_JPEG_QUALITY, 90,
              cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
              cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440])],
    ids=['png', 'jpg', 'png_level9', 'jpg_q75', 'jpg_444', 'jpeg_q90_440'])
def test_imwrite_files_read_as_jaxs(tmp_path, ext, params):
    """denoising_model.py's ``imwrite(result_img, img_path)`` and cv2's
    flags: the file reads back (by cv2) as the JAX package's does; both
    return True and make the folder."""
    from bsvd_tpu.utils.img_util import imwrite as jax_imwrite
    img = np.random.default_rng(42).integers(0, 256, (19, 27, 3),
                                              dtype=np.uint8)
    ours = str(tmp_path / 'port' / 'sub' / f'f.{ext}')
    ref = str(tmp_path / 'jax' / 'sub' / f'f.{ext}')
    args = () if params is None else (params,)
    assert imwrite(img, ours, *args) is True
    assert jax_imwrite(img, ref, *args) is True
    np.testing.assert_array_equal(cv2.imread(ours), cv2.imread(ref))


def test_imwrite_without_auto_mkdir_equals_jax(tmp_path):
    from bsvd_tpu.utils.img_util import imwrite as jax_imwrite
    img = np.zeros((4, 4, 3), np.uint8)
    with pytest.raises(IOError):
        imwrite(img, str(tmp_path / 'none' / 'f.png'), None, False)
    with pytest.raises(Exception):
        jax_imwrite(img, str(tmp_path / 'none' / 'f.png'), None, False)
    assert not (tmp_path / 'none').exists()


def _stream_pair():
    from bsvd_tpu.archs.wnet_arch import WNetConfig as JaxConfig, wnet_init
    from bsvd_tpu_torch.archs.wnet_arch import WNetConfig
    from bsvd_tpu_torch.convert.torch_ckpt import from_jax_params
    kw = dict(chns=(8, 16, 32), mid_ch=8, interm_ch=8, norm='none',
              act='relu6', stage_num=1, shift_mode='TSM_toFutureOnly')
    jcfg, pcfg = JaxConfig(**kw), WNetConfig(**kw)
    jparams = wnet_init(jax.random.PRNGKey(43), jcfg)
    params = from_jax_params(jax.tree.map(np.asarray, jparams), pcfg)
    x = np.random.default_rng(44).standard_normal(
        (1, 4, 8, 8, pcfg.effective_in_ch)).astype(np.float32)
    return jcfg, jparams, pcfg, params, x


@pytest.mark.parametrize('dtype', ['none', 'float32', 'bfloat16'])
def test_streaming_apply_state_dtype_equals_jax(dtype):
    """streaming_apply(params, x, cfg, state_dtype) with the state dtype
    the JAX package runs: x's own (None, fp32 clip and carry, bf16 clip
    and carry)."""
    from bsvd_tpu.archs.streaming import streaming_apply as jax_streaming
    from bsvd_tpu_torch.archs.streaming import streaming_apply
    jcfg, jparams, pcfg, params, x = _stream_pair()
    jdt = {'none': None, 'float32': jnp.float32, 'bfloat16': jnp.bfloat16}
    tdt = {'none': None, 'float32': torch.float32,
           'bfloat16': torch.bfloat16}
    jx = jnp.asarray(x, jdt[dtype] or jnp.float32)
    tx = torch.from_numpy(x).to(tdt[dtype] or torch.float32)
    if dtype == 'bfloat16':
        jparams = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jparams)
        params = jax.tree.map(lambda a: a.to(torch.bfloat16), params)
    ref = np.asarray(jax_streaming(jparams, jx, jcfg, jdt[dtype]),
                     np.float32)
    got = streaming_apply(params, tx, pcfg, tdt[dtype])
    assert got.dtype == tx.dtype and got.shape == ref.shape
    if dtype == 'bfloat16':
        scale = max(1.0, float(np.abs(ref).max()))
        err = float(np.abs(got.float().numpy() - ref).max())
        assert err <= 2 ** -6 * scale, err
    else:
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)


def test_streaming_apply_carries_a_state_dtype_unlike_jax():
    """A carry dtype other than the clip's: the JAX package's scan raises
    TypeError (its step returns the state in the clip's dtype); the port
    carries the buffers in bf16 between fp32 steps."""
    from bsvd_tpu.archs.streaming import streaming_apply as jax_streaming
    from bsvd_tpu_torch.archs.streaming import streaming_apply
    jcfg, jparams, pcfg, params, x = _stream_pair()
    with pytest.raises(TypeError, match='carry'):
        jax_streaming(jparams, jnp.asarray(x), jcfg, jnp.bfloat16)
    fp32 = streaming_apply(params, torch.from_numpy(x), pcfg)
    got = streaming_apply(params, torch.from_numpy(x), pcfg, torch.bfloat16)
    assert got.dtype == torch.float32 and not torch.equal(got, fp32)
    scale = max(1.0, float(fp32.abs().max()))
    assert float((got - fp32).abs().max()) <= 2 ** -6 * scale


def _model_opt(tmp_path):
    return {'is_train': False, 'model_type': 'DenoisingModel',
            'num_gpu': 1, 'name': 'calls', 'network_g': dict(NET),
            'path': {'pretrain_network_g': None,
                     'training_states': str(tmp_path)},
            'train': {'warmup_iter': -1}, 'val': {'temp_psz': -1}}


@pytest.mark.parametrize('extra', [None, {'d_opt': {'count': 3}}],
                         ids=['denoising_model.py:629', 'extra'])
def test_save_training_state_stores_extra_as_jax(tmp_path, extra):
    from bsvd_tpu.models.base_model import BaseModel as JaxBase
    from bsvd_tpu.models.checkpoint import load_training_state as jax_load
    from bsvd_tpu_torch.models.base_model import BaseModel
    from bsvd_tpu_torch.models.checkpoint import load_training_state
    (tmp_path / 'p').mkdir()
    (tmp_path / 'j').mkdir()
    port = BaseModel(_model_opt(tmp_path / 'p'))
    ref = JaxBase(_model_opt(tmp_path / 'j'))
    kw = {} if extra is None else {'extra': extra}
    got = load_training_state(port.save_training_state(
        2, 40, opt_state={'count': torch.tensor(5)}, **kw))
    want = jax_load(ref.save_training_state(
        2, 40, opt_state={'count': np.int32(5)}, **kw))
    assert sorted(got) == sorted(want) == ['epoch', 'extra', 'iter',
                                           'opt_state']
    assert (got['epoch'], got['iter'], got['extra']) == \
        (want['epoch'], want['iter'], want['extra'])
    assert got['extra'] == (extra or {})
    assert port.save_training_state(2, -1) is None


def _models(tmp_path):
    from bsvd_tpu.archs.wnet_arch import wnet_init
    from bsvd_tpu.models import build_model as jax_build_model
    from bsvd_tpu_torch.convert.torch_ckpt import from_jax_params
    from bsvd_tpu_torch.models.denoising_model import DenoisingModel
    jm = jax_build_model(_model_opt(tmp_path))
    jparams = wnet_init(jax.random.PRNGKey(45), jm.cfg)
    jm.params = jm.net.params = jparams
    pm = DenoisingModel(_model_opt(tmp_path), device='cpu')
    pm.net.load_params(from_jax_params(jax.tree.map(np.asarray, jparams),
                                       pm.cfg))
    return jm, jparams, pm


def test_model_calls_of_the_jax_package(tmp_path, caplog):
    """print_network (denoising_model.py:234) logs the JAX parameter count;
    update_learning_rate is JAX's no-op (another warm-up raises);
    get_current_visuals returns JAX's keys and arrays after test()."""
    jm, jparams, pm = _models(tmp_path)
    with caplog.at_level(logging.INFO, logger='bsvd_tpu_torch'):
        logger = logging.getLogger('bsvd_tpu_torch')
        logger.addHandler(caplog.handler)
        try:
            pm.print_network(pm.net)
        finally:
            logger.removeHandler(caplog.handler)
    n = sum(int(np.size(x)) for x in jax.tree.leaves(jparams))
    assert f'with {n:,d} parameters' in caplog.text
    assert pm.update_learning_rate(7, warmup_iter=-1) is None
    assert jm.update_learning_rate(7, warmup_iter=-1) is None
    with pytest.raises(NotImplementedError, match='warmup_iter'):
        pm.update_learning_rate(7, warmup_iter=100)
    rng = np.random.default_rng(46)
    item = {'lq': rng.uniform(0, 1, (1, 3, 3, 16, 16)).astype(np.float32),
            'noise_map': np.full((1, 3, 1, 16, 16), 0.1, np.float32)}
    for m in (jm, pm):
        m.feed_data(item)
        m.test()
    got, ref = pm.get_current_visuals(), jm.get_current_visuals()
    assert list(got) == list(ref) == ['lq', 'result']
    np.testing.assert_array_equal(got['lq'], ref['lq'])
    np.testing.assert_allclose(got['result'], ref['result'], rtol=1e-4,
                               atol=1e-4)
    pm.feed_data(dict(item, gt=item['lq']))
    pm.test()
    assert list(pm.get_current_visuals()) == ['lq', 'result', 'gt']


class _Recorder:
    """A tb_logger that records its add_scalar calls."""

    def __init__(self):
        self.calls = []

    def add_scalar(self, tag, value, step):
        self.calls.append((tag, float(value), int(step)))


def test_message_logger_takes_jaxs_arguments():
    """bsvd_tpu/train.py:114 ``MessageLogger(opt, current_iter, tb_logger)``:
    the port mirrors each loss to the writer as the JAX package does."""
    from bsvd_tpu.utils.logger import MessageLogger as JaxMessageLogger
    from bsvd_tpu_torch.utils.logger import MessageLogger
    opt = {'name': 'calls', 'logger': {'print_freq': 10,
                                       'use_tb_logger': True},
           'train': {'total_iter': 100}}
    recs = []
    for cls in (MessageLogger, JaxMessageLogger):
        tb = _Recorder()
        msg = cls(opt, 20, tb)
        msg({'epoch': 1, 'iter': 30, 'lrs': [1e-3], 'time': 0.5,
             'data_time': 0.1, 'l_pix': 0.0125, 'l_reg': 2.0,
             'psnr': 31.5})
        recs.append(tb.calls)
    assert recs[0] == recs[1] == [('losses/l_pix', 0.0125, 30),
                                  ('losses/l_reg', 2.0, 30),
                                  ('psnr', 31.5, 30)]
