"""The port's command-line entry points on CPU against the JAX package: the
YAML reader against PyYAML (the JAX package's ordered loader) on every
option file of the repo, its refusals; ``parse_options`` against the JAX
package's on the BSVD train and test files (``-opt``, ``--force_yml``,
``--debug``, ``--auto_resume``); the one-card ``num_gpu`` rule; the
logger and misc helpers; the data factory; ``train_pipeline`` and
``python -m bsvd_tpu_torch.test`` from option files on PNG frame folders.

Tolerances: none. Options, log lines and paths are equal; the network
runs are checked for files, iterations and finite metrics
(tests/test_torch_eval.py holds test_pipeline's metrics against JAX).
"""

import glob
import io
import json
import logging
import math
import os
import re
import sys

import numpy as np
import pytest

from bsvd_tpu_torch.data import SimpleLoader, build_dataloader
from bsvd_tpu_torch.utils import logger as port_logger
from bsvd_tpu_torch.utils import misc, options, yaml_lite
from bsvd_tpu_torch.utils.img_util import imwrite
from torch_threads import one_torch_thread  # noqa: F401

yaml = pytest.importorskip('yaml')
pytest.importorskip('jax')

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPTION_FILES = sorted(os.path.relpath(p, ROOT) for p in glob.glob(
    os.path.join(ROOT, 'options', '*', '*.yml')))
TRAIN_YML = os.path.join(ROOT, 'options', 'train', 'bsvd_c64_unblind.yml')
TEST_YML = os.path.join(ROOT, 'options', 'test', 'bsvd_c64.yml')
NARROW = ['network_g:net2d_opt:chns=[8,16,32]', 'network_g:net2d_opt:mid_ch=8',
          'network_g:net2d_opt:interm_ch=8']


def _canon(x):
    """Types, values and mapping order, recursively (NaN equal to NaN)."""
    if isinstance(x, dict):
        return ('map', [(_canon(k), _canon(v)) for k, v in x.items()])
    if isinstance(x, list):
        return ('seq', [_canon(v) for v in x])
    if isinstance(x, float) and math.isnan(x):
        return ('nan',)
    return (type(x).__name__, x)


def _pyyaml(text):
    from bsvd_tpu.utils.options import ordered_yaml
    return yaml.load(text, Loader=ordered_yaml()[0])


# ---------------------------------------------------------------------------
# the YAML reader
# ---------------------------------------------------------------------------

def test_every_option_file_is_found():
    assert len(OPTION_FILES) == 12


@pytest.mark.parametrize('path', OPTION_FILES)
def test_yaml_reader_equals_pyyaml_on_the_option_files(path):
    with open(os.path.join(ROOT, path)) as f:
        text = f.read()
    assert _canon(yaml_lite.load(os.path.join(ROOT, path))) == \
        _canon(_pyyaml(text))


SCALARS = ['1e-3', '1.0e-3', '1.0e3', '!!float 7e5', '!!float 1',
           '!!int 017', '!!str 3', "'none'", 'none', '~', 'null', '',
           'True', 'true', 'yes', 'Off', 'tRue', '017', '-017',
           '1_000', '-.inf', '.NaN', '+1', '1.', '.5',
           '"a b # c"', "'it''s'", 'a #b', 'a#b',
           '[5, 55]', '[a, [b, {c: d, e}], "x y", 1.5E+3]', '{a:1}',
           '[1, 2,]', 'x: [1,\n  2, 3]  # comment\ny: 2',
           'a:\n- 1\n- b: 2\n  c: 3\n-\n  - 4\nd:\n  - e', '---\nk: v']


@pytest.mark.parametrize('text', SCALARS)
def test_yaml_reader_resolves_as_pyyaml(text):
    """PyYAML's YAML 1.1 resolution: '1e-3' (no dot) stays a string,
    '!!float 7e5' is 700000.0, 017 is octal, 'True' and 'yes' are
    booleans, a quoted 'none' a string."""
    assert _canon(yaml_lite.loads(text)) == _canon(_pyyaml(text))


@pytest.mark.parametrize('text,what', [
    ('a: &x 1\nb: *x', 'anchors'), ('a: *x', 'aliases'),
    ('a: |\n  text', 'block scalars'), ('a: >\n  text', 'block scalars'),
    ('a: 1\n---\nb: 2', 'several documents'),
    ('a:\n\tb: 1', 'tab in the indentation'),
    ('a: 2020-01-01', 'timestamps'), ('a: !!python/tuple [1]', 'tag'),
    ('a: !!bool yes', 'tag'), ('a: b\n  c', 'multi-line'),
    ('a: [1, 2', 'unterminated'), ("a: 'x", 'unterminated'),
    ('? a\n: 1', 'complex keys'), ('a: b: c', 'mapping'),
    ('a: 0x1F', 'hexadecimal'), ('a: -0b101', 'binary'),
    ('a: 1:30', 'sexagesimal ints'), ('a: [1:30.5]', 'sexagesimal floats'),
    ('a: "x\\ty"', 'backslash escapes')])
def test_yaml_reader_refuses_what_it_does_not_read(text, what):
    with pytest.raises(ValueError, match=f'line [0-9]+: .*{what}'):
        yaml_lite.loads(text)


def test_yaml_reader_reads_what_pyyaml_dumps(tmp_path):
    """yaml.safe_dump's block sequences, quoting and nulls read back."""
    doc = {'name': 'x', 'list': [1, 2.5, 'a b', None, True],
           'nested': {'k': [{'a': 1}, {'b': [3, 4]}], 'quoted': 'yes',
                      'num_str': '1e-3', 'empty': {}}}
    path = tmp_path / 'd.yml'
    path.write_text(yaml.safe_dump(doc))
    assert yaml_lite.load(str(path)) == doc
    assert options.yaml_load(str(path)) == doc
    assert options.yaml_load('a: 1') == {'a': 1}


# ---------------------------------------------------------------------------
# parse_options
# ---------------------------------------------------------------------------

PARSE_CASES = {
    'train': (True, ['-opt', TRAIN_YML, '--force_yml', 'num_gpu=1']),
    'train_force': (True, [
        '-opt', TRAIN_YML, '--force_yml', 'num_gpu=1',
        'train:total_iter=30', 'train:optim_g:lr=2e-4',
        'train:optim_g:betas=[0.8,0.9]', 'datasets:train:patch_size=[64,48]',
        'datasets:val:valsetdir=/data/Set8', 'val:fp16=false',
        'logger:wandb:project=~', 'new:deep:key=[1,[2,3]]',
        'network_g:net2d_opt:norm=none']),
    'train_debug': (True, ['-opt', TRAIN_YML, '--debug', '--force_yml',
                           'num_gpu=1']),
    'train_auto_resume': (True, ['-opt', TRAIN_YML, '--auto_resume',
                                 '--launcher', 'pytorch', '--local_rank',
                                 '0', '--force_yml', 'num_gpu=1']),
    'basicvsr_reds': (True, [
        '-opt', os.path.join(ROOT, 'options', 'train', 'basicvsr_reds.yml'),
        '--force_yml', 'num_gpu=1', 'network_g:spynet_path=~',
        'datasets:train:dataroot_gt=/data/REDS/gt',
        'datasets:val:dataroot_lq=/data/REDS4/lq', 'train:fix_flow=10']),
    'test': (False, ['-opt', TEST_YML, '--force_yml', 'num_gpu=1']),
    'test_force': (False, ['-opt', TEST_YML, '--force_yml', 'num_gpu=1',
                           'val:temp_psz=11', 'manual_seed=3',
                           'path:pretrain_network_g=~/ckpt.npz']),
}


@pytest.mark.parametrize('case', sorted(PARSE_CASES))
def test_parse_options_equals_jax(tmp_path, case):
    from bsvd_tpu.utils.options import parse_options as jax_parse
    is_train, cmd = PARSE_CASES[case]
    root = str(tmp_path)
    got, args = options.parse_options(root, is_train=is_train, cmd=cmd)
    want, jargs = jax_parse(root, is_train=is_train, cmd=cmd)
    assert _canon(got) == _canon(want)
    assert (args.opt, args.auto_resume, args.debug, args.force_yml) == \
        (jargs.opt, jargs.auto_resume, jargs.debug, jargs.force_yml)
    assert got['num_gpu'] == 1 and 'device' not in got


def test_parse_options_from_a_file_and_the_device(tmp_path):
    from bsvd_tpu.utils.options import parse_options as jax_parse
    got, _ = options.parse_options(str(tmp_path), False, opt_path=TEST_YML)
    want, _ = jax_parse(str(tmp_path), False, opt_path=TEST_YML)
    want['num_gpu'] = 1
    assert _canon(got) == _canon(want)
    got, _ = options.parse_options(str(tmp_path), False, cmd=[
        '-opt', TEST_YML, '--device', 'cpu'])
    assert got['device'] == 'cpu'


def test_num_gpu_is_one_card(tmp_path):
    """'auto' is the world size: 1 without a process group, and 1 on a
    world-size-1 group joined by --launcher pytorch (dist then True); a
    number other than the world size raises with the torchrun command
    instead of training at a batch other than the one asked."""
    import socket
    import torch.distributed as dist
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        port = sock.getsockname()[1]
    got, _ = options.parse_options(str(tmp_path), True, cmd=['-opt',
                                                             TRAIN_YML])
    assert got['num_gpu'] == 1 and not got['dist']
    with pytest.raises(ValueError, match='torch.distributed.run'):
        options.parse_options(str(tmp_path), True, cmd=[
            '-opt', TRAIN_YML, '--force_yml', 'num_gpu=2'])
    env = {'MASTER_ADDR': '127.0.0.1', 'MASTER_PORT': str(port),
           'RANK': '0', 'WORLD_SIZE': '1', 'LOCAL_RANK': '0'}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        got, _ = options.parse_options(str(tmp_path), True, cmd=[
            '-opt', TRAIN_YML, '--launcher', 'pytorch', '--device', 'cpu'])
        assert dist.is_initialized() and dist.get_backend() == 'gloo'
        assert (got['num_gpu'], got['dist'], got['rank'],
                got['world_size']) == (1, True, 0, 1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def test_force_yml_values_resolve_as_pyyaml():
    from bsvd_tpu.utils.options import apply_force_yml as jax_apply
    entries = ['a:b=1e-3', 'a:c=1.0e-3', 'a:d=[1, 2]', 'e=~', 'f=true',
               'g:h:i={x: 1}', "j='none'", 'k=']
    got, want = {'a': {'z': 0}}, {'a': {'z': 0}}
    options.apply_force_yml(got, entries)
    jax_apply(want, entries)
    assert _canon(got) == _canon(json.loads(json.dumps(want)))


def test_dict2str_and_copy_opt_file_equal_jax(tmp_path):
    from bsvd_tpu.utils import options as jax_options
    opt = yaml_lite.load(TRAIN_YML)
    assert options.dict2str(opt) == jax_options.dict2str(opt)
    (tmp_path / 'a').mkdir()
    (tmp_path / 'b').mkdir()
    options.copy_opt_file(TRAIN_YML, str(tmp_path / 'a'))
    jax_options.copy_opt_file(TRAIN_YML, str(tmp_path / 'b'))
    a = (tmp_path / 'a' / 'bsvd_c64_unblind.yml').read_text().split('\n')
    b = (tmp_path / 'b' / 'bsvd_c64_unblind.yml').read_text().split('\n')
    assert a[0].startswith('# GENERATE TIME: ') and a[1:] == b[1:]


# ---------------------------------------------------------------------------
# logger, misc, the data factory
# ---------------------------------------------------------------------------

def _capture(logger):
    stream = io.StringIO()
    handler = logging.StreamHandler(stream)
    handler.setFormatter(logging.Formatter('%(message)s'))
    logger.addHandler(handler)
    return stream, handler


def test_message_logger_line_equals_jax(monkeypatch):
    from bsvd_tpu.utils import logger as jax_logger
    opt = {'name': 'bsvd_c64_unblind', 'logger': {'print_freq': 10},
           'train': {'total_iter': 700000.0}}
    lines = []
    for mod, logger in ((port_logger, port_logger.get_root_logger()),
                        (jax_logger, jax_logger.get_root_logger())):
        ticks = [100.0]           # the start, then 30 s later for ever
        monkeypatch.setattr(mod.time, 'time',
                            lambda: ticks.pop() if ticks else 130.0)
        msg = mod.MessageLogger(opt, start_iter=0)
        stream, handler = _capture(logger)
        try:
            msg({'epoch': 1, 'iter': 30, 'lrs': [1e-3], 'time': 0.0425,
                 'data_time': 0.5, 'l_pix': 0.0123})
        finally:
            logger.removeHandler(handler)
        lines.append(stream.getvalue())
    assert lines[0] == lines[1] and 'time (data): 0.043 (0.500)' in lines[0]


def test_avg_timer_and_env_info(monkeypatch):
    clock = iter([0.0, 1.0, 1.0, 4.0, 4.0])
    monkeypatch.setattr(port_logger.time, 'time', lambda: next(clock))
    t = port_logger.AvgTimer()
    t.record()
    t.record()
    assert (t.get_current_time(), t.get_avg_time()) == (3.0, 2.0)
    info = port_logger.get_env_info()
    assert 'PyTorch' in info and 'Card: ' in info


def test_misc_helpers_equal_jax(tmp_path):
    from bsvd_tpu.utils import misc as jax_misc
    for rel in ('a.png', 'b.txt', 'sub/c.png', '.hidden.png'):
        (tmp_path / rel).parent.mkdir(exist_ok=True)
        (tmp_path / rel).write_text('x')
    for kw in ({}, {'suffix': '.png'}, {'suffix': '.png', 'recursive': True},
               {'recursive': True, 'full_path': True}):
        assert sorted(misc.scandir(str(tmp_path), **kw)) == \
            sorted(jax_misc.scandir(str(tmp_path), **kw))
    for n in (0, 1023, 1024, 5 * 2**30, 2**90):
        assert misc.sizeof_fmt(n) == jax_misc.sizeof_fmt(n)
    opt = {'network_g': {}, 'network_d': {},
           'path': {'resume_state': 'x.state', 'models': '/m',
                    'pretrain_network_g': 'old.npz',
                    'ignore_resume_networks': ['network_d']}}
    jopt = json.loads(json.dumps(opt))
    misc.check_resume(opt, 40)
    jax_misc.check_resume(jopt, 40)
    assert opt == jopt and opt['path']['pretrain_network_g'] == \
        '/m/net_g_40.npz' and 'pretrain_network_d' not in opt['path']


def test_dataloader_factory_by_kind():
    """A self-iterating train loader passes through; a map-style train
    dataset gets the JAX package's BatchLoader over an EnlargedSampler
    (the zoo's datasets); a val dataset a SimpleLoader."""
    from bsvd_tpu_torch.data.sampler import BatchLoader, EnlargedSampler

    class Iterating:
        def __next__(self):
            return {}

    class MapStyle:
        def __len__(self):
            return 2

        def __getitem__(self, i):
            return {'i': i}

    it = Iterating()
    assert build_dataloader(it, {'phase': 'train'}) is it
    train = build_dataloader(MapStyle(), {'phase': 'train',
                                          'batch_size_per_gpu': 1,
                                          'num_worker_per_gpu': 1})
    assert isinstance(train, BatchLoader)
    assert isinstance(train.sampler, EnlargedSampler) and len(train) == 2
    assert sorted(b['i'][0] for b in train) == [0, 1]
    loader = build_dataloader(MapStyle(), {'phase': 'val'})
    assert isinstance(loader, SimpleLoader) and \
        [d['i'] for d in loader] == [0, 1]


# ---------------------------------------------------------------------------
# the entry points on PNG folders
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def png_root(tmp_path_factory):
    from bsvd_tpu_torch.data.video_train_loader import synthetic_clips
    root = tmp_path_factory.mktemp('png_clips')
    rng = np.random.default_rng(22)
    for split, n, t in (('train', 2, 12), ('val', 2, 6)):
        for i, c in enumerate(synthetic_clips(rng, n, t, 40, 48)):
            for k, f in enumerate(c):
                imwrite(f.transpose(1, 2, 0)[..., ::-1],
                        str(root / split / f'clip{i}' / f'{k:03d}.png'))
    return str(root)


def _train_cmd(data, iters, *extra):
    return ['-opt', TRAIN_YML, '--device', 'cpu', *extra, '--force_yml',
            f'datasets:train:trainset_dir={data}/train',
            f'datasets:val:valsetdir={data}/val',
            'datasets:val:num_validation_frames=6',
            'datasets:train:batch_size_per_gpu=2',
            'datasets:train:temp_patch_size=5', 'network_g:num_segments=5',
            'datasets:train:patch_size=[32,32]',
            'datasets:train:num_workers=2', 'val:temp_psz=4',
            'val:fp16=false', 'logger:print_freq=1',
            'logger:save_checkpoint_freq=2', 'val:val_freq=2',
            f'train:total_iter={iters}', *NARROW]


def test_train_pipeline_from_the_shipped_yml(png_root, tmp_path,
                                             monkeypatch):
    """Two iterations on PNG folders with validation at 2 and at the end,
    the model, state and option-file copy written, the losses in the
    TensorBoard event file; --auto_resume continues from iteration 2 to
    3."""
    from bsvd_tpu_torch.models.denoising_model import DenoisingModel
    from bsvd_tpu_torch.train import train_pipeline
    calls = []
    orig = DenoisingModel.validation

    def spy(self, loader, current_iter, tb_logger, save_img=False):
        calls.append(current_iter)
        return orig(self, loader, current_iter, tb_logger, save_img)

    monkeypatch.setattr(DenoisingModel, 'validation', spy)
    root = str(tmp_path)
    model = train_pipeline(root, cmd=_train_cmd(png_root, 2))
    assert model.optimizer.count == 2 and calls == [2, 2]
    exp = tmp_path / 'experiments' / 'bsvd_c64_unblind'
    for rel in ('models/net_g_2.npz', 'models/net_g_latest.npz',
                'training_states/2.state', 'bsvd_c64_unblind.yml'):
        assert (exp / rel).is_file(), rel
    assert len(list((exp / 'visualization').rglob('*.png'))) == 12
    log = next(exp.glob('train_*.log')).read_text()
    assert 'l_pix' in log
    # use_tb_logger: the losses in an event file under tb_logger
    from bsvd_tpu_torch.utils.tb_events import read_dir
    assert [(step, tag) for _, step, tag, _ in read_dir(
        str(exp / 'tb_logger'))] == [(1, 'losses/l_pix'), (2, 'losses/l_pix')]
    assert re.search(r'iter: +2, .*time \(data\): [0-9.]+ \([0-9.]+\)\]',
                     log)
    model = train_pipeline(root, cmd=_train_cmd(png_root, 3,
                                                '--auto_resume'))
    assert model.optimizer.count == 3 and calls == [2, 2, 3]
    assert not list(tmp_path.glob('experiments/*_archived_*'))


def test_train_pipeline_refuses_wandb_and_video_folders(png_root, tmp_path):
    from bsvd_tpu_torch.train import train_pipeline
    with pytest.raises(NotImplementedError, match='wandb'):
        train_pipeline(str(tmp_path), cmd=_train_cmd(png_root, 1)
                       + ['logger:wandb:project=bsvd'])
    # an unreadable .mp4 names the file; a .mkv names its container
    (tmp_path / 'videos').mkdir()
    (tmp_path / 'videos' / 'a.mp4').write_bytes(b'\x00')
    with pytest.raises(IOError, match='a.mp4'):
        train_pipeline(str(tmp_path), cmd=_train_cmd(png_root, 1) + [
            f'datasets:train:trainset_dir={tmp_path}/videos'])
    os.remove(tmp_path / 'videos' / 'a.mp4')
    (tmp_path / 'videos' / 'a.mkv').write_bytes(b'\x00')
    with pytest.raises(NotImplementedError, match='a.mkv: Matroska'):
        # another root: a third run in one second would reuse the first's
        # archive folder name
        train_pipeline(str(tmp_path / 'mkv'), cmd=_train_cmd(png_root, 1) + [
            f'datasets:train:trainset_dir={tmp_path}/videos'])


def test_test_module_main_prints_the_metrics(png_root, tmp_path,
                                             monkeypatch, capsys):
    """``python -m bsvd_tpu_torch.test -opt ... --device cpu`` (main() with
    the repo root moved to a scratch folder): the JSON line of metrics."""
    from bsvd_tpu_torch import test as test_mod
    yml = tmp_path / 'test.yml'
    yml.write_text(f"""name: cli_test
model_type: DenoisingModel
num_gpu: auto
manual_seed: 10
datasets:
  val_1:
    name: synth
    type: ValFolderDataset
    valsetdir: {png_root}/val
    num_validation_frames: 6
    valnoisestd: 20
network_g:
  type: BSVD
  chns: [8, 16, 32]
  mid_ch: 8
  interm_ch: 8
  norm: 'none'
  act: 'relu6'
path:
  pretrain_network_g: ~
val:
  save_img: false
  temp_psz: -1
  fp16: false
  metrics:
    psnr: {{type: calculate_psnr, crop_border: 2, test_y_channel: false}}
""")
    monkeypatch.setattr(test_mod, 'ROOT', str(tmp_path))
    monkeypatch.setattr(sys, 'argv', ['test', '-opt', str(yml), '--device',
                                      'cpu'])
    test_mod.main()
    res = json.loads(capsys.readouterr().out.strip().split('\n')[-1])
    assert set(res) == {'synth'} and np.isfinite(res['synth']['psnr'])
    assert (tmp_path / 'results' / 'cli_test' / 'synth_clip0.csv').is_file()
