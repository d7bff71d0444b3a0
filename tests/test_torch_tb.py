"""The port's TensorBoard event files (``utils/tb_events``, no package)
against the JAX package's ``TBLogger`` (tensorflow's writer), both read
back by tensorboard's ``EventAccumulator``; the port's reader and its CRC
checks; ``MessageLogger`` / ``init_tb_logger`` with the JAX call
signatures; and the train command line writing the losses and the
validation metrics.

Tolerances: none. Scalars are float32 in both files: the same bits.
"""

import os

import numpy as np
import pytest

from bsvd_tpu_torch.utils import logger as port_logger
from bsvd_tpu_torch.utils import tb_events
from bsvd_tpu_torch.utils.img_util import imwrite
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_YML = os.path.join(ROOT, 'options', 'train', 'bsvd_c64_unblind.yml')
CALLS = [('losses/l_pix', 0.123456789, 3), ('metrics/psnr', 31.5, 10),
         ('metrics/psnr/clip0', 29.25, 10), ('losses/l_pix', 1e-7, 20),
         ('lr', 2.5e-4, 20), ('losses/l_pix', np.float64(7.5), 0)]


def _event_file(log_dir):
    files = sorted(os.listdir(log_dir))
    assert len(files) == 1 and files[0].startswith('events.out.tfevents.') \
        and files[0].endswith('.v2'), files
    return os.path.join(log_dir, files[0])


def _accumulated(log_dir):
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator)
    acc = EventAccumulator(log_dir, size_guidance={'tensors': 0})
    acc.Reload()
    tags = sorted(acc.Tags()['tensors'])
    series = {t: [(e.step, np.frombuffer(e.tensor_proto.tensor_content,
                                         '<f4').tolist())
                  for e in acc.Tensors(t)] for t in tags}
    meta = {t: (acc.SummaryMetadata(t).plugin_data.plugin_name,
                acc.SummaryMetadata(t).data_class) for t in tags}
    return tags, series, meta


def test_event_files_equal_jax_tblogger(tmp_path):
    """The same add_scalar calls through JAX's TBLogger and the port's read
    back equal by tensorboard; the port's reader reads JAX's file; the
    only test here that imports tensorflow."""
    from bsvd_tpu.utils.logger import TBLogger as JaxTBLogger
    jax_tb = JaxTBLogger(str(tmp_path / 'jax'))
    assert jax_tb._writer is not None          # tensorflow writes here
    port_tb = port_logger.TBLogger(str(tmp_path / 'port'))
    for tb in (jax_tb, port_tb):
        for tag, value, step in CALLS:
            tb.add_scalar(tag, value, step)
        tb.flush()
        tb.close()
    jax_acc = _accumulated(str(tmp_path / 'jax'))
    port_acc = _accumulated(str(tmp_path / 'port'))
    assert jax_acc == port_acc
    tags, series, meta = port_acc
    assert tags == ['losses/l_pix', 'lr', 'metrics/psnr',
                    'metrics/psnr/clip0']
    assert series['losses/l_pix'] == [
        (3, [np.float32(0.123456789)]), (20, [np.float32(1e-7)]),
        (0, [7.5])]
    assert {m[0] for m in meta.values()} == {'scalars'}
    # the port's reader on both files
    got_jax = tb_events.read_scalars(_event_file(str(tmp_path / 'jax')))
    got_port = tb_events.read_scalars(_event_file(str(tmp_path / 'port')))
    want = [(step, tag, float(np.float32(v))) for tag, v, step in CALLS]
    assert [r[1:] for r in got_jax] == [r[1:] for r in got_port] == want
    assert tb_events.read_dir(str(tmp_path / 'jax'))[0][1:] == want[0]


def test_reader_checks_every_crc(tmp_path):
    tb = port_logger.TBLogger(str(tmp_path))
    tb.add_scalar('losses/l_pix', 0.5, 1)
    tb.close()
    path = _event_file(str(tmp_path))
    data = open(path, 'rb').read()
    assert tb_events.read_scalars(path) == [
        (pytest.approx(os.path.getmtime(path), abs=60), 1, 'losses/l_pix',
         0.5)]
    first = len(tb_events.frame(tb_events.version_event(0.0)))
    for at in (3, 9, first + 20, len(data) - 2):
        bad = bytearray(data)
        bad[at] ^= 0x10
        open(path, 'wb').write(bytes(bad))
        with pytest.raises(IOError, match='CRC'):
            tb_events.read_scalars(path)
    open(path, 'wb').write(data[:-3])
    with pytest.raises(IOError, match='truncated'):
        tb_events.read_scalars(path)
    # the framing's CRC-32C: the standard check value
    assert tb_events.crc32c(b'123456789') == 0xE3069283


def _opt(print_freq=1):
    return {'name': 'exp', 'logger': {'print_freq': print_freq,
                                      'use_tb_logger': True},
            'train': {'total_iter': 10}}


def test_message_logger_writes_the_losses(tmp_path):
    """JAX's call, MessageLogger(opt, current_iter, tb_logger): keys with
    l_ go under losses/, others as they are."""
    tb = port_logger.init_tb_logger(str(tmp_path))
    msg = port_logger.MessageLogger(_opt(), 1, tb)
    for it in (1, 2):
        msg({'epoch': 0, 'iter': it, 'lrs': [1e-3], 'time': 0.1,
             'data_time': 0.01, 'l_pix': 0.25 * it, 'psnr': 30.0 + it})
    tb.close()
    got = [r[1:] for r in tb_events.read_dir(str(tmp_path))]
    assert got == [(1, 'losses/l_pix', 0.25), (1, 'psnr', 31.0),
                   (2, 'losses/l_pix', 0.5), (2, 'psnr', 32.0)]
    assert msg.use_tb_logger and msg.tb_logger is tb


def test_init_tb_logger_on_the_main_process_only(tmp_path, monkeypatch):
    monkeypatch.setattr(port_logger, 'is_main_process', lambda: False)
    assert port_logger.init_tb_logger(str(tmp_path / 'rank1')) is None
    assert not (tmp_path / 'rank1').exists()
    monkeypatch.setattr(port_logger, 'is_main_process', lambda: True)
    tb = port_logger.init_tb_logger(str(tmp_path / 'rank0'))
    assert isinstance(tb, port_logger.TBLogger)
    tb.close()
    _event_file(str(tmp_path / 'rank0'))


def test_train_pipeline_writes_losses_and_metrics(tmp_path):
    """The train command line on the shipped yml (use_tb_logger: true), a
    PSNR metric set: losses/l_pix at every print, metrics/psnr and its
    per-folder tags at the validation and after the last iteration."""
    from bsvd_tpu_torch.data.video_train_loader import synthetic_clips
    from bsvd_tpu_torch.train import train_pipeline
    rng = np.random.default_rng(5)
    for split, n, t in (('train', 2, 8), ('val', 2, 4)):
        for i, c in enumerate(synthetic_clips(rng, n, t, 32, 32)):
            for k, f in enumerate(c):
                imwrite(f.transpose(1, 2, 0)[..., ::-1],
                        str(tmp_path / split / f'clip{i}' / f'{k:03d}.png'))
    train_pipeline(str(tmp_path), cmd=[
        '-opt', TRAIN_YML, '--device', 'cpu', '--force_yml',
        f'datasets:train:trainset_dir={tmp_path}/train',
        f'datasets:val:valsetdir={tmp_path}/val',
        'datasets:val:num_validation_frames=4',
        'datasets:train:batch_size_per_gpu=1',
        'datasets:train:temp_patch_size=3', 'network_g:num_segments=3',
        'datasets:train:patch_size=[16,16]', 'datasets:train:num_workers=1',
        'val:temp_psz=-1', 'val:fp16=false', 'val:save_img=false',
        'val:metrics:psnr:type=calculate_psnr',
        'val:metrics:psnr:crop_border=0', 'logger:print_freq=1',
        'logger:save_checkpoint_freq=2', 'val:val_freq=2',
        'train:total_iter=2', 'network_g:net2d_opt:chns=[8,16,32]',
        'network_g:net2d_opt:mid_ch=8', 'network_g:net2d_opt:interm_ch=8'])
    got = tb_events.read_dir(str(tmp_path / 'experiments' /
                                 'bsvd_c64_unblind' / 'tb_logger'))
    steps = {}
    for _, step, tag, value in got:
        assert np.isfinite(value)
        steps.setdefault(tag, []).append(step)
    assert steps == {'losses/l_pix': [1, 2], 'metrics/psnr': [2, 2],
                     'metrics/psnr/clip0': [2, 2],
                     'metrics/psnr/clip1': [2, 2]}
