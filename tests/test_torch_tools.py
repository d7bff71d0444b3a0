"""The port's timing tools (``python -m bsvd_tpu_torch.tools.<name>``) on
the CPU at a tiny size (c16 nets, 2-3 frames of 32 x 48, one repetition):
each one's ``main(argv)`` runs in-process and prints one JSON line with
its keys, its kernel-against-plain checks passing (on CPU tensors the
wrappers run their plain versions, so the errors are 0); and
``make_synth_dataset`` writes the JAX repo tool's frames pixel for pixel.
Their times mean nothing here: the card's numbers come from chip_smoke.py
(phase 18) and PERF.md.
"""

import json
import os
import sys

import numpy as np
import pytest

from bsvd_tpu_torch.data import utils_common
from bsvd_tpu_torch.tools import (bench_block_stream, bench_push_block,
                                  bench_stream_block_step, bench_train,
                                  make_synth_dataset, probe_mem,
                                  probe_streams, profile_blocks,
                                  profile_stream, run_eval_burnin)
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ['--device', 'cpu', '--chns', '16,32,64', '--interm_ch', '16',
        '--mid_ch', '16', '--height', '32', '--width', '48']
HEAD = {'tool', 'device', 'device_name', 'nvidia_smi'}
SITE = {'site', 'ms', 'plain_ms', 'library_ms', 'bound_ms', 'bound_by',
        'flops', 'max_abs_err_fp32', 'tol_fp32', 'max_abs_err_bf16',
        'tol_bf16', 'launches_per_call'}

CASES = {
    'profile_blocks': (profile_blocks, ['--frames', '2', '--reps', '1'],
                       {'forward', 'blocks', 'sum_of_blocks_ms',
                        'sum_of_blocks_plain_ms', 'per_stage_counts'}),
    'profile_stream': (profile_stream, ['--reps', '1', '--pushes', '2'],
                       {'push_ms_per_frame', 'launches_per_push', 'sites'}),
    'bench_train': (bench_train, ['--batch', '2', '--frames', '3',
                                  '--iters', '1'],
                    {'fp32', 'bf16_amp', 'loss_check',
                     'reference_it_per_s'}),
    'bench_push_block': (bench_push_block, ['--frames', '4', '--reps', '1',
                                            '--frames-per-sync', '8'],
                         {'push_ms_per_frame', 'push_block_ms_per_frame',
                          'speedup', 'launches_per_push_block', 'check'}),
    'bench_stream_block_step': (
        bench_stream_block_step, ['--blocks', '2', '4', '--reps', '1',
                                  '--frames-per-sync', '8', '--causal'],
        {'push_ms_per_frame', 'block_sizes', 'check'}),
    'bench_block_stream': (bench_block_stream, [
        '--psz', '2', '--future', '1', '--reps', '1', '--frames-per-sync',
        '8'], {'push_ms_per_frame', 'block_ms_per_frame', 'speedup',
               'block_latency_frames', 'check'}),
    'probe_mem': (probe_mem, ['--frames', '2', '--reps', '1'],
                  {'kernels', 'plain', 'params_gb', 'check'}),
    'probe_streams': (probe_streams, ['--pushes', '2', '--check-frames',
                                      '4'], {'streams', 'check'}),
}


@pytest.mark.parametrize('name', sorted(CASES))
def test_tool_prints_its_json_line_on_the_cpu(name, capsys):
    mod, argv, keys = CASES[name]
    rec = mod.main(TINY + argv)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == \
        json.loads(json.dumps(rec))
    assert HEAD | keys <= set(rec), set(rec)
    assert rec['tool'] == name and rec['device'] == 'cpu'
    for s in rec.get('blocks', []) + rec.get('sites', []):
        assert SITE <= set(s) and s['max_abs_err_fp32'] == 0.0
    if 'check' in rec:
        assert rec['check']['max_abs_err_fp32'] == 0.0
    if name == 'bench_train':
        assert rec['loss_check']['abs_err'] == 0.0
        assert rec['fp32']['it_per_s'] > 0 and \
            rec['reference_it_per_s'] == 4.0


def test_bench_train_real_data_and_eval_burnin(tmp_path, capsys):
    """bench_train --real-data writes JPEG folders and feeds the step from
    the loader; run_eval_burnin runs test_pipeline on Set8- and
    DAVIS-shaped .tif folders and reports each block's split."""
    rec = bench_train.main(TINY + [
        '--batch', '1', '--frames', '3', '--iters', '1', '--real-data',
        '--data', str(tmp_path / 'train'), '--workers', '1',
        '--synth-clips', '1', '--synth-frames', '4', '--synth-height', '40',
        '--synth-width', '56'])
    assert set(rec['real_data']) == {'fp32', 'bf16_amp'}
    assert rec['real_data']['fp32']['e2e_it_per_s'] > 0
    assert len(os.listdir(tmp_path / 'train' / 'clip00')) == 4
    before = utils_common.ROUTES['tiff_decode']
    rec = run_eval_burnin.main([
        '--device', 'cpu', '--root', str(tmp_path / 'burnin'),
        '--set8-clips', '1', '--davis-clips', '1', '--frames', '3',
        '--sigmas', '20', '--format', 'tif', '--chns', '16, 32, 64',
        '--mid_ch', '16', '--interm_ch', '16', '--height', '32', '--width',
        '48'])
    assert utils_common.ROUTES['tiff_decode'] == before + 6
    assert set(rec['results']) == set(rec['s_per_clip']) == \
        {'Set8_20', 'DAVIS_20'}
    assert rec['frames_total'] == 6 and rec['blocks'] == 2
    for split in rec['s_per_clip'].values():
        assert set(split) == {'read', 'denoise', 'metrics', 'save'}
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        'tool'] == 'run_eval_burnin'


@pytest.mark.parametrize('fmt', ['png', 'tif'])
def test_make_synth_dataset_equals_the_jax_tool(tmp_path, fmt, capsys):
    """The port's frames equal the JAX repo tool's (cv2-written PNG) pixel
    for pixel, as PNG and as TIFF."""
    pytest.importorskip('cv2')
    sys.path.insert(0, os.path.join(ROOT, 'tools'))
    from make_synth_dataset import main as jax_tool
    jax_tool(str(tmp_path / 'jax'), num_clips=2, t=3, h=20, w=28, seed=5)
    rec = make_synth_dataset.main([str(tmp_path / 'port'), '--num_clips',
                                   '2', '--frames', '3', '--height', '20',
                                   '--width', '28', '--seed', '5',
                                   '--format', fmt])
    assert rec['clips'] == 2 and json.loads(
        capsys.readouterr().out.strip().splitlines()[-1]) == rec
    for clip in ('clip00', 'clip01'):
        ref, _, _ = utils_common.open_sequence(str(tmp_path / 'jax' / clip))
        got, _, _ = utils_common.open_sequence(str(tmp_path / 'port' / clip))
        assert got.shape == (3, 3, 20, 28)
        np.testing.assert_array_equal(got, ref)
