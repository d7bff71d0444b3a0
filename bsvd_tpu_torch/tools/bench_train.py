"""Train-step throughput of BSVD-c64 on the reference protocol
(counterpart of the JAX repo's tools/bench_train.py).

    python -m bsvd_tpu_torch.tools.bench_train [--batch 16] [--iters 10]
        [--real-data] [--data DIR] [--device cpu]

The reference trains BSVD-c64 at ~4 it/s effective on two RTX 3090s
(batch 8 a GPU x 2 = 16 clips of 11 frames, 96 x 96 crops;
tools/bench_train.py:4-7 of the JAX repo, reference
options/train/bsvd_c64_unblind.yml and README.md:80). This times
``DenoisingModel.optimize_parameters`` (forward, MSE, backward, Adam, EMA
at 0.999) on options/train/bsvd_c64_unblind.yml at ``--batch`` clips, in
fp32 and in bf16 AMP (``train.fp16``): host-clock ms a step over
``--iters`` steps after 2 warm-up steps, synchronised at both ends, best
of 3; it/s beside the reference's 4; launches per step, peak memory. The
batch is one made by the port's augment and noise code from seeded
synthetic clips, fed once. The first fp32 step's loss through the kernels
is held against the plain route's on the same batch and weights (1e-4 x
|ref|).

``--real-data``: the steps fed from ``train_video_loader`` over ``--data``
(DAVIS-shaped 480 x 854 JPEG folders written by ``make_synth_dataset``
where the folder is empty or missing): the loader alone (batches a
second), the step alone and the two together (it/s, the wait for each
batch).

Prints one JSON line: per precision (``fp32``, ``bf16_amp``):
``ms_per_step``, ``it_per_s``, ``reference_it_per_s``,
``launches_per_step``, ``peak_allocated_gb``; ``loss_check``; with
``--real-data`` ``real_data`` per precision.
"""

import copy
import os
import sys
import tempfile
import time

import numpy as np
import torch

from bsvd_tpu_torch.data import build_dataset
from bsvd_tpu_torch.data.video_train_loader import (noisy_batch,
                                                    synthetic_clips)
from bsvd_tpu_torch.models.denoising_model import DenoisingModel
from bsvd_tpu_torch.tools import _common as c
from bsvd_tpu_torch.tools.make_synth_dataset import write
from bsvd_tpu_torch.utils.options import parse_options

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TRAIN_YML = os.path.join(ROOT, 'options', 'train', 'bsvd_c64_unblind.yml')
REFERENCE_IT_PER_S = 4.0


def train_opt(args, amp, device, work):
    """The train yml through parse_options, the net at the options'
    widths, ``num_segments`` the clip length."""
    opt, _ = parse_options(work, is_train=True, cmd=[
        '-opt', TRAIN_YML, '--force_yml',
        f'network_g:num_segments={args.frames}',
        f'train:fp16={str(amp).lower()}', 'train:ema_decay=0.999'])
    net2d = opt['network_g']['net2d_opt']
    net2d['chns'] = [int(v) for v in args.chns.split(',')]
    net2d['interm_ch'], net2d['mid_ch'] = args.interm_ch, args.mid_ch
    opt['device'] = device.type
    return opt


def time_steps(model, args, device, first_iter=3):
    """Best of 3 ms a step over ``--iters`` steps; the launches of one."""
    model.optimize_parameters(1)
    before = c.launches()
    model.optimize_parameters(2)
    per_step = c.launches_since(before)
    it = [first_iter]

    def run():
        for _ in range(args.iters):
            model.optimize_parameters(it[0])
            it[0] += 1
    return c.best_ms_per(run, args.iters, device), per_step


def loss_check(args, batch, device, work):
    """The first fp32 step's loss through the kernels against the plain
    route's, the same seeded weights and batch."""
    losses = []
    for plain in (False, True):
        model = DenoisingModel(train_opt(args, False, device, work),
                               device=device)
        model.feed_data(batch)
        if plain:
            with c.plain_route():
                model.optimize_parameters(1)
        else:
            model.optimize_parameters(1)
        losses.append(torch.as_tensor(float(model.log_dict['l_pix'])))
        del model
    err, tol = c.held('train loss fp32', losses[0], losses[1], c.FP32_TOL)
    return {'loss': float(losses[0]), 'plain_loss': float(losses[1]),
            'abs_err': err, 'tol': tol}


def real_data(args, amp, device, work):
    """The loader alone, the step alone and both (it/s, wait a batch)."""
    data = args.data or os.path.join(work, 'trainset_480p')
    if not os.path.isdir(data) or not os.listdir(data):
        write(data, num_clips=args.synth_clips, t=args.synth_frames,
              h=args.synth_height, w=args.synth_width, fmt='jpg')
    loader = build_dataset({
        'name': 'bench', 'type': 'train_video_loader', 'trainset_dir': data,
        'batch_size_per_gpu': args.batch, 'temp_patch_size': args.frames,
        'patch_size': args.hw, 'max_number_patches': 10 ** 9,
        'noise_ival': [5, 55], 'noise_shape': 'NF', 'manual_seed': 0,
        **({} if args.workers is None else {'num_workers': args.workers})})
    try:
        it = iter(loader)
        model = DenoisingModel(train_opt(args, amp, device, work),
                               device=device)
        model.feed_data(next(it))
        model.optimize_parameters(1)
        c.sync(device)
        t0 = time.perf_counter()
        for i in range(args.iters):
            model.optimize_parameters(2 + i)
        c.sync(device)
        step_s = (time.perf_counter() - t0) / args.iters
        t0 = time.perf_counter()
        for _ in range(args.iters):
            next(it)
        loader_s = (time.perf_counter() - t0) / args.iters
        wait = 0.0
        t0 = time.perf_counter()
        for i in range(args.iters):
            w0 = time.perf_counter()
            d = next(it)
            wait += time.perf_counter() - w0
            model.feed_data(d)
            model.optimize_parameters(2 + args.iters + i)
        c.sync(device)
        e2e_s = (time.perf_counter() - t0) / args.iters
        return {'data': data, 'step_it_per_s': 1 / step_s,
                'loader_it_per_s': 1 / loader_s, 'e2e_it_per_s': 1 / e2e_s,
                'wait_ms_per_step': wait / args.iters * 1e3,
                'num_workers': loader._num_workers}
    finally:
        loader.close()


def main(argv=None):
    ap = c.parser(__doc__, frames=11, height=96, width=96)
    ap.add_argument('--batch', type=int, default=16)
    ap.add_argument('--iters', type=int, default=10)
    ap.add_argument('--real-data', action='store_true')
    ap.add_argument('--data', default=None,
                    help='frame folders for --real-data (written when empty)')
    ap.add_argument('--workers', type=int, default=None,
                    help="the loader's threads (its default without)")
    ap.add_argument('--synth-clips', type=int, default=8)
    ap.add_argument('--synth-frames', type=int, default=40)
    ap.add_argument('--synth-height', type=int, default=480)
    ap.add_argument('--synth-width', type=int, default=854)
    args = ap.parse_args(argv)
    device, _ = c.setup(args)
    args.hw = [args.height, args.width]
    rng = np.random.default_rng(c.SEED)
    batch = noisy_batch(synthetic_clips(rng, args.batch, args.frames,
                                        args.height, args.width), rng,
                        [5, 55], 'N')
    out = {'batch': [args.batch, args.frames, args.height, args.width],
           'chns': [int(v) for v in args.chns.split(',')],
           'reference_it_per_s': REFERENCE_IT_PER_S}
    with tempfile.TemporaryDirectory() as work:
        for amp in (False, True):
            if device.type == 'cuda':
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            model = DenoisingModel(train_opt(args, amp, device, work),
                                   device=device)
            model.feed_data(copy.copy(batch))
            ms, per_step = time_steps(model, args, device)
            out['bf16_amp' if amp else 'fp32'] = {
                'ms_per_step': ms, 'it_per_s': 1e3 / ms,
                'launches_per_step': per_step,
                'loss_last': float(model.log_dict['l_pix']),
                'peak_allocated_gb': (torch.cuda.max_memory_allocated() / 1e9
                                      if device.type == 'cuda' else None)}
            del model
        out['loss_check'] = loss_check(args, batch, device, work)
        if args.real_data:
            out['real_data'] = {
                'bf16_amp' if amp else 'fp32': real_data(args, amp, device,
                                                         work)
                for amp in (False, True)}
    return c.emit('bench_train', device, out)


if __name__ == '__main__':
    main(sys.argv[1:])
