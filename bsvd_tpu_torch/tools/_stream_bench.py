"""The timing helper of the three streaming benches (bench_push_block,
bench_stream_block_step, bench_block_stream): a seeded net and clip, ms a
frame of a client's pushes, and the check of the kernels' streamed
outputs against the plain route's."""

import torch

from bsvd_tpu_torch.archs.streaming import StreamDenoiser
from bsvd_tpu_torch.tools import _common as c


def parser(doc, height=540):
    ap = c.parser(doc, height=height)
    ap.add_argument('--reps', type=int, default=3)
    ap.add_argument('--frames-per-sync', type=int, default=64)
    ap.add_argument('--causal', action='store_true')
    ap.add_argument('--check-frames', type=int, default=None,
                    help='frames of the fp32 check (the pipeline latency '
                         '+ 8 by default)')
    return ap


def setup(args):
    """(device, dtype, cfg, raw fp32 params, params in dtype, clip): the
    clip is ``--frames-per-sync`` frames (1, H, W, C) on the device."""
    device, dtype = c.setup(args)
    mode = 'TSM_toFutureOnly' if args.causal else 'TSM'
    cfg, raw, params = c.net(args, device, dtype, mode)
    gen = torch.Generator(device=device).manual_seed(c.SEED)
    clip = torch.rand((args.frames_per_sync, 1, args.height, args.width,
                       cfg.effective_in_ch), generator=gen,
                      device=device).to(dtype)
    return device, dtype, cfg, raw, params, clip


def ms_per_frame(push, clip, block, device, reps):
    """Best of ``reps`` host-clock ms a frame over the clip pushed through
    ``push`` (one frame, or ``block`` frames a call), after one warm
    pass; synchronised at both ends."""
    n = clip.shape[0] - clip.shape[0] % block

    def run():
        for k in range(0, n, block):
            push(clip[k] if block == 1 else clip[k:k + block])
    run()
    return c.best_ms_per(run, n, device, reps)


def _outs(r):
    """A push's outputs as a list (None, a frame, or a list)."""
    if r is None:
        return []
    if isinstance(r, torch.Tensor):
        return [r]
    return [o for o in r if o is not None]


def stream_outputs(client, clip, block):
    """Every output of the clip pushed (``block`` frames a push_block call,
    ``push`` for 1) then flushed, stacked."""
    outs = []
    n = clip.shape[0] - clip.shape[0] % block
    for k in range(0, n, block):
        outs += _outs(client.push(clip[k]) if block == 1
                      else client.push_block(clip[k:k + block]))
    outs += _outs(client.flush())
    return torch.stack(outs)


def check(make, raw, cfg, clip, block):
    """The fp32 outputs of the client ``make(params, cfg, torch.float32)``
    through the kernels against the plain route's, 1e-4 x max |ref|; the
    launches of the kernel run."""
    x = clip.float()
    with c.plain_route():
        ref = stream_outputs(make(raw, cfg, torch.float32), x, block)
    before = c.launches()
    got = stream_outputs(make(raw, cfg, torch.float32), x, block)
    n = c.launches_since(before)
    err, tol = c.held('stream fp32', got, ref, c.FP32_TOL)
    return {'frames': x.shape[0], 'outputs': got.shape[0],
            'max_abs_err_fp32': err, 'tol_fp32': tol, 'launches': n}


def stream_client(args):
    """``make(params, cfg, dtype)``: a StreamDenoiser of the options' frame
    size."""
    return lambda p, cfg, dt: StreamDenoiser(
        p, cfg, batch=1, height=args.height, width=args.width, dtype=dt)


def check_clip(args, cfg, clip):
    """The first ``--check-frames`` frames (the pipeline's latency + 8 by
    default, 1 + 2 x 8 x stages delays of its 16 shift convs a stage)."""
    n = args.check_frames or (cfg.shift_num + 8)
    return clip[:n]
