"""Streaming push against the block-chunked client on the card
(counterpart of the JAX repo's tools/bench_block_stream.py).

    python -m bsvd_tpu_torch.tools.bench_block_stream [--psz 8]
        [--future 2] [--reps 4] [--frames-per-sync 64] [--height 540]
        [--width 960] [--device cpu]

Times, for the BSVD-c64 net in bf16, ``StreamDenoiser.push`` (one frame a
step, the lowest latency) and ``BlockStreamDenoiser(psz, future)`` (the
chunked whole-clip forward over psz + future frames with the carried
shift state, the reference's temp_psz protocol run as frames arrive), in
ms a frame over ``--frames-per-sync`` frames, best of ``--reps``
(``_stream_bench``). The block client's chunk forward
(``wnet_apply_chunk`` with its carries, before the client clips to [0,
1]) on two consecutive chunks in fp32 through the kernels is held against
the plain route's (1e-4 x max |ref|).

Prints one JSON line: ``push_ms_per_frame``, ``block_ms_per_frame``,
``speedup``, ``block_latency_frames``, ``check``.
"""

import sys

import torch

from bsvd_tpu_torch.archs.wnet_arch import wnet_apply_chunk
from bsvd_tpu_torch.models.seq_inference import BlockStreamDenoiser
from bsvd_tpu_torch.tools import _common as c
from bsvd_tpu_torch.tools import _stream_bench as sb


def check(raw, cfg, clip, psz, future):
    """Two chunks as the block client runs them (psz + future frames, the
    next psz frames on), fp32 kernels against the plain route."""
    x = clip[:2 * psz + future].float().transpose(0, 1)   # (1, T, H, W, C)

    def chunks():
        carries, outs = None, []
        for k in (0, psz):
            out, carries = wnet_apply_chunk(raw, x[:, k:k + psz + future],
                                            cfg, carries, future)
            outs.append(out)
        return torch.cat(outs, 1)
    with c.plain_route():
        ref = chunks()
    before = c.launches()
    got = chunks()
    n = c.launches_since(before)
    err, tol = c.held('block chunks fp32', got, ref, c.FP32_TOL)
    return {'chunks': 2, 'frames': x.shape[1], 'max_abs_err_fp32': err,
            'tol_fp32': tol, 'launches': n}


def main(argv=None):
    ap = sb.parser(__doc__)
    ap.add_argument('--psz', type=int, default=8)
    ap.add_argument('--future', type=int, default=2)
    ap.set_defaults(reps=4)
    args = ap.parse_args(argv)
    device, dtype, cfg, raw, params, clip = sb.setup(args)

    def block_client(p, cfg_, dt):
        return BlockStreamDenoiser(p, cfg_, psz=args.psz,
                                   future_buffer_len=args.future, dtype=dt)
    with torch.no_grad():
        push = sb.ms_per_frame(
            sb.stream_client(args)(params, cfg, dtype).push, clip, 1,
            device, args.reps)
        bsd = block_client(params, cfg, dtype)
        block = sb.ms_per_frame(bsd.push, clip, 1, device, args.reps)
        chk = check(raw, cfg, clip, args.psz, args.future)
    return c.emit('bench_block_stream', device, {
        'height': args.height, 'width': args.width, 'dtype': 'bf16',
        'psz': args.psz, 'future': args.future, 'push_ms_per_frame': push,
        'block_ms_per_frame': block, 'speedup': push / block,
        'block_latency_frames': bsd.latency, 'check': chk})


if __name__ == '__main__':
    main(sys.argv[1:])
