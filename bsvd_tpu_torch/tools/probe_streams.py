"""Several streams through one streaming client on the card (counterpart
of the JAX repo's tools/probe_streams.py).

    python -m bsvd_tpu_torch.tools.probe_streams [--streams 2 4]
        [--height 540] [--width 960] [--pushes 10] [--device cpu]

For each N of ``--streams``: ``StreamDenoiser(batch=N)`` of the BSVD-c64
net in bf16, filled, then ms a push over ``--pushes`` pushes ending in a
synchronize, best of 3; the aggregate frames a second (N / push) and a
stream's (1 / push). The fp32 outputs of the first N through the kernels
are held against the plain route's (``--check-frames`` pushes, 1e-4 x
max |ref|).

Prints one JSON line: ``streams`` (per N: ``ms_per_push``,
``ms_per_frame_per_stream``, ``aggregate_fps``, ``fps_per_stream``),
``check``.
"""

import sys

import torch

from bsvd_tpu_torch.archs.streaming import StreamDenoiser
from bsvd_tpu_torch.tools import _common as c
from bsvd_tpu_torch.tools import _stream_bench as sb


def main(argv=None):
    ap = c.parser(__doc__)
    ap.add_argument('--streams', type=int, nargs='+', default=[2, 4])
    ap.add_argument('--pushes', type=int, default=10)
    ap.add_argument('--check-frames', type=int, default=None)
    args = ap.parse_args(argv)
    device, dtype = c.setup(args)
    cfg, raw, params = c.net(args, device, dtype)
    gen = torch.Generator(device=device).manual_seed(c.SEED)
    out = {}
    with torch.no_grad():
        for n in args.streams:
            sd = StreamDenoiser(params, cfg, batch=n, height=args.height,
                                width=args.width, dtype=dtype)
            frame = torch.rand((n, args.height, args.width,
                                cfg.effective_in_ch), generator=gen,
                               device=device).to(dtype)
            for _ in range(sd.latency + 4):
                sd.push(frame)

            def run(sd=sd, frame=frame):
                for _ in range(args.pushes):
                    sd.push(frame)
            ms = c.best_ms_per(run, args.pushes, device)
            out[str(n)] = {'ms_per_push': ms, 'ms_per_frame_per_stream':
                           ms / n, 'aggregate_fps': n * 1e3 / ms,
                           'fps_per_stream': 1e3 / ms}
            del sd
        n = args.streams[0]
        clip = torch.rand((args.check_frames or cfg.shift_num + 8, n,
                           args.height, args.width, cfg.effective_in_ch),
                          generator=gen, device=device)
        chk = sb.check(lambda p, cfg_, dt: StreamDenoiser(
            p, cfg_, batch=n, height=args.height, width=args.width,
            dtype=dt), raw, cfg, clip, 1)
    return c.emit('probe_streams', device, {
        'height': args.height, 'width': args.width, 'dtype': 'bf16',
        'streams': out, 'check': dict(chk, streams=n)})


if __name__ == '__main__':
    main(sys.argv[1:])
