"""Streaming push against push_block(F) on the card (counterpart of the JAX
repo's tools/bench_push_block.py).

    python -m bsvd_tpu_torch.tools.bench_push_block [--frames 8] [--reps 5]
        [--height 544] [--width 960] [--causal] [--device cpu]

Times, for the BSVD-c64 net in bf16, ``StreamDenoiser.push`` one frame at
a time and ``push_block`` of ``--frames`` frames (every temporal conv one
K5 launch over the F frames), in ms a frame over ``--frames-per-sync``
frames, best of ``--reps`` (``_stream_bench``), and the launches of one
steady push_block. The JAX tool's third line, push_block as an unrolled
loop against ``lax.scan``, is an XLA carry workaround with no counterpart
here. The fp32 outputs of a push_block stream (``--check-frames``) through
the kernels are held against the plain route's (1e-4 x max |ref|).

Prints one JSON line: ``push_ms_per_frame``, ``push_block_ms_per_frame``,
``speedup``, ``launches_per_push_block``, ``check``.
"""

import sys

import torch

from bsvd_tpu_torch.tools import _common as c
from bsvd_tpu_torch.tools import _stream_bench as sb


def main(argv=None):
    ap = sb.parser(__doc__, height=544)
    ap.set_defaults(frames=8, reps=5)
    args = ap.parse_args(argv)
    device, dtype, cfg, raw, params, clip = sb.setup(args)
    make = sb.stream_client(args)
    f = args.frames
    with torch.no_grad():
        push = sb.ms_per_frame(make(params, cfg, dtype).push, clip, 1,
                               device, args.reps)
        sd = make(params, cfg, dtype)
        block = sb.ms_per_frame(sd.push_block, clip, f, device, args.reps)
        before = c.launches()
        sd.push_block(clip[:f])
        per_block = c.launches_since(before)
        chk = sb.check(make, raw, cfg, sb.check_clip(args, cfg, clip), f)
    return c.emit('bench_push_block', device, {
        'height': args.height, 'width': args.width, 'dtype': 'bf16',
        'causal': args.causal, 'frames': f, 'push_ms_per_frame': push,
        'push_block_ms_per_frame': block, 'speedup': push / block,
        'launches_per_push_block': per_block, 'check': chk})


if __name__ == '__main__':
    main(sys.argv[1:])
