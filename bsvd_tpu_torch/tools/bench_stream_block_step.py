"""Streaming push against push_block(F) at several block sizes on the card
(counterpart of the JAX repo's tools/bench_stream_block_step.py).

    python -m bsvd_tpu_torch.tools.bench_stream_block_step
        [--blocks 4 8 16] [--reps 3] [--frames-per-sync 64] [--causal]
        [--height 540] [--width 960] [--device cpu]

Times, for the BSVD-c64 net in bf16, ``StreamDenoiser.push`` (one frame a
step: K1-K5 at one frame) and ``push_block(F)`` for each F of
``--blocks`` (each temporal conv one K5 launch over F frames, the stems
and ups at F frames), in ms a frame over ``--frames-per-sync`` frames
ending in a synchronize, best of ``--reps`` (``_stream_bench``). The fp32
outputs of a push_block stream at the first F (``--check-frames``) through
the kernels are held against the plain route's (1e-4 x max |ref|).

Prints one JSON line: ``push_ms_per_frame``, ``block_sizes`` (per F:
``ms_per_frame``, ``speedup``), ``check``.
"""

import sys

import torch

from bsvd_tpu_torch.tools import _common as c
from bsvd_tpu_torch.tools import _stream_bench as sb


def main(argv=None):
    ap = sb.parser(__doc__)
    ap.add_argument('--blocks', type=int, nargs='+', default=[4, 8, 16])
    args = ap.parse_args(argv)
    device, dtype, cfg, raw, params, clip = sb.setup(args)
    make = sb.stream_client(args)
    with torch.no_grad():
        push = sb.ms_per_frame(make(params, cfg, dtype).push, clip, 1,
                               device, args.reps)
        blocks = {}
        for f in args.blocks:
            ms = sb.ms_per_frame(make(params, cfg, dtype).push_block, clip,
                                 f, device, args.reps)
            blocks[str(f)] = {'ms_per_frame': ms, 'speedup': push / ms}
        chk = sb.check(make, raw, cfg, sb.check_clip(args, cfg, clip),
                       args.blocks[0])
    return c.emit('bench_stream_block_step', device, {
        'height': args.height, 'width': args.width, 'dtype': 'bf16',
        'causal': args.causal, 'push_ms_per_frame': push,
        'block_sizes': blocks,
        'check': chk})


if __name__ == '__main__':
    main(sys.argv[1:])
