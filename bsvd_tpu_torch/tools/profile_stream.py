"""Per-site times of the frame-by-frame streaming step on the card, and
the steady push (counterpart of the JAX repo's tools/profile_stream.py).

    python -m bsvd_tpu_torch.tools.profile_stream [--height 540]
        [--width 960] [--pushes 20] [--reps 10] [--device cpu]

The steady ``StreamDenoiser.push`` of the BSVD-c64 net in bf16: host-clock
ms a frame over ``--pushes`` pushes ending in a synchronize, best of 3
(bench.py's protocol), and the launches of one steady push. Then each
one-frame site at the shapes of the JAX tool's ``sites`` list and its
stride-2 sites, in the natural layout (the JAX tool's width-folded
shapes are a Mosaic workaround): inc c1 (4 -> 64) and c2 (64 -> 64), outc
c1 (64 -> 64) and c2 (64 -> 3, no act) on K1 at one frame; the MemCvBlock
convs at c1 on the half-size frame and c2 on the quarter-size one on K5
(one bibuffer step, as the push runs them); up2 / up1 on K4; down0 / down1
on K3. Each: the kernel (CUDA events, median of ``--reps``) against its
plain version and the one cuDNN call of its conv (K4's shuffle and K5's
input assembly left out), beside its bound; the kernel held against the
plain version in fp32 (1e-4 x max |ref|) and bf16 (2^-6 x max(1, max
|ref|)).

Prints one JSON line: ``push_ms_per_frame``, ``launches_per_push``,
``sites`` (per site: ``ms``, ``plain_ms``, ``library_ms``, ``bound_ms``,
``bound_by``, ``flops``, errors, launches per call).
"""

import sys

import torch

from bsvd_tpu_torch.archs.streaming import StreamDenoiser
from bsvd_tpu_torch.nn.layers import conv2d
from bsvd_tpu_torch.ops.bibuffer_conv import (bibuffer_conv,
                                              bibuffer_conv_reference)
from bsvd_tpu_torch.ops.conv3x3 import (conv3x3, conv3x3_reference, conv_ps,
                                        conv_ps_reference)
from bsvd_tpu_torch.ops.conv_s2 import conv_s2, conv_s2_reference
from bsvd_tpu_torch.tools import _common as c


def steady_push(params, cfg, args, device, dtype, gen):
    """(ms a frame of steady pushes, launches of one steady push)."""
    sd = StreamDenoiser(params, cfg, batch=1, height=args.height,
                        width=args.width, dtype=dtype)
    frame = torch.rand((1, args.height, args.width, cfg.effective_in_ch),
                       generator=gen, device=device).to(dtype)
    for _ in range(sd.latency + 3):
        sd.push(frame)
    before = c.launches()
    sd.push(frame)
    per_push = c.launches_since(before)

    def run():
        for _ in range(args.pushes):
            sd.push(frame)
    return c.best_ms_per(run, args.pushes, device), per_push


def sites(cfg, h, w, device, reps, gen):
    """The one-frame sites: ``c.site`` records."""
    c0, c1, c2 = cfg.chns
    h2, w2, h4, w4 = (h + 1) // 2, (w + 1) // 2, (h + 3) // 4, (w + 3) // 4
    cin = cfg.effective_in_ch

    def rand(*shape):
        v = torch.rand(shape, generator=gen, device=device)
        return {dt: v.to(dt) for dt in c.DTYPES.values()}

    def weights(ci, co):
        w_ = torch.randn((co, ci, 3, 3), generator=gen, device=device) * \
            (2 / (9 * ci)) ** 0.5
        b_ = torch.rand((co,), generator=gen, device=device) * 0.1 - 0.05
        return {dt: c.ConvWeights(w_.to(dt), b_.to(dt))
                for dt in c.DTYPES.values()}

    def library(v, cw, stride=1):
        w_, b_ = cw.w.to(torch.bfloat16), cw.b.to(torch.bfloat16)
        return lambda: conv2d(v[torch.bfloat16], w_, b_, stride=stride)

    out = []
    for name, hh, ww, ci, co, act in (
            ('inc_c1', h, w, cin, c0, cfg.act),
            ('inc_c2', h, w, c0, c0, cfg.act),
            ('outc_c1', h, w, c0, c0, cfg.act),
            ('outc_c2', h, w, c0, cfg.out_ch, 'none')):
        v, cw = rand(1, hh, ww, ci), weights(ci, co)
        out.append(c.site(
            f'k1_{name}', lambda dt, v=v, cw=cw, a=act: conv3x3(
                v[dt], cw[dt], act=a),
            lambda dt, v=v, cw=cw, a=act: conv3x3_reference(v[dt], cw[dt],
                                                            act=a),
            library(v, cw[torch.float32]), c.conv_flops(1, hh, ww, ci, co),
            c.nbytes(v[torch.bfloat16], cw[torch.bfloat16]), device, reps))
    for name, hh, ww, ch in (('memcv_c1', h2, w2, c1),
                             ('memcv_c2', h4, w4, c2)):
        v, st, cw = rand(1, hh, ww, ch), rand(1, hh, ww, ch), weights(ch, ch)
        out.append(c.site(
            f'k5_{name}', lambda dt, v=v, st=st, cw=cw: bibuffer_conv(
                v[dt], st[dt], cw[dt], act=cfg.act)[0],
            lambda dt, v=v, st=st, cw=cw: bibuffer_conv_reference(
                v[dt], st[dt], cw[dt], act=cfg.act)[0],
            library(v, cw[torch.float32]), c.conv_flops(1, hh, ww, ch, ch),
            c.nbytes(v[torch.bfloat16], st[torch.bfloat16],
                     cw[torch.bfloat16]), device, reps))
    for name, hh, ww, ci, co in (('up2', h4, w4, c2, 4 * c1),
                                 ('up1', h2, w2, c1, 4 * c0)):
        v, cw = rand(1, hh, ww, ci), weights(ci, co)
        out.append(c.site(
            f'k4_{name}', lambda dt, v=v, cw=cw: conv_ps(v[dt], cw[dt]),
            lambda dt, v=v, cw=cw: conv_ps_reference(v[dt], cw[dt]),
            library(v, cw[torch.float32]), c.conv_flops(1, hh, ww, ci, co),
            c.nbytes(v[torch.bfloat16], cw[torch.bfloat16]), device, reps))
    for name, hh, ww, ci, co in (('down0', h, w, c0, c1),
                                 ('down1', h2, w2, c1, c2)):
        v, cw = rand(1, hh, ww, ci), weights(ci, co)
        out.append(c.site(
            f'k3_{name}', lambda dt, v=v, cw=cw: conv_s2(v[dt], cw[dt],
                                                        act=cfg.act),
            lambda dt, v=v, cw=cw: conv_s2_reference(v[dt], cw[dt],
                                                     act=cfg.act),
            library(v, cw[torch.float32], 2),
            c.conv_flops(1, hh, ww, ci, co, 2),
            c.nbytes(v[torch.bfloat16], cw[torch.bfloat16]), device, reps))
    return out


def main(argv=None):
    ap = c.parser(__doc__)
    ap.add_argument('--pushes', type=int, default=20)
    ap.add_argument('--reps', type=int, default=10)
    args = ap.parse_args(argv)
    device, dtype = c.setup(args)
    cfg, _, params = c.net(args, device, dtype)
    gen = torch.Generator(device=device).manual_seed(c.SEED)
    with torch.no_grad():
        push_ms, per_push = steady_push(params, cfg, args, device, dtype,
                                        gen)
        recs = sites(cfg, args.height, args.width, device, args.reps, gen)
    return c.emit('profile_stream', device, {
        'height': args.height, 'width': args.width, 'dtype': 'bf16',
        'chns': list(cfg.chns), 'push_ms_per_frame': push_ms,
        'launches_per_push': per_push, 'sites': recs})


if __name__ == '__main__':
    main(sys.argv[1:])
