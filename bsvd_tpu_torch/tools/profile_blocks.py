"""Per-block times of the BSVD-c64 540p whole-clip forward on the card, the
port's kernels against the plain route (counterpart of the JAX repo's
tools/profile_blocks.py; the reference protocol: profile.py, a (1, 10, 4,
540, 960) half-precision clip).

    python -m bsvd_tpu_torch.tools.profile_blocks [--frames 10]
        [--height 540] [--width 960] [--reps 5] [--device cpu]

Times (CUDA events, median of ``--reps``; bf16):
the whole forward through the kernels and through the plain route (every
op's plain PyTorch version on the card); then each block of stage 0 on
inputs of its shape, its kernel against its plain version and, where one
PyTorch call computes the same conv, that call (cuDNN): inc (K2, 4 ->
interm -> c0), down0 and down1 (K3, stride 2), the shift convs at c1 on
the half-size frames and at c2 on the quarter-size ones (K1 with TSM),
up2 and up1 with the pixel shuffle (K4; the library call is the conv
alone), and outc with the skip-add and the residual (K2). The sum of the
blocks over both stages (stage 0's blocks counted twice, each stage runs
the same blocks) stands beside the whole forward. Every block's kernel is
held against its plain version (fp32: 1e-4 x max |ref|; bf16: 2^-6 x
max(1, max |ref|)) and the whole fp32 forward against the plain route's
(1e-4 x max |ref|).

The JAX tool's width-folded lines (its ``_stage_apply_folded`` stems and
the folded down / outc convs) time a Mosaic layout workaround that the
port does not have: they have no counterpart here.

Prints one JSON line: ``forward`` (``ms``, ``plain_ms``, launches, the
fp32 check), ``blocks`` (per block: ``ms``, ``plain_ms``, ``library_ms``,
``bound_ms``, ``bound_by``, ``flops``, errors and launches per call),
``sum_of_blocks_ms`` and ``sum_of_blocks_plain_ms``.
"""

import sys

import torch

from bsvd_tpu_torch.archs.wnet_arch import wnet_apply
from bsvd_tpu_torch.nn.layers import conv2d
from bsvd_tpu_torch.ops.conv3x3 import (conv3x3, conv3x3_reference, conv_ps,
                                        conv_ps_reference)
from bsvd_tpu_torch.ops.conv_chain import (conv_chain, conv_chain_add2_res,
                                           conv_chain_reference)
from bsvd_tpu_torch.ops.conv_s2 import conv_s2, conv_s2_reference
from bsvd_tpu_torch.tools import _common as c

# each block's count in one stage: down0.cv and up1.cv hold two shift
# convs each at c1, down1.cv and up2.cv two each at c2
PER_STAGE = {'inc': 1, 'down0': 1, 'down1': 1, 'shift_conv_c1': 4,
             'shift_conv_c2': 4, 'up2': 1, 'up1': 1, 'outc': 1}


def blocks(s0, x, cfg, device, reps, gen):
    """Each block of stage 0 at its shape: ``c.site`` records."""
    t, h, w = x.shape[1:4]
    c0, c1, c2 = cfg.chns
    nt = x.shape[0] * t
    h2, w2, h4, w4 = (h + 1) // 2, (w + 1) // 2, (h + 3) // 4, (w + 3) // 4

    def rand(*shape):
        v = torch.rand(shape, generator=gen, device=device)
        return {dt: v.to(dt) for dt in c.DTYPES.values()}

    def cws(leaf):
        return {dt: c.ConvWeights(leaf.w.to(dt), leaf.b.to(dt))
                for dt in c.DTYPES.values()}

    def library(v, cw, stride=1):
        w_, b_ = cw.w.to(torch.bfloat16), cw.b.to(torch.bfloat16)
        return lambda: conv2d(v[torch.bfloat16], w_, b_, stride=stride)

    out = []
    xin = {dt: x.reshape(nt, h, w, -1).to(dt) for dt in c.DTYPES.values()}
    inc1, inc2 = cws(s0['inc']['c1']), cws(s0['inc']['c2'])
    out.append(c.site(
        'inc', lambda dt: conv_chain(xin[dt], inc1[dt], None, inc2[dt], None,
                                     cfg.act, cfg.act),
        lambda dt: conv_chain_reference(xin[dt], inc1[dt], None, inc2[dt],
                                        None, cfg.act, cfg.act),
        None, c.conv_flops(nt, h, w, xin[torch.float32].shape[-1],
                           cfg.interm_ch)
        + c.conv_flops(nt, h, w, cfg.interm_ch, c0),
        c.nbytes(xin[torch.bfloat16], inc1[torch.bfloat16],
                 inc2[torch.bfloat16]), device, reps))
    x0 = rand(nt, h, w, c0)
    x1 = rand(nt, h2, w2, c1)
    x2 = rand(nt, h4, w4, c2)
    for name, v, leaf, cin, cout, hh, ww in (
            ('down0', x0, s0['down0']['conv'], c0, c1, h, w),
            ('down1', x1, s0['down1']['conv'], c1, c2, h2, w2)):
        cw = cws(leaf)
        out.append(c.site(
            name, lambda dt, v=v, cw=cw: conv_s2(v[dt], cw[dt], act=cfg.act),
            lambda dt, v=v, cw=cw: conv_s2_reference(v[dt], cw[dt],
                                                     act=cfg.act),
            library(v, cw[torch.float32], 2),
            c.conv_flops(nt, hh, ww, cin, cout, 2),
            c.nbytes(v[torch.bfloat16], cw[torch.bfloat16]), device, reps))
    for name, v, leaf, ch, hh, ww in (
            ('shift_conv_c1', x1, s0['down0']['cv']['c1'], c1, h2, w2),
            ('shift_conv_c2', x2, s0['down1']['cv']['c1'], c2, h4, w4)):
        cw = cws(leaf)
        kw = dict(t_len=t, shift='tsm', act=cfg.act)
        out.append(c.site(
            name, lambda dt, v=v, cw=cw: conv3x3(v[dt], cw[dt], **kw),
            lambda dt, v=v, cw=cw: conv3x3_reference(v[dt], cw[dt], **kw),
            library(v, cw[torch.float32]), c.conv_flops(nt, hh, ww, ch, ch),
            c.nbytes(v[torch.bfloat16], cw[torch.bfloat16]), device, reps))
    for name, v, leaf, cin, hh, ww in (
            ('up2', x2, s0['up2']['conv'], c2, h4, w4),
            ('up1', x1, s0['up1']['conv'], c1, h2, w2)):
        cw = cws(leaf)
        out.append(c.site(
            name, lambda dt, v=v, cw=cw: conv_ps(v[dt], cw[dt]),
            lambda dt, v=v, cw=cw: conv_ps_reference(v[dt], cw[dt]),
            library(v, cw[torch.float32]),
            c.conv_flops(nt, hh, ww, cin, cw[torch.float32].cout),
            c.nbytes(v[torch.bfloat16], cw[torch.bfloat16]), device, reps))
    skip = rand(nt, h, w, c0)
    o1, o2 = cws(s0['outc']['c1']), cws(s0['outc']['c2'])
    rc = cfg.residual_ch
    out.append(c.site(
        'outc', lambda dt: conv_chain_add2_res(
            x0[dt], skip[dt], xin[dt], o1[dt], None, o2[dt], None, cfg.act,
            'none', rc),
        lambda dt: conv_chain_reference(
            x0[dt], o1[dt], None, o2[dt], None, cfg.act, 'none', x2=skip[dt],
            x_res=xin[dt], res_ch=rc),
        None, c.conv_flops(nt, h, w, c0, c0)
        + c.conv_flops(nt, h, w, c0, o2[torch.float32].cout),
        c.nbytes(x0[torch.bfloat16], skip[torch.bfloat16],
                 xin[torch.bfloat16], o1[torch.bfloat16],
                 o2[torch.bfloat16]), device, reps))
    return out


def main(argv=None):
    ap = c.parser(__doc__)
    ap.add_argument('--reps', type=int, default=5)
    args = ap.parse_args(argv)
    device, dtype = c.setup(args)
    cfg, raw, params = c.net(args, device, dtype)
    gen = torch.Generator(device=device).manual_seed(c.SEED)
    shape = (1, args.frames, args.height, args.width, cfg.effective_in_ch)
    x32 = torch.rand(shape, generator=gen, device=device)
    x = x32.to(dtype)

    with torch.no_grad():
        before = c.launches()
        ms = c.median_ms(lambda: wnet_apply(params, x, cfg), device,
                         args.reps)
        per_forward = {k: v // (args.reps + 2) for k, v in
                       c.launches_since(before).items()}
        with c.plain_route():
            plain_ms = c.median_ms(lambda: wnet_apply(params, x, cfg),
                                   device, args.reps)
            ref = wnet_apply(raw, x32, cfg)
        err, tol = c.held('forward fp32', wnet_apply(raw, x32, cfg), ref,
                          c.FP32_TOL)
        del ref
        sites = blocks(raw['stage0'], x32, cfg, device, args.reps, gen)
    stages = cfg.stage_num
    total = {k: stages * sum(PER_STAGE[s['site']] * s[k] for s in sites)
             for k in ('ms', 'plain_ms')}
    return c.emit('profile_blocks', device, {
        'shape': list(shape), 'dtype': 'bf16', 'chns': list(cfg.chns),
        'forward': {'ms': ms, 'plain_ms': plain_ms,
                    'launches_per_forward': per_forward,
                    'max_abs_err_fp32': err, 'tol_fp32': tol},
        'blocks': sites, 'per_stage_counts': PER_STAGE,
        'sum_of_blocks_ms': total['ms'],
        'sum_of_blocks_plain_ms': total['plain_ms']})


if __name__ == '__main__':
    main(sys.argv[1:])
