#!/usr/bin/env python3
"""One-off measurements behind the layout choices of the port's pipelined
conv kernels, on one NVIDIA GPU.

    python3 tools/torch_kernel_variants.py --ptxas [--csrc DIR]  # figures
    python3 tools/torch_kernel_variants.py [--group GROUP] [--out FILE]

``--ptxas`` prints what ``nvcc -Xptxas -v`` reports (registers, spills)
for the kernels of the pipelined sources (of ``--csrc``, by default the
package's; another tree's to compare). Without it the tool also times a
group (k2, k3, k5, k6 or k6parts) of layouts that the sources do not
keep against the sources:

- ``k3``: K3 conv_s2 as the sources hold it (8 x 16 output tiles, a
  2-stage ring, two blocks an SM) against 16 x 16 tiles with 3 stages and
  8 x 16 tiles with 4 (one block an SM), and the input patch stored
  unsplit (py * PW + px, not split by column parity);
- ``k5``: K5 at a push's one-frame sites (bibuffer_conv), at
  push_block's 8-frame sites and at 2 and 4 frames (bibuffer_multi), the
  sources' choice by the grid's waves against the 8 x 16 tile with 2
  stages (two blocks an SM) and the 16 x 16 tile with 4 stages (one block
  an SM) everywhere;
- ``k2``: K2 conv_chain at its forward and push sites, the sources'
  output tiles (8 x 30 with 2 stages, two blocks an SM, without x2; 14 x
  30, one block an SM, with x2) against 14 x 30 with 3 stages without x2
  too;
- ``k6``: K6 bibuffer_chain at a push's MemCvBlock sites (270x480x128 and
  135x240x256, one frame, bidirectional and causal), the sources' 6 x 30
  tile with a 2-stage ring, two blocks an SM where they fit, against 8 x
  30 and 4 x 30, a 3-stage ring, one block an SM (no register cap), and
  every 64-channel block of conv1 on the tile's ring (no lane rule); the
  kept sources' runs also time the two K5 steps the route takes instead;
- ``k6parts``: where K6's time goes, timing only (the outputs are wrong by
  design, so nothing is checked): K6 at the bidirectional sites and the
  causal 128-channel one with a part switched off at run time (conv1,
  conv2, the y / s2' stores, s2's ring loads, the state copies), and
  conv1 alone at 8 x 30.

A dropped layout is rebuilt from a copy of ``bsvd_tpu_torch/csrc`` with
the text edits listed in ``VARIANTS``, in its own directory under the
gitignored ``bsvd_tpu_torch/_build/variants/``; the product sources keep
one layout and no build-time switch. The runs with the kept sources also
time K1 at the train step's recomputed chain site (88 frames of 96x96,
64 -> 64 with x2, the 64-channel block) against the same conv at Cout 128
(the 128-channel block: what padding CoutP to 128 would cost).

Each run is a child process that builds its sources and times each site
with CUDA events (median of 20 after 3 warm-up calls), after checking the
output against the plain version in fp32 (2^-6 of max(1, max|ref|),
chip_smoke.py's bf16 tolerance). The variants run in turns, the kept
sources first, in the middle and last, so that drift shows. Prints one
JSON object per run and, with ``--out``, writes them all to that file.
"""

import argparse
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / 'bsvd_tpu_torch' / 'csrc'
S2_CFG = 'using S2Cfg = PipeCfg<2, 8, 128, 1, 2>;'
K5_SMALL = ': launch_bibuf_pipe<PipeCfg<1, 8, 128, 1, 2>>(a, stream);'
K5_BIG = '? launch_bibuf_pipe<PipeCfg<1, 16, 128, 1, 4>>(a, stream)'
K2_NOX2 = ('ChainCfg<1, 16, 8, 2>', 'ChainCfg<1, 64, 8, 2>')
K6_CFG = 'return launch_bichain_bf16<BiChainCfg<6, 2>>(a, stream);'
K6_MINB = 'auto kern = 2 * (smem + 1024) <= 233472 ? bibuf_chain_bf16_kernel<K, 2>'
# a condition false at run time that the compiler cannot fold away
K6_OFF = 'a.act1 == 99'
K6_NB2 = 'const int ks2 = cdiv(a.C1, 16), nb2 = a.CoutP / K::BN;'
K6_HALO = ('ln.hb0 = a.causal ? (lo < nb1 ? lo : nb1) : 0;',
           'ln.nh = a.causal ? nb1 - ln.hb0 : (hi < nb1 ? hi : nb1);')
# name -> {source file: [(text, replacement), ...]}
VARIANTS = {
    'kept': {},
    'k5_16x16': {'bibuffer_conv.cu': [
        (K5_SMALL, K5_SMALL.replace('<1, 8, 128, 1, 2>', '<1, 16, 128, 1, 4>'))]},
    'k5_8x16': {'bibuffer_conv.cu': [
        (K5_BIG, K5_BIG.replace('<1, 16, 128, 1, 4>', '<1, 8, 128, 1, 2>'))]},
    'k2_th14': {'conv_chain.cu': [(c, c.replace(', 8, 2>', ', 14, 3>'))
                                  for c in K2_NOX2]},
    'k6_th8': {'bibuffer_conv.cu': [(K6_CFG, K6_CFG.replace('<6,', '<8,'))]},
    'k6_th4': {'bibuffer_conv.cu': [(K6_CFG, K6_CFG.replace('<6,', '<4,'))]},
    'k6_halo_all': {'bibuffer_conv.cu': [
        (K6_HALO[0], 'ln.hb0 = 0;'), (K6_HALO[1], 'ln.nh = nb1;')]},
    'k6_1blk': {'bibuffer_conv.cu': [
        (K6_MINB, K6_MINB.replace('2 * (smem + 1024) <= 233472', 'false'))]},
    'k6_3stage': {'bibuffer_conv.cu': [
        (K6_CFG, K6_CFG.replace('<6, 2>', '<6, 3>'))]},
    'k6_no_conv2': {'bibuffer_conv.cu': [
        (K6_NB2, K6_NB2.replace('a.CoutP / K::BN', '0'))]},
    'k6_no_conv1': {'bibuffer_conv.cu': [
        ('nb1 = a.C1P / 64, n1 = nb1 * nk1;', 'nb1 = 0, n1 = nb1 * nk1;')]},
    'k6_no_stores': {'bibuffer_conv.cu': [
        ('        if (own) {', f'        if (own && {K6_OFF}) {{'),
        ('          if (o >= a.Cout) continue;',
         f'          if (o >= a.Cout || !({K6_OFF})) continue;')]},
    'k6_no_s2load': {'bibuffer_conv.cu': [
        ('if (!ln.mid_slice(k0)) load_s2(sg, k0);',
         f'if (!ln.mid_slice(k0) && {K6_OFF}) load_s2(sg, k0);')]},
    'k6_no_copies': {'bibuffer_conv.cu': [
        ('  if (!a.causal) copy_s2_lanes(s2n, s2, a, st, oy0, ox0, K::TH, '
         'K::TW);', f'  if (!a.causal && {K6_OFF}) copy_s2_lanes(s2n, s2, a, '
         'st, oy0, ox0, K::TH, K::TW);'),
        ('  copy_next_state(static_cast<bf16*>(a.s1n), s, 1, st, oy0, ox0, '
         'K::TH,', f'  if ({K6_OFF}) copy_next_state(static_cast<bf16*>'
         '(a.s1n), s, 1, st, oy0, ox0, K::TH,')]},
    'k6_th8_no_conv2': {'bibuffer_conv.cu': [
        (K6_NB2, K6_NB2.replace('a.CoutP / K::BN', '0')),
        (K6_CFG, K6_CFG.replace('<6,', '<8,'))]},

    'th8_4stage': {'conv_s2.cu': [
        (S2_CFG, 'using S2Cfg = PipeCfg<2, 8, 128, 1, 4>;')]},
    'th16_3stage': {'conv_s2.cu': [
        (S2_CFG, 'using S2Cfg = PipeCfg<2, 16, 128, 1, 3>;')]},
    'unsplit': {'conv_pipe.cuh': [
        ('PROWS = S == 2 ? PH * 2 * SW : PH * PW', 'PROWS = PH * PW'),
        ('const int col = S == 2 ? px >> 1 : px;', 'const int col = px;'),
        ('const int r = S == 2 ? (py * 2 + (px & 1)) * SW + col : '
         'py * PW + px;', 'const int r = py * PW + px;')]},
}
# the variants of each group, in turns, the kept sources first, in the
# middle and last
GROUPS = {'k3': ['kept', 'th8_4stage', 'unsplit', 'th16_3stage', 'kept',
                 'th16_3stage', 'unsplit', 'th8_4stage', 'kept'],
          'k5': ['kept', 'k5_16x16', 'k5_8x16', 'kept', 'k5_8x16',
                 'k5_16x16', 'kept'],
          'k2': ['kept', 'k2_th14', 'kept', 'k2_th14', 'kept'],
          'k6': ['kept', 'k6_th8', 'k6_th4', 'k6_halo_all', 'k6_1blk',
                 'k6_3stage', 'kept', 'k6_3stage', 'k6_1blk', 'k6_halo_all',
                 'k6_th4', 'k6_th8', 'kept'],
          'k6parts': ['kept', 'k6_no_conv2', 'k6_no_conv1', 'k6_no_stores',
                      'k6_no_s2load', 'k6_no_copies', 'k6_th8_no_conv2',
                      'kept']}
# (frames, H, W, Cin, Cout) of K3's sites in a BSVD-c64 forward and push
S2_SITES = [(10, 540, 960, 64, 128), (10, 270, 480, 128, 256),
            (1, 540, 960, 64, 128), (1, 270, 480, 128, 256)]
# (frames, H, W, Cin, Cout): K1 with x2 at the train step's chain site
K1_SITES = [(88, 96, 96, 64, 64), (88, 96, 96, 64, 128)]
# (frames, Cin, Cres, Cout): K2's sites of a forward (10 frames of 540x960)
# and a push (one); Cres > 0: x2 and the residual on 3 channels
K2_SITES = [(nt, c, cres, co) for nt in (10, 1)
            for c, cres, co in ((4, 0, 64), (64, 0, 64), (64, 4, 64),
                                (64, 64, 3))]
# (frames, H, W, C, causal): K5 at the sites of a push (one frame) and of
# a push_block (8), and the bidirectional ones at 2 and 4 frames, where
# the grid of 16 x 16 blocks is 4.1, 7.7, 8.2 and 15.5 waves of 132 SMs:
# around the kernel's choice of tile
K5_SITES = [(f, h, w, c, causal)
            for f in (1, 2, 4, 8)
            for h, w, c, causal in ((270, 480, 128, False),
                                    (135, 240, 256, False),
                                    (135, 240, 256, True))
            if f in (1, 8) or not causal]
# (H, W, C, causal): K6 at a push's MemCvBlock sites (C -> C -> C)
K6_SITES = [(h, w, c, causal) for causal in (False, True)
            for h, w, c in ((270, 480, 128), (135, 240, 256))]
PIPE_SOURCES = ('conv3x3.cu', 'conv_s2.cu', 'conv_ps.cu', 'bibuffer_conv.cu',
                'conv_chain.cu')


def variant_csrc(name):
    """The source directory of a variant: the product sources, or an
    edited copy of them."""
    if not VARIANTS[name]:
        return CSRC
    dst = ROOT / 'bsvd_tpu_torch' / '_build' / 'variants' / name / 'csrc'
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(CSRC, dst)
    for fname, edits in VARIANTS[name].items():
        path = dst / fname
        text = path.read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f'{name}: {fname} does not hold {old!r} '
                                 'exactly once')
            text = text.replace(old, new)
        path.write_text(text)
    return dst


def timed(fn):
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(20):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def child(name, group):
    sys.path.insert(0, str(ROOT))
    import torch
    from bsvd_tpu_torch.ops import _build
    from bsvd_tpu_torch.ops._pack import ConvWeights
    from bsvd_tpu_torch.ops.bibuffer_conv import (bibuffer_chain,
                                                  bibuffer_chain_reference,
                                                  bibuffer_conv,
                                                  bibuffer_conv_reference,
                                                  bibuffer_multi,
                                                  bibuffer_multi_reference)
    from bsvd_tpu_torch.ops.conv_chain import (conv_chain,
                                               conv_chain_add2_res,
                                               conv_chain_reference)
    from bsvd_tpu_torch.ops.conv3x3 import conv3x3, conv3x3_reference
    from bsvd_tpu_torch.ops.conv_s2 import conv_s2, conv_s2_reference
    if not torch.cuda.is_available():
        raise SystemExit('torch_kernel_variants: no CUDA device')
    torch.backends.cudnn.allow_tf32 = False
    _build.CSRC = variant_csrc(name)
    _build.lib()
    g = torch.Generator(device='cuda').manual_seed(0)

    def weights(c, co):
        return ConvWeights(torch.randn((co, c, 3, 3), generator=g,
                                       device='cuda') * (2 / (9 * c)) ** 0.5,
                           torch.rand((co,), generator=g, device='cuda') - .5)

    def act_in(shape):
        return torch.rand(shape, generator=g, device='cuda').to(torch.bfloat16)

    def site(kernel, shape, run, ref):
        got, want = run(), ref()
        if isinstance(got, tuple):            # K5 / K6: (y, states)
            if not torch.equal(got[1].float(), want[1]):
                raise AssertionError(f'{name} {kernel} {shape}: state')
            got, want = got[0], want[0]
        err = (got.float() - want).abs().max().item()
        tol = 2 ** -6 * max(1.0, want.abs().max().item())
        if not err <= tol:
            raise AssertionError(f'{name} {kernel} {shape}: {err} > {tol}')
        del got, want
        return {'kernel': kernel, 'shape': list(shape), 'ms': timed(run),
                'max_abs_err': err}

    out = {'variant': name, 'edits': VARIANTS[name], 'sites': []}
    if group == 'k2':
        for nt, c, cres, co in K2_SITES:
            x, c1, c2 = act_in((nt, 540, 960, c)), weights(c, 64), \
                weights(64, co)
            if cres:
                x2, xr = act_in(x.shape), act_in((nt, 540, 960, cres))
                run = (lambda: conv_chain_add2_res(x, x2, xr, c1, None, c2,
                                                   None, 'relu6', 'none', 3))
                ref = (lambda: conv_chain_reference(
                    x.float(), c1, None, c2, None, 'relu6', 'none',
                    x2=x2.float(), x_res=xr.float(), res_ch=3))
            else:
                run = (lambda: conv_chain(x, c1, None, c2, None, 'relu6',
                                          'relu6'))
                ref = (lambda: conv_chain_reference(x.float(), c1, None, c2,
                                                    None, 'relu6', 'relu6'))
            out['sites'].append(site('conv_chain', (nt, c, cres, co), run,
                                     ref))
        print(json.dumps(out), flush=True)
        return
    if group == 'k6parts':
        for h, w, c, causal in K6_SITES[:3]:
            x, s1, s2 = (act_in((1, h, w, c)) for _ in range(3))
            c1, c2 = weights(c, c), weights(c, c)
            ms = timed(lambda: bibuffer_chain(x, s1, s2, c1, None, c2, None,
                                              causal=causal))
            out['sites'].append({'kernel': 'bibuffer_chain',
                                 'shape': [h, w, c, causal], 'ms': ms})
        print(json.dumps(out), flush=True)
        return
    if group == 'k6':
        for h, w, c, causal in K6_SITES:
            x, s1, s2 = (act_in((1, h, w, c)) for _ in range(3))
            c1, c2 = weights(c, c), weights(c, c)
            kw = dict(causal=causal)
            out['sites'].append(site(
                'bibuffer_chain', (h, w, c, causal),
                lambda: bibuffer_chain(x, s1, s2, c1, None, c2, None, **kw),
                lambda: bibuffer_chain_reference(x.float(), s1.float(),
                                                 s2.float(), c1, None, c2,
                                                 None, **kw)))
            if name != 'kept':
                continue

            def two_k5():
                y1, n1 = bibuffer_conv(x, s1, c1, **kw)
                y, n2 = bibuffer_conv(y1, s2, c2, **kw)
                return y, n1, n2
            out['sites'].append(site(
                'bibuffer_conv_x2', (h, w, c, causal), two_k5,
                lambda: bibuffer_chain_reference(x.float(), s1.float(),
                                                 s2.float(), c1, None, c2,
                                                 None, **kw)))
        print(json.dumps(out), flush=True)
        return
    if group == 'k5':
        for f, h, w, c, causal in K5_SITES:
            x, st, cw = act_in((f, h, w, c)), act_in((1, h, w, c)), \
                weights(c, c)
            fn, ref = ((bibuffer_conv, bibuffer_conv_reference) if f == 1
                       else (bibuffer_multi, bibuffer_multi_reference))
            out['sites'].append(site(
                fn.__name__, (f, h, w, c, causal),
                lambda: fn(x, st, cw, causal=causal),
                lambda: ref(x.float(), st.float(), cw, causal=causal)))
        print(json.dumps(out), flush=True)
        return
    for nt, h, w, c, co in S2_SITES:
        x, cw = act_in((nt, h, w, c)), weights(c, co)
        out['sites'].append(site(
            'conv_s2', (nt, h, w, c, co), lambda: conv_s2(x, cw),
            lambda: conv_s2_reference(x.float(), cw)))
    if name == 'kept':
        for nt, h, w, c, co in K1_SITES:
            x, x2, cw = act_in((nt, h, w, c)), act_in((nt, h, w, c)), \
                weights(c, co)
            out['sites'].append(site(
                'conv3x3_x2', (nt, h, w, c, co),
                lambda: conv3x3(x, cw, x2=x2),
                lambda: conv3x3_reference(x.float(), cw, x2=x2.float())))
    print(json.dumps(out), flush=True)


def ptxas(csrc=CSRC):
    """Registers, spills and shared memory of each kernel of the pipelined
    sources in ``csrc``, as ``nvcc -Xptxas -v`` reports them."""
    sys.path.insert(0, str(ROOT))
    from bsvd_tpu_torch.ops import _build
    procs = [(src, subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, '-Xptxas', '-v', '-c', '-o',
         os.devnull, str(Path(csrc) / src)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True))
        for src in PIPE_SOURCES if (Path(csrc) / src).exists()]
    lines = []
    for src, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f'nvcc failed on {src}:\n{log}')
        lines += [f'{src}: {ln.strip()}' for ln in log.splitlines()
                  if re.search(r'Compiling entry|Used \d+ registers|spill',
                               ln)]
    return lines


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--child', choices=sorted(VARIANTS))
    ap.add_argument('--group', choices=sorted(GROUPS), default='k3')
    ap.add_argument('--ptxas', action='store_true')
    ap.add_argument('--csrc', default=str(CSRC))
    ap.add_argument('--out')
    args = ap.parse_args()
    if args.child:
        child(args.child, args.group)
        return
    lines = ptxas(args.csrc)
    print('\n'.join(lines), flush=True)
    if args.ptxas:
        return
    runs = []
    for name in GROUPS[args.group]:
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              '--child', name, '--group', args.group],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise SystemExit(f'{name} failed:\n{res.stdout}\n{res.stderr}')
        print(res.stdout.strip(), flush=True)
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
    if args.out:
        with open(args.out, 'w') as f:
            json.dump({'ptxas': lines, 'runs': runs}, f, indent=1)


if __name__ == '__main__':
    main()
