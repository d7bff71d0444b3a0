#!/usr/bin/env python3
"""One-off measurements behind the layout choices of the port's pipelined
conv kernels, on one NVIDIA GPU.

    python3 tools/torch_kernel_variants.py --ptxas     # the figures only
    python3 tools/torch_kernel_variants.py [--out variants.json]

``--ptxas`` prints what ``nvcc -Xptxas -v`` reports (registers, spills)
for the kernels of the pipelined sources. Without it the tool also times
K3 conv_s2 as the sources hold it (8 x 16 output tiles, a 2-stage ring,
two blocks an SM) against layouts they do not keep: 16 x 16 tiles with 3
stages and 8 x 16 tiles with 4 (one block an SM), and the input patch
stored unsplit (py * PW + px, not split by column parity).
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
# name -> {source file: [(text, replacement), ...]}
VARIANTS = {
    'kept': {},
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
ORDER = ['kept', 'th8_4stage', 'unsplit', 'th16_3stage', 'kept',
         'th16_3stage', 'unsplit', 'th8_4stage', 'kept']
# (frames, H, W, Cin, Cout) of K3's sites in a BSVD-c64 forward and push
S2_SITES = [(10, 540, 960, 64, 128), (10, 270, 480, 128, 256),
            (1, 540, 960, 64, 128), (1, 270, 480, 128, 256)]
# (frames, H, W, Cin, Cout): K1 with x2 at the train step's chain site
K1_SITES = [(88, 96, 96, 64, 64), (88, 96, 96, 64, 128)]
PIPE_SOURCES = ('conv3x3.cu', 'conv_s2.cu', 'conv_ps.cu')


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


def child(name):
    sys.path.insert(0, str(ROOT))
    import torch
    from bsvd_tpu_torch.ops import _build
    from bsvd_tpu_torch.ops._pack import ConvWeights
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
        err = (got.float() - want).abs().max().item()
        tol = 2 ** -6 * max(1.0, want.abs().max().item())
        if not err <= tol:
            raise AssertionError(f'{name} {kernel} {shape}: {err} > {tol}')
        del got, want
        return {'kernel': kernel, 'shape': list(shape), 'ms': timed(run),
                'max_abs_err': err}

    out = {'variant': name, 'edits': VARIANTS[name], 'sites': []}
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


def ptxas():
    """Registers, spills and shared memory of each kernel of the pipelined
    sources, as ``nvcc -Xptxas -v`` reports them."""
    sys.path.insert(0, str(ROOT))
    from bsvd_tpu_torch.ops import _build
    lines = []
    for src in PIPE_SOURCES:
        res = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, '-Xptxas', '-v', '-c', '-o',
             os.devnull, str(CSRC / src)],
            capture_output=True, text=True, check=True)
        log = res.stdout + res.stderr
        lines += [f'{src}: {ln.strip()}' for ln in log.splitlines()
                  if re.search(r'Compiling entry|Used \d+ registers|spill',
                               ln)]
    return lines


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--child', choices=sorted(VARIANTS))
    ap.add_argument('--ptxas', action='store_true')
    ap.add_argument('--out')
    args = ap.parse_args()
    if args.child:
        child(args.child)
        return
    lines = ptxas()
    print('\n'.join(lines), flush=True)
    if args.ptxas:
        return
    runs = []
    for name in ORDER:
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              '--child', name], capture_output=True,
                             text=True)
        if res.returncode != 0:
            raise SystemExit(f'{name} failed:\n{res.stdout}\n{res.stderr}')
        print(res.stdout.strip(), flush=True)
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
    if args.out:
        with open(args.out, 'w') as f:
            json.dump({'ptxas': lines, 'runs': runs}, f, indent=1)


if __name__ == '__main__':
    main()
