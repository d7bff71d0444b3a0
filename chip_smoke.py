#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as one JSON object on its own line:

0. device: the card's name, and ``nvidia-smi``'s name and power limit.
1. build: nvcc compiles ``bsvd_tpu_torch/csrc/*.cu`` for sm_90a.
2. kernels: each kernel (K1 conv3x3, K2 conv_chain, K3 conv_s2, K4 conv_ps)
   in every variant the BSVD-c64 forward uses, at that forward's site shapes
   for a 10-frame 540x960 clip, in bf16, against its plain PyTorch version
   run in fp32 on the same bf16 values (cuDNN TF32 off); kernel and plain
   times are CUDA-event medians of 10 runs after warm-up.
3. main path: ``build_network`` BSVD-c64 (random weights from a seed),
   ``denoise_seq`` of 3 clips of (10, 3, 540, 960) at sigma 20/255 in bf16,
   for the bidirectional and the causal net; the launch counters must show
   16 / 4 / 4 / 4 launches of K1 / K2 / K3 / K4 per forward, and
   F.conv2d is made to raise while the path runs.
4. parity: the same weights on a reduced clip, fp32 kernels on the card
   against the plain fp32 path on the CPU, and the bf16 kernel path's PSNR
   against that fp32 output beside the plain bf16 path's (CPU); then bf16
   against fp32 kernels at 540p (max |diff| and PSNR).

Any failed check raises (exit code != 0). The line before the last is
``{"kernels": [...]}``: per kernel, its launches in phase 3 (6 forwards),
the largest max |diff| of phase 2, and ``ms`` / ``plain_ms``, the phase-2
site medians summed at the counts one bidirectional forward runs them.
The last line is ``{"ok": true, "device": {...}}``.
"""

import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from bsvd_tpu_torch.archs import build_network  # noqa: E402
from bsvd_tpu_torch.archs.wnet_arch import wnet_apply  # noqa: E402
from bsvd_tpu_torch.models.seq_inference import denoise_seq  # noqa: E402
from bsvd_tpu_torch.ops import _build  # noqa: E402
from bsvd_tpu_torch.ops._pack import ConvWeights  # noqa: E402
from bsvd_tpu_torch.ops.conv3x3 import (conv3x3, conv3x3_reference,  # noqa: E402
                                        conv_ps, conv_ps_reference)
from bsvd_tpu_torch.ops.conv_chain import (conv_chain,  # noqa: E402
                                           conv_chain_add2_res,
                                           conv_chain_reference)
from bsvd_tpu_torch.ops.conv_s2 import conv_s2, conv_s2_reference  # noqa: E402

SEED = 0
T, H, W = 10, 540, 960
SIGMA = 20 / 255
C64 = {'type': 'BSVD', 'chns': [64, 128, 256], 'mid_ch': 64, 'interm_ch': 64,
       'norm': 'none', 'act': 'relu6', 'seed': SEED}
# bf16 output rounding (2^-8 relative) plus bf16 rounding of summed inputs
# and of the chain's intermediate, relative to max(1, max|ref|)
BF16_TOL = 2 ** -6
# fp32 kernels vs the fp32 plain path: summation order only
FP32_TOL = 1e-4
KERNELS = {
    'conv3x3': (conv3x3, 'bsvd_tpu_torch/csrc/conv3x3.cu',
                'bsvd_tpu/ops/conv3x3.py:309'),
    'conv_chain': (conv_chain, 'bsvd_tpu_torch/csrc/conv_chain.cu',
                   'bsvd_tpu/ops/conv_chain.py:213'),
    'conv_s2': (conv_s2, 'bsvd_tpu_torch/csrc/conv_s2.cu',
                'bsvd_tpu/ops/conv_s2.py:155'),
    'conv_ps': (conv_ps, 'bsvd_tpu_torch/csrc/conv3x3.cu',
                'bsvd_tpu/ops/conv3x3.py:797'),
}
PER_FORWARD = {'conv3x3': 16, 'conv_chain': 4, 'conv_s2': 4, 'conv_ps': 4}


def emit(obj):
    print(json.dumps(obj), flush=True)


def counts():
    return {k: v[0].launches for k, v in KERNELS.items()}


def reset_counts():
    for fn, _, _ in KERNELS.values():
        fn.launches = 0


def median_ms(fn, reps=10, warmup=2):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def rel_err(got, ref):
    ref = ref.float()
    err = (got.float() - ref).abs().max().item()
    return err, max(1.0, ref.abs().max().item())


def psnr(got, ref):
    """PSNR in dB of ``got`` against ``ref``, both clipped to [0, 1]."""
    mse = ((got.float().clamp(0, 1) - ref.float().clamp(0, 1)) ** 2).mean()
    return 10 * math.log10(1 / mse.item()) if mse > 0 else float('inf')


# ---------------------------------------------------------------------------
# phase 2: every kernel variant of the forward, at its site shapes
# ---------------------------------------------------------------------------

def _sites():
    """(kernel, variant, per-forward count in the bidirectional net,
    make(g) -> (kernel call, plain call in fp32, plain call in bf16))."""
    h2, w2, h4, w4 = H // 2, W // 2, H // 4, W // 4

    def conv(cin, cout, g):
        w = torch.randn((cout, cin, 3, 3), generator=g, device='cuda') * \
            math.sqrt(2 / (9 * cin))
        b = (torch.rand((cout,), generator=g, device='cuda') * 2 - 1) / \
            math.sqrt(9 * cin)
        return ConvWeights(w, b)

    def act_in(shape, g):
        return torch.rand(shape, generator=g, device='cuda').to(torch.bfloat16)

    def k1(h, w, c, shift, add2):
        def make(g):
            x = act_in((T, h, w, c), g)
            x2 = act_in((T, h, w, c), g) if add2 else None
            cw = conv(c, c, g)
            kw = dict(t_len=T, shift=shift, act='relu6')
            return (lambda: conv3x3(x, cw, x2=x2, **kw),
                    lambda: conv3x3_reference(
                        x.float(), cw, x2=None if x2 is None else x2.float(),
                        **kw),
                    lambda: conv3x3_reference(x, cw, x2=x2, **kw))
        return make

    def k2(c, cres, cout):
        def make(g):
            x = act_in((T, H, W, c), g)
            c1, c2 = conv(c, 64, g), conv(64, cout, g)
            if not cres:
                return (lambda: conv_chain(x, c1, None, c2, None, 'relu6',
                                           'relu6'),
                        lambda: conv_chain_reference(x.float(), c1, None, c2,
                                                     None, 'relu6', 'relu6'),
                        lambda: conv_chain_reference(x, c1, None, c2, None,
                                                     'relu6', 'relu6'))
            x2, xr = act_in(x.shape, g), act_in((T, H, W, cres), g)
            return (lambda: conv_chain_add2_res(x, x2, xr, c1, None, c2, None,
                                                'relu6', 'none', 3),
                    lambda: conv_chain_reference(
                        x.float(), c1, None, c2, None, 'relu6', 'none',
                        x2=x2.float(), x_res=xr.float(), res_ch=3),
                    lambda: conv_chain_reference(
                        x, c1, None, c2, None, 'relu6', 'none', x2=x2,
                        x_res=xr, res_ch=3))
        return make

    def k3(h, w, c, cout):
        def make(g):
            x = act_in((T, h, w, c), g)
            cw = conv(c, cout, g)
            return (lambda: conv_s2(x, cw, act='relu6'),
                    lambda: conv_s2_reference(x.float(), cw, act='relu6'),
                    lambda: conv_s2_reference(x, cw, act='relu6'))
        return make

    def k4(h, w, c, cout):
        def make(g):
            x = act_in((T, h, w, c), g)
            cw = conv(c, cout, g)
            return (lambda: conv_ps(x, cw),
                    lambda: conv_ps_reference(x.float(), cw),
                    lambda: conv_ps_reference(x, cw))
        return make

    return [
        ('conv3x3', 'tsm_270x480_c128', 6, k1(h2, w2, 128, 'tsm', False)),
        ('conv3x3', 'tsm_add2_270x480_c128', 2, k1(h2, w2, 128, 'tsm', True)),
        ('conv3x3', 'tsm_135x240_c256', 8, k1(h4, w4, 256, 'tsm', False)),
        ('conv3x3', 'causal_270x480_c128', 0,
         k1(h2, w2, 128, 'causal', False)),
        ('conv3x3', 'causal_add2_270x480_c128', 0,
         k1(h2, w2, 128, 'causal', True)),
        ('conv3x3', 'causal_135x240_c256', 0,
         k1(h4, w4, 256, 'causal', False)),
        ('conv_chain', 'inc_540x960_4_64_64', 1, k2(4, 0, 64)),
        ('conv_chain', 'inc_540x960_64_64_64', 1, k2(64, 0, 64)),
        ('conv_chain', 'outc_res_540x960_64_64_64_xres4', 1, k2(64, 4, 64)),
        ('conv_chain', 'outc_res_540x960_64_64_3_xres64', 1, k2(64, 64, 3)),
        ('conv_s2', 's2_540x960_64_128', 2, k3(H, W, 64, 128)),
        ('conv_s2', 's2_270x480_128_256', 2, k3(h2, w2, 128, 256)),
        ('conv_ps', 'ps_135x240_256_512', 2, k4(h4, w4, 256, 512)),
        ('conv_ps', 'ps_270x480_128_256', 2, k4(h2, w2, 128, 256)),
    ]


def phase_kernels():
    g = torch.Generator(device='cuda').manual_seed(SEED)
    summary = {k: {'max_abs_err': 0.0, 'ms': 0.0, 'plain_ms': 0.0}
               for k in KERNELS}
    for kernel, variant, per_fwd, make in _sites():
        run, plain32, plain_bf16 = make(g)
        got = run()
        torch.cuda.synchronize()
        ref = plain32()
        err, scale = rel_err(got, ref)
        tol = BF16_TOL * scale
        del ref
        ms = median_ms(run)
        plain_ms = median_ms(plain_bf16)
        emit({'phase': 'kernel', 'kernel': kernel, 'variant': variant,
              'shape_out': list(got.shape), 'max_abs_err': err, 'tol': tol,
              'ms': ms, 'plain_ms': plain_ms, 'per_forward': per_fwd})
        if not err <= tol:
            raise AssertionError(f'{kernel}/{variant}: max|diff| {err} > {tol}')
        s = summary[kernel]
        s['max_abs_err'] = max(s['max_abs_err'], err)
        s['ms'] += per_fwd * ms
        s['plain_ms'] += per_fwd * plain_ms
        del got
        torch.cuda.empty_cache()
    return summary


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def _clips(rng, n):
    """Smooth synthetic clean clips (T, 3, H, W) in [0, 1] and their noisy
    versions at SIGMA."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    out = []
    for _ in range(n):
        f = rng.uniform(0.005, 0.03, size=(3, 2)).astype(np.float32)
        ph = rng.uniform(0, 6.28, size=(3, T)).astype(np.float32)
        clean = np.empty((T, 3, H, W), np.float32)
        for t in range(T):
            for c in range(3):
                clean[t, c] = 0.5 + 0.4 * np.sin(f[c, 0] * yy + f[c, 1] * xx
                                                 + ph[c, t])
        noisy = clean + SIGMA * rng.standard_normal(clean.shape,
                                                    dtype=np.float32)
        out.append((clean, noisy.astype(np.float32)))
    return out


class _NoConv2d:
    """Make F.conv2d raise while the main path runs."""

    def __enter__(self):
        self.orig = F.conv2d

        def refuse(*a, **k):
            raise AssertionError('F.conv2d called on the kernel path')
        F.conv2d = refuse

    def __exit__(self, *exc):
        F.conv2d = self.orig


def _check_out(out, clip):
    if out.shape != clip.shape:
        raise AssertionError(f'output shape {out.shape} != {clip.shape}')
    if not np.isfinite(out).all():
        raise AssertionError('non-finite output')
    if out.min() < 0 or out.max() > 1:
        raise AssertionError('output outside [0, 1]')


def phase_main(clips):
    nets = {mode: build_network(dict(C64, shift_mode=mode)).to('cuda')
            for mode in ('TSM', 'TSM_toFutureOnly')}
    outs = {}
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with _NoConv2d():
        for mode, net in nets.items():
            before = counts()
            t0 = time.perf_counter()
            outs[mode] = [denoise_seq(net, None, noisy, noise_sigma=SIGMA,
                                      compute_dtype=torch.bfloat16)
                          for _, noisy in clips]
            wall = (time.perf_counter() - t0) / len(clips)
            delta = {k: v - before[k] for k, v in counts().items()}
            for k, n in PER_FORWARD.items():
                if delta[k] != n * len(clips):
                    raise AssertionError(f'{mode}: {k} launched {delta[k]} '
                                         f'times in {len(clips)} forwards, '
                                         f'expected {n} each')
            for (clean, _), out in zip(clips, outs[mode]):
                _check_out(out, clean)
            emit({'phase': 'main', 'shift_mode': mode, 'clips': len(clips),
                  'launches_per_forward': {k: v // len(clips)
                                           for k, v in delta.items()},
                  'denoise_seq_s_per_clip': wall})
    launches = counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # device time of one 10-frame forward, input resident on the card
    for mode, net in nets.items():
        x = torch.from_numpy(clips[0][1]).cuda().to(torch.bfloat16)
        x = torch.cat([x, torch.full_like(x[:, :1], SIGMA)], dim=1)
        x = x.permute(0, 2, 3, 1)[None].contiguous()
        p = net.prepared(x.device, torch.bfloat16)
        with torch.no_grad():
            ms = median_ms(lambda: wnet_apply(p, x, net.cfg), reps=5)
        emit({'phase': 'main_timing', 'shift_mode': mode,
              'forward_ms_median_of_5': ms, 'frames': T,
              'peak_allocated_gb': peak_gb})
    return nets, outs, launches


# ---------------------------------------------------------------------------
# phase 4: whole-net parity
# ---------------------------------------------------------------------------

def phase_parity(nets, clips, outs):
    net = nets['TSM']
    rng = np.random.default_rng(SEED + 1)
    x = torch.from_numpy(rng.uniform(0, 1, (1, 4, 128, 224, 4))
                         .astype(np.float32))
    with torch.no_grad():
        ref = wnet_apply(net.prepared('cpu', torch.float32), x, net.cfg)
        plain16 = wnet_apply(net.prepared('cpu', torch.bfloat16),
                             x.to(torch.bfloat16), net.cfg)
        got32 = wnet_apply(net.prepared('cuda', torch.float32), x.cuda(),
                           net.cfg).cpu()
        got16 = wnet_apply(net.prepared('cuda', torch.bfloat16),
                           x.cuda().to(torch.bfloat16), net.cfg).cpu()
    err32, scale = rel_err(got32, ref)
    # random weights make bf16 drift far from fp32 over 32 convs; the bf16
    # kernel path must drift no more than the plain bf16 path (1 dB)
    psnr16, plain_psnr16 = psnr(got16, ref), psnr(plain16, ref)
    emit({'phase': 'parity_reduced', 'shape': list(x.shape),
          'fp32_kernels_vs_cpu_plain_max_abs_err': err32,
          'tol': FP32_TOL * scale,
          'bf16_kernels_vs_cpu_plain_max_abs_err': rel_err(got16, ref)[0],
          'bf16_kernels_vs_fp32_psnr_db': psnr16,
          'bf16_cpu_plain_vs_fp32_psnr_db': plain_psnr16})
    if not err32 <= FP32_TOL * scale:
        raise AssertionError(f'fp32 kernel path vs plain: {err32}')
    if not psnr16 > plain_psnr16 - 1.0:
        raise AssertionError(f'bf16 kernel path {psnr16} dB vs fp32, plain '
                             f'bf16 path {plain_psnr16} dB')

    clean, noisy = clips[0]
    out32 = denoise_seq(net, None, noisy, noise_sigma=SIGMA,
                        compute_dtype=torch.float32)
    _check_out(out32, clean)
    out16 = outs['TSM'][0]
    emit({'phase': 'parity_540p', 'bf16_vs_fp32_max_abs_err':
          float(np.abs(out16 - out32).max()),
          'bf16_vs_fp32_psnr_db': psnr(torch.from_numpy(out16),
                                       torch.from_numpy(out32))})


def main():
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: no CUDA device (torch.cuda.is_available()'
                         ' is False); this script runs only on a GPU')
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader', '-i', '0'],
                         capture_output=True, text=True, check=True).stdout
    emit({'phase': 'device', 'name': name, 'count': torch.cuda.device_count(),
          'torch': torch.__version__, 'cuda': torch.version.cuda})
    print(smi.strip(), flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.lib()
    emit({'phase': 'build', 'seconds': time.perf_counter() - t0,
          'library': os.path.relpath(lib_path, ROOT)})

    summary = phase_kernels()
    clips = _clips(np.random.default_rng(SEED), 3)
    nets, outs, launches = phase_main(clips)
    phase_parity(nets, clips, outs)

    emit({'kernels': [
        {'name': k, 'route': 'cuda', 'source': src, 'replaces': rep,
         'launches': launches[k], 'max_abs_err': summary[k]['max_abs_err'],
         'ms': summary[k]['ms'], 'plain_ms': summary[k]['plain_ms']}
        for k, (_, src, rep) in KERNELS.items()]})
    emit({'ok': True, 'device': {'platform': 'gpu', 'kind': name,
                                 'count': torch.cuda.device_count()}})


if __name__ == '__main__':
    main()
