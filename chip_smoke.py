#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as one JSON object on its own line:

0. device: the card's name, and ``nvidia-smi``'s name and power limit.
1. build: nvcc compiles ``bsvd_tpu_torch/csrc/*.cu`` for sm_90a, one
   process per source, all started together.
2. kernels: each kernel in every variant the BSVD-c64 paths use, at their
   site shapes, in bf16, against its plain PyTorch version run in fp32 on
   the same bf16 values (cuDNN TF32 off); kernel and plain times are
   CUDA-event medians of 10 runs after warm-up. Whole-clip sites (10
   frames): K1 conv3x3, K2 conv_chain, K3 conv_s2, K4 conv_ps. Streaming
   sites (one frame, or 8 for push_block): K5 bibuffer_conv (F = 1) and
   bibuffer_multi (F = 8), K6 bibuffer_chain, and K1 (shift 'none', the
   drain conv), K2, K3, K4 at one frame. K5 states and K6's s1' must equal
   the plain version exactly. Train sites (8 clips x 11 frames of 96x96,
   the c64 train step's 28 weight gradients): K7 conv3x3_dw against the
   fp32 weight gradient of the same bf16 values, its plain time that of
   cuDNN's bf16 wgrad (the shift and addend materialised first). The
   generation-1 shift-conv entry (``shift_conv_fused_v1``, K1 with no
   second input) at its whole-clip sites.
3. MIMO main path: ``build_network`` BSVD-c64 (random weights from a seed),
   ``denoise_seq`` of 3 clips of (10, 3, 540, 960) at sigma 20/255 in bf16,
   for the bidirectional and the causal net; the launch counters must show
   16 / 4 / 4 / 4 launches of K1 / K2 / K3 / K4 per forward, and
   F.conv2d is made to raise while the path runs.
4. parity: the same weights on a reduced clip, fp32 kernels on the card
   against the plain fp32 path on the CPU, and the bf16 kernel path's PSNR
   against that fp32 output beside the plain bf16 path's (CPU); then bf16
   against fp32 kernels at 540p (max |diff| and PSNR).
5. streaming main path, both nets: ``StreamDenoiser`` push of a 24-frame
   540x960 bf16 clip, then flush (F.conv2d made to raise); the launches of
   every push must match the port's fill / steady / drain rule (steady:
   K2 4, K3 4, K4 4, K5 8, K6 4, K1 0) and a steady push_block of 8
   frames must launch K5 16 times and K2 / K3 / K4 4 times. The 24 outputs,
   and the push_block's, against fp32 MIMO by PSNR (no more than 1 dB below
   bf16 MIMO's). Then steady ms/frame of push (64 pushes, best of 3) and
   of push_block(8), state bytes, peak memory, and the device idle share
   of 16 steady pushes under ``torch.profiler``.
6. streaming parity: fp32 streaming kernels against fp32 MIMO kernels on a
   reduced clip (1e-4 x max|ref|), and ``denoise_seq(mode='streaming')``
   of a 10-frame clip against ``mode='mimo'`` by the same PSNR rule.
7. train_grad: one fp32 ``DenoisingModel`` step of the full-width c64 TSN
   on 2 clips x 5 frames of 64x64, kernels on the card against the plain
   path on the CPU (same weights and batch): the loss and every gradient
   to 1e-4 x max|ref| per tensor, the CPU backward taking the card's
   activation masks (a pre-activation within rounding of 0 or 6 may
   take the other side of the clip on the other device: the count of such
   flips is reported), and the parameters after the Adam step against the
   CPU optimizer fed the card's gradients.
8. train main path: the options of options/train/bsvd_c64_unblind.yml
   (batch 8 x 11 frames of 96x96, sigma ~ U[5, 55]/255 per clip, MSE,
   Adam 1e-3, betas (0.9, 0.99)), fp32 and bf16 AMP, on one repeated batch
   made by the ported augment and noise code from seeded synthetic uint8
   clips: 5 warm-up and 30 timed steps with F.conv2d raising; every step
   must launch K1 20, K2 4, K3 4, K4 4 and K7 28 times (the
   generation-1 entry 14), the losses must be finite and the mean of
   steps 21-30 below that of steps 1-10. Then ms/step and it/s at batch 8
   and 16, peak memory, the device idle share and device time per kernel
   group (K7 and cuDNN's wgrad / dgrad apart) of 8 steps under
   ``torch.profiler`` (the idle share also of the unprofiled step time,
   which the profiler's host cost does not stretch), and
   ``train_pipeline``'s save -> auto-resume round
   trip (EMA on) bit-equal to the uninterrupted run.

Any failed check raises (exit code != 0). The line before the last is
``{"kernels": [...]}``: per kernel, its launches in the main-path runs of
phases 3, 5 and 8 (counters set to 0 before each run, read after), the
largest max |diff| of phase 2, and ``ms`` / ``plain_ms``, the phase-2 site
medians summed at the counts of one bidirectional unit of work, named by
``per``: a 10-frame forward (K1-K4 and the generation-1 entry), a steady
push (K5 bibuffer_conv, K6), a steady push_block of 8 frames (K5
bibuffer_multi) or a c64 train step at batch 8 (K7).
The last line is ``{"ok": true, "device": {...}}``.
"""

import copy
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from bsvd_tpu_torch.archs import build_network  # noqa: E402
from bsvd_tpu_torch.archs.streaming import (CHAIN_MAX_C,  # noqa: E402
                                            StreamDenoiser, streaming_apply)
from bsvd_tpu_torch.archs.wnet_arch import wnet_apply  # noqa: E402
from bsvd_tpu_torch.data.video_train_loader import (  # noqa: E402
    noisy_batch, synthetic_clips)
from bsvd_tpu_torch.models.denoising_model import DenoisingModel  # noqa: E402
from bsvd_tpu_torch.models.optim import Adam  # noqa: E402
from bsvd_tpu_torch.models.seq_inference import denoise_seq  # noqa: E402
from bsvd_tpu_torch.nn.layers import conv2d_weight_grad  # noqa: E402
from bsvd_tpu_torch.nn.shift import temporal_shift  # noqa: E402
from bsvd_tpu_torch.ops import _build  # noqa: E402
from bsvd_tpu_torch.ops import conv3x3 as conv3x3_mod  # noqa: E402
from bsvd_tpu_torch.ops import conv_chain as conv_chain_mod  # noqa: E402
from bsvd_tpu_torch.ops import conv_s2 as conv_s2_mod  # noqa: E402
from bsvd_tpu_torch.ops._pack import ConvWeights, act_mask  # noqa: E402
from bsvd_tpu_torch.ops.bibuffer_conv import (  # noqa: E402
    bibuffer_chain, bibuffer_chain_reference, bibuffer_conv,
    bibuffer_conv_reference, bibuffer_multi, bibuffer_multi_reference)
from bsvd_tpu_torch.ops.conv3x3 import (  # noqa: E402
    conv3x3, conv3x3_dw, conv3x3_dw_reference, conv3x3_reference, conv_ps,
    conv_ps_reference)
from bsvd_tpu_torch.ops.conv_chain import (conv_chain,  # noqa: E402
                                           conv_chain_add2_res,
                                           conv_chain_reference)
from bsvd_tpu_torch.ops.conv_s2 import conv_s2, conv_s2_reference  # noqa: E402
from bsvd_tpu_torch.ops.shift_conv import shift_conv_fused_v1  # noqa: E402
from bsvd_tpu_torch.train import train_pipeline  # noqa: E402

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
                'bsvd_tpu/ops/conv3x3.py:309', 'forward'),
    'conv_chain': (conv_chain, 'bsvd_tpu_torch/csrc/conv_chain.cu',
                   'bsvd_tpu/ops/conv_chain.py:213', 'forward'),
    'conv_s2': (conv_s2, 'bsvd_tpu_torch/csrc/conv_s2.cu',
                'bsvd_tpu/ops/conv_s2.py:155', 'forward'),
    'conv_ps': (conv_ps, 'bsvd_tpu_torch/csrc/conv3x3.cu',
                'bsvd_tpu/ops/conv3x3.py:797', 'forward'),
    'bibuffer_conv': (bibuffer_conv, 'bsvd_tpu_torch/csrc/bibuffer_conv.cu',
                      'bsvd_tpu/ops/bibuffer_conv.py:99', 'push'),
    'bibuffer_multi': (bibuffer_multi,
                       'bsvd_tpu_torch/csrc/bibuffer_conv.cu',
                       'bsvd_tpu/ops/bibuffer_conv.py:539', 'push_block'),
    'bibuffer_chain': (bibuffer_chain,
                       'bsvd_tpu_torch/csrc/bibuffer_conv.cu',
                       'bsvd_tpu/ops/bibuffer_conv.py:346', 'push'),
    'conv3x3_dw': (conv3x3_dw, 'bsvd_tpu_torch/csrc/conv3x3_dw.cu',
                   'bsvd_tpu/ops/conv3x3.py:476', 'train_step'),
    'shift_conv_fused_v1': (shift_conv_fused_v1,
                            'bsvd_tpu_torch/csrc/conv3x3.cu',
                            'bsvd_tpu/ops/shift_conv.py:174', 'forward'),
}
# the generation-1 entry launches K1: its sites and launches are K1's too,
# so the per-unit sums leave it out
ALIASES = ('shift_conv_fused_v1',)
NOT_STREAMED = ('conv3x3_dw', 'shift_conv_fused_v1')
PER_FORWARD = {'conv3x3': 16, 'conv_chain': 4, 'conv_s2': 4, 'conv_ps': 4,
               'shift_conv_fused_v1': 14}
# a c64 train step: the forward, then K7 for the 16 shift sites, 8 chain
# convs and 4 up convs, and K1 for the 4 chain intermediates
PER_TRAIN_STEP = dict(PER_FORWARD, conv3x3=20, conv3x3_dw=28)
# streaming: 24 frames pushed, push_block of 8, timing over 64 frames
STREAM_T, BLOCK_F, TIMED = 24, 8, 64
PER_STEADY_PUSH = {'conv3x3': 0, 'conv_chain': 4, 'conv_s2': 4, 'conv_ps': 4,
                   'bibuffer_conv': 8, 'bibuffer_multi': 0,
                   'bibuffer_chain': 4, 'conv3x3_dw': 0,
                   'shift_conv_fused_v1': 0}
PER_BLOCK = dict(PER_STEADY_PUSH, bibuffer_conv=0, bibuffer_multi=16,
                 bibuffer_chain=0)
# the train slice: options/train/bsvd_c64_unblind.yml (batch 8 x 11 frames
# of 96 x 96); the parity step's reduced batch
TRAIN_N, TRAIN_T, TRAIN_HW = 8, 11, 96
GRAD_N, GRAD_T, GRAD_HW = 2, 5, 64
WARMUP, TIMED_STEPS = 5, 30


def emit(obj):
    print(json.dumps(obj), flush=True)


def counts():
    return {k: v[0].launches for k, v in KERNELS.items()}


def delta_since(before):
    return {k: v - before[k] for k, v in counts().items()}


def reset_counts():
    for fn, _, _, _ in KERNELS.values():
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
# phase 2: every kernel variant of both paths, at its site shapes
# ---------------------------------------------------------------------------

def _sites():
    """(kernel, variant, count, unit, make(g) -> (kernel call, plain call in
    fp32, plain call in bf16, exact)): ``count`` is the site's launches per
    ``unit`` of work of the bidirectional net ('forward': a 10-frame MIMO
    forward; 'push': a steady push; 'block': a steady push_block of 8);
    ``exact`` flags the outputs (of a tuple) that must equal the plain
    version bit for bit."""
    h2, w2, h4, w4 = H // 2, W // 2, H // 4, W // 4

    def conv(cin, cout, g):
        w = torch.randn((cout, cin, 3, 3), generator=g, device='cuda') * \
            math.sqrt(2 / (9 * cin))
        b = (torch.rand((cout,), generator=g, device='cuda') * 2 - 1) / \
            math.sqrt(9 * cin)
        return ConvWeights(w, b)

    def act_in(shape, g):
        return torch.rand(shape, generator=g, device='cuda').to(torch.bfloat16)

    def f32(*ts):
        return [None if t is None else t.float() for t in ts]

    def k1(h, w, c, shift, add2, nt=T):
        def make(g):
            x = act_in((nt, h, w, c), g)
            x2 = act_in((nt, h, w, c), g) if add2 else None
            cw = conv(c, c, g)
            kw = dict(t_len=nt, shift=shift, act='relu6')
            return (lambda: conv3x3(x, cw, x2=x2, **kw),
                    lambda: conv3x3_reference(*f32(x), cw, x2=f32(x2)[0],
                                              **kw),
                    lambda: conv3x3_reference(x, cw, x2=x2, **kw), None)
        return make

    def k2(c, cres, cout, nt=T):
        def make(g):
            x = act_in((nt, H, W, c), g)
            c1, c2 = conv(c, 64, g), conv(64, cout, g)
            if not cres:
                return (lambda: conv_chain(x, c1, None, c2, None, 'relu6',
                                           'relu6'),
                        lambda: conv_chain_reference(x.float(), c1, None, c2,
                                                     None, 'relu6', 'relu6'),
                        lambda: conv_chain_reference(x, c1, None, c2, None,
                                                     'relu6', 'relu6'), None)
            x2, xr = act_in(x.shape, g), act_in((nt, H, W, cres), g)
            return (lambda: conv_chain_add2_res(x, x2, xr, c1, None, c2, None,
                                                'relu6', 'none', 3),
                    lambda: conv_chain_reference(
                        x.float(), c1, None, c2, None, 'relu6', 'none',
                        x2=x2.float(), x_res=xr.float(), res_ch=3),
                    lambda: conv_chain_reference(
                        x, c1, None, c2, None, 'relu6', 'none', x2=x2,
                        x_res=xr, res_ch=3), None)
        return make

    def k3(h, w, c, cout, nt=T):
        def make(g):
            x = act_in((nt, h, w, c), g)
            cw = conv(c, cout, g)
            return (lambda: conv_s2(x, cw, act='relu6'),
                    lambda: conv_s2_reference(x.float(), cw, act='relu6'),
                    lambda: conv_s2_reference(x, cw, act='relu6'), None)
        return make

    def k4(h, w, c, cout, nt=T):
        def make(g):
            x = act_in((nt, h, w, c), g)
            cw = conv(c, cout, g)
            return (lambda: conv_ps(x, cw),
                    lambda: conv_ps_reference(x.float(), cw),
                    lambda: conv_ps_reference(x, cw), None)
        return make

    def k5(h, w, c, causal, nf=None):
        """bibuffer_conv on one frame (nf None) or bibuffer_multi on nf."""
        def make(g):
            x = act_in((nf or 1, h, w, c), g)
            st = act_in((1, h, w, c), g)
            cw = conv(c, c, g)
            kw = dict(act='relu6', causal=causal)
            fn, ref = ((bibuffer_conv, bibuffer_conv_reference) if nf is None
                       else (bibuffer_multi, bibuffer_multi_reference))
            return (lambda: fn(x, st, cw, **kw),
                    lambda: ref(*f32(x, st), cw, **kw),
                    lambda: ref(x, st, cw, **kw), (False, True))
        return make

    def k6(h, w, c, causal):
        def make(g):
            x, s1, s2 = (act_in((1, h, w, c), g) for _ in range(3))
            c1, c2 = conv(c, c, g), conv(c, c, g)
            kw = dict(act='relu6', act2='relu6', causal=causal)
            return (lambda: bibuffer_chain(x, s1, s2, c1, None, c2, None,
                                           **kw),
                    lambda: bibuffer_chain_reference(*f32(x, s1, s2), c1,
                                                     None, c2, None, **kw),
                    lambda: bibuffer_chain_reference(x, s1, s2, c1, None, c2,
                                                     None, **kw),
                    (False, True, False))
        return make

    def k7(hw, c, co, shift, add2):
        """K7 at a train site: NT = 8 clips x 11 frames of hw x hw."""
        def make(g):
            x = act_in((TRAIN_N * TRAIN_T, hw, hw, c), g)
            x2 = act_in(x.shape, g) if add2 else None
            # a cotangent of the MSE's scale (2^-10, exact in bf16)
            dz = (torch.randn((TRAIN_N * TRAIN_T, hw, hw, co), generator=g,
                              device='cuda') * 2 ** -10).to(torch.bfloat16)
            kw = dict(t_len=TRAIN_T, shift=shift)

            def cudnn_bf16():
                v = x if x2 is None else x + x2
                if shift != 'none':
                    v = temporal_shift(v.reshape(TRAIN_N, TRAIN_T, hw, hw, c),
                                       8, 'TSM').reshape(v.shape)
                return conv2d_weight_grad(v, dz, (co, c, 3, 3))
            return (lambda: conv3x3_dw(x, dz, x2, **kw),
                    lambda: conv3x3_dw_reference(x, dz, x2, **kw),
                    cudnn_bf16, None)
        return make

    def v1(h, w, c):
        def make(g):
            x = act_in((T, h, w, c), g)
            cw = conv(c, c, g)
            kw = dict(t_len=T, shift='tsm', act='relu6')
            return (lambda: shift_conv_fused_v1(x, cw, None, t_len=T),
                    lambda: conv3x3_reference(x.float(), cw, **kw),
                    lambda: conv3x3_reference(x, cw, **kw), None)
        return make

    fwd = [
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
        ('shift_conv_fused_v1', 'tsm_270x480_c128', 6, v1(h2, w2, 128)),
        ('shift_conv_fused_v1', 'tsm_135x240_c256', 8, v1(h4, w4, 256)),
    ]
    # the c64 train step's weight gradients (PER_TRAIN_STEP['conv3x3_dw'])
    hw2, hw4 = TRAIN_HW // 2, TRAIN_HW // 4
    train = [
        ('conv3x3_dw', 'inc1_96x96_4_64', 1, k7(TRAIN_HW, 4, 64, 'none',
                                                False)),
        ('conv3x3_dw', 'c64_96x96_64_64', 4, k7(TRAIN_HW, 64, 64, 'none',
                                                False)),
        ('conv3x3_dw', 'add2_96x96_64_64', 2, k7(TRAIN_HW, 64, 64, 'none',
                                                 True)),
        ('conv3x3_dw', 'outc2_96x96_64_3', 1, k7(TRAIN_HW, 64, 3, 'none',
                                                 False)),
        ('conv3x3_dw', 'tsm_48x48_c128', 6, k7(hw2, 128, 128, 'tsm', False)),
        ('conv3x3_dw', 'tsm_add2_48x48_c128', 2, k7(hw2, 128, 128, 'tsm',
                                                    True)),
        ('conv3x3_dw', 'ps_48x48_128_256', 2, k7(hw2, 128, 256, 'none',
                                                 False)),
        ('conv3x3_dw', 'tsm_24x24_c256', 8, k7(hw4, 256, 256, 'tsm', False)),
        ('conv3x3_dw', 'ps_24x24_256_512', 2, k7(hw4, 256, 512, 'none',
                                                 False)),
    ]
    assert sum(n for _, _, n, _ in train) == PER_TRAIN_STEP['conv3x3_dw']
    # per-frame streaming sites; the chain runs at 128 channels, two K5
    # steps at 256 (CHAIN_MAX_C); the other route at each width is timed
    # with count 0
    assert CHAIN_MAX_C == 128
    stream = [
        ('bibuffer_conv', 'bidir_135x240_c256', 8, k5(h4, w4, 256, False)),
        ('bibuffer_conv', 'causal_135x240_c256', 0, k5(h4, w4, 256, True)),
        ('bibuffer_conv', 'bidir_270x480_c128', 0, k5(h2, w2, 128, False)),
        ('bibuffer_chain', 'bidir_270x480_c128', 4, k6(h2, w2, 128, False)),
        ('bibuffer_chain', 'causal_270x480_c128', 0, k6(h2, w2, 128, True)),
        ('bibuffer_chain', 'bidir_135x240_c256', 0, k6(h4, w4, 256, False)),
        ('conv3x3', 'drain_270x480_c128', 0, k1(h2, w2, 128, 'none', False,
                                                nt=1)),
        ('conv3x3', 'drain_135x240_c256', 0, k1(h4, w4, 256, 'none', False,
                                                nt=1)),
        ('conv_chain', 'inc_540x960_4_64_64', 1, k2(4, 0, 64, nt=1)),
        ('conv_chain', 'inc_540x960_64_64_64', 1, k2(64, 0, 64, nt=1)),
        ('conv_chain', 'outc_res_540x960_64_64_64_xres3', 1,
         k2(64, 3, 64, nt=1)),
        ('conv_chain', 'outc_res_540x960_64_64_3_xres3', 1,
         k2(64, 3, 3, nt=1)),
        ('conv_s2', 's2_540x960_64_128', 2, k3(H, W, 64, 128, nt=1)),
        ('conv_s2', 's2_270x480_128_256', 2, k3(h2, w2, 128, 256, nt=1)),
        ('conv_ps', 'ps_135x240_256_512', 2, k4(h4, w4, 256, 512, nt=1)),
        ('conv_ps', 'ps_270x480_128_256', 2, k4(h2, w2, 128, 256, nt=1)),
    ]
    block = [
        ('bibuffer_multi', f'bidir_f{BLOCK_F}_270x480_c128', 8,
         k5(h2, w2, 128, False, BLOCK_F)),
        ('bibuffer_multi', f'bidir_f{BLOCK_F}_135x240_c256', 8,
         k5(h4, w4, 256, False, BLOCK_F)),
        ('bibuffer_multi', f'causal_f{BLOCK_F}_270x480_c128', 0,
         k5(h2, w2, 128, True, BLOCK_F)),
        ('bibuffer_multi', f'causal_f{BLOCK_F}_135x240_c256', 0,
         k5(h4, w4, 256, True, BLOCK_F)),
    ]
    return ([(k, v, n, 'forward', m) for k, v, n, m in fwd]
            + [(k, v, n, 'push', m) for k, v, n, m in stream]
            + [(k, v, n, 'push_block', m) for k, v, n, m in block]
            + [(k, v, n, 'train_step', m) for k, v, n, m in train])


def _check_site(name, got, ref, exact):
    """Max |diff| and tolerance of the outputs compared within tolerance;
    raises if one is outside it or an exact output differs."""
    if exact is None:
        got, ref, exact = (got,), (ref,), (False,)
    worst, tol = 0.0, 0.0
    for g, r, ex in zip(got, ref, exact):
        if g.shape != r.shape:
            raise AssertionError(f'{name}: shape {tuple(g.shape)} != '
                                 f'{tuple(r.shape)}')
        if ex:
            if not torch.equal(g.float(), r.float()):
                raise AssertionError(f'{name}: state copy differs')
            continue
        err, scale = rel_err(g, r)
        if not err <= BF16_TOL * scale:
            raise AssertionError(f'{name}: max|diff| {err} > '
                                 f'{BF16_TOL * scale}')
        if err >= worst:
            worst, tol = err, BF16_TOL * scale
    return worst, tol


def phase_kernels():
    """Per kernel: max err; ms / plain_ms at the counts of its unit (the
    KERNELS table). Also the kernel and plain ms of one steady push and of
    one push_block over all kernels."""
    g = torch.Generator(device='cuda').manual_seed(SEED)
    summary = {k: {'max_abs_err': 0.0, 'ms': 0.0, 'plain_ms': 0.0}
               for k in KERNELS}
    per_unit = {u: {'ms': 0.0, 'plain_ms': 0.0}
                for u in ('forward', 'push', 'push_block', 'train_step')}
    for kernel, variant, count, unit, make in _sites():
        run, plain32, plain_bf16, exact = make(g)
        got = run()
        torch.cuda.synchronize()
        ref = plain32()
        err, tol = _check_site(f'{kernel}/{unit}/{variant}', got, ref, exact)
        del ref
        ms = median_ms(run)
        plain_ms = median_ms(plain_bf16)
        out = got[0] if isinstance(got, tuple) else got
        emit({'phase': 'kernel', 'kernel': kernel, 'variant': variant,
              'per': unit, 'shape_out': list(out.shape), 'max_abs_err': err,
              'tol': tol, 'exact_states': bool(exact), 'ms': ms,
              'plain_ms': plain_ms, 'count': count})
        s = summary[kernel]
        s['max_abs_err'] = max(s['max_abs_err'], err)
        if unit == KERNELS[kernel][3]:
            s['ms'] += count * ms
            s['plain_ms'] += count * plain_ms
        if kernel not in ALIASES:
            per_unit[unit]['ms'] += count * ms
            per_unit[unit]['plain_ms'] += count * plain_ms
        del got, out
        torch.cuda.empty_cache()
    emit({'phase': 'kernel_sums', 'per_unit': per_unit})
    return summary


# ---------------------------------------------------------------------------
# phase 3: the MIMO main path
# ---------------------------------------------------------------------------

def _clips(rng, n, t_len=T):
    """Smooth synthetic clean clips (t_len, 3, H, W) in [0, 1] and their
    noisy versions at SIGMA."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    out = []
    for _ in range(n):
        f = rng.uniform(0.005, 0.03, size=(3, 2)).astype(np.float32)
        ph = rng.uniform(0, 6.28, size=(3, t_len)).astype(np.float32)
        clean = np.empty((t_len, 3, H, W), np.float32)
        for t in range(t_len):
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
            delta = delta_since(before)
            for k in KERNELS:
                n = PER_FORWARD.get(k, 0)
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
    return out32


# ---------------------------------------------------------------------------
# phase 5: the streaming main path
# ---------------------------------------------------------------------------

def expected_step(p, t_len, causal, wide=(False, True, True, False),
                  stage_num=2):
    """Launches of streaming step p (0-based; p >= t_len are the flush's
    drain steps) over a t_len-frame clip, by archs/streaming.py's rule,
    derived here from frame indices alone. Stage s's temporal conv k (8s ..
    8s+7: down0, down1, up2, up1, two each) reads frame p - k at step p
    and holds frame p - k - 1: it outputs iff that frame exists, through
    K5 if its input exists too (steady) and K1 if not (drain). A
    MemCvBlock no wider than CHAIN_MAX_C (``wide`` False) runs as one K6
    when both its convs are steady. The causal net has no delay: every
    site runs steady on every valid frame."""
    c = dict.fromkeys(KERNELS, 0)

    def ok(j):
        return 0 <= j < t_len

    for s in range(stage_num):
        if causal:
            if ok(p):
                for k, n in PER_STEADY_PUSH.items():
                    c[k] += n // stage_num
            continue
        base = 8 * s
        q = p - base                       # frame at the stage's input
        if ok(q):                          # inc, down0's stride-2 conv
            c['conv_chain'] += 1
            c['conv_s2'] += 1
        for j, is_wide in enumerate(wide):
            k1 = base + 2 * j
            if not is_wide and all(ok(p - k1 - d) for d in range(3)):
                c['bibuffer_chain'] += 1
                continue
            for k in (k1, k1 + 1):
                if ok(p - k - 1):
                    c['bibuffer_conv' if ok(p - k) else 'conv3x3'] += 1
        if ok(q - 2):                      # down1's stride-2 conv
            c['conv_s2'] += 1
        if ok(q - 6):                      # up2's conv + shuffle
            c['conv_ps'] += 1
        if ok(q - 8):                      # up1's conv + shuffle, outc
            c['conv_ps'] += 1
            c['conv_chain'] += 1
    return c


def _stream_input(noisy):
    """(T, 3, H, W) numpy -> (T, 1, H, W, 4) bf16 frames on the card."""
    x = torch.from_numpy(noisy).cuda().to(torch.bfloat16)
    x = torch.cat([x, torch.full_like(x[:, :1], SIGMA)], dim=1)
    return x.permute(0, 2, 3, 1)[:, None].contiguous()


def _state_bytes(state):
    total = 0
    for st in state:
        for v in st.values():
            for node in (v if isinstance(v, list) else [v]):
                t = node['packed'] if 'packed' in node else node['buf']
                total += t.numel() * t.element_size()
    return total


def _time_per_frame(sd, x, block):
    """Best of 3 host-clock ms per frame over TIMED frames resident on the
    card, ending in a synchronize (push, or push_block of BLOCK_F)."""
    best = float('inf')
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if block:
            for k in range(0, TIMED, BLOCK_F):
                i = k % STREAM_T
                sd.push_block(x[i:i + BLOCK_F])
        else:
            for k in range(TIMED):
                sd.push(x[k % STREAM_T])
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) / TIMED)
    return best * 1e3


def _device_profile(run, n, label):
    """Device busy time (union of all device activity) and idle share of
    ``run()`` (n units of work, ending in a synchronize) under
    torch.profiler; the kernels and the ``record_function`` ranges inside
    by device time, per unit."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(label):
            run()
    events = prof.events()
    win = next(e for e in events if e.name == label)
    ws, we = win.time_range.start, win.time_range.end
    # device activity: kernels, copies and sets; a record_function range
    # also shows on the device timeline (an annotation spanning its
    # kernels), which is no activity of its own
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not e.is_user_annotation]
    spans = sorted((max(e.time_range.start, ws), min(e.time_range.end, we))
                   for e in device)
    busy, cur = 0.0, None
    for a, b in spans:
        if b <= a:
            continue
        if cur is None or a > cur[1]:
            busy += 0 if cur is None else cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    busy += 0 if cur is None else cur[1] - cur[0]
    # device time by kernel name (a CPU op's row in key_averages() carries
    # its kernels' time as well), and the device span of each range
    totals, ranges = {}, {}
    for e in events:
        if e.device_type != DeviceType.CUDA:
            continue
        into = ranges if e.is_user_annotation else totals
        into[e.name] = into.get(e.name, 0) + (e.time_range.end -
                                              e.time_range.start)
    by_name = sorted(totals.items(), key=lambda kv: -kv[1])
    ranges = {k: v / 1e3 / n for k, v in ranges.items() if k != label}
    return {'units': n, 'window_ms_per_unit': (we - ws) / 1e3 / n,
            'device_busy_ms_per_unit': busy / 1e3 / n,
            'idle_share': (1 - busy / (we - ws)) if spans else None,
            'top_device_ms_per_unit': [[k, v / 1e3 / n]
                                       for k, v in by_name[:12]],
            'by_kernel': [[k, v / 1e3 / n] for k, v in by_name],
            'ranges_device_ms_per_unit': ranges}


def _profile_pushes(sd, x, n=16):
    """The device profile of n steady pushes."""
    def run():
        for k in range(n):
            sd.push(x[k % STREAM_T])
        torch.cuda.synchronize()
    prof = _device_profile(run, n, 'steady_pushes')
    return {'pushes': n,
            'window_ms_per_push': prof['window_ms_per_unit'],
            'device_busy_ms_per_push': prof['device_busy_ms_per_unit'],
            'idle_share': prof['idle_share'],
            'top_device_ms_per_push': prof['top_device_ms_per_unit'][:9]}


def phase_stream(nets, clip):
    """Returns the launches of the checked main-path runs."""
    clean, noisy = clip
    x = _stream_input(noisy)
    xm = x[:, 0][None]                           # (1, T, H, W, 4) for MIMO
    launches = dict.fromkeys(KERNELS, 0)
    for mode, net in nets.items():
        causal = 'toFutureOnly' in mode
        cfg = net.cfg
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before_gb = torch.cuda.memory_allocated() / 1e9
        sd = StreamDenoiser(net, None, batch=1, height=H, width=W,
                            dtype=torch.bfloat16)
        state_gb = _state_bytes(sd.state) / 1e9
        lat = sd.latency
        reset_counts()
        steps, outs = [], []
        with _NoConv2d():
            for i in range(STREAM_T):
                before = counts()
                out = sd.push(x[i])
                steps.append(delta_since(before))
                if out is not None:
                    outs.append(out)
            before = counts()
            outs += sd.flush()
            drain = delta_since(before)
        for k, v in counts().items():
            launches[k] += v
        torch.cuda.synchronize()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9

        for p, got in enumerate(steps):
            if got != expected_step(p, STREAM_T, causal):
                raise AssertionError(f'{mode}: push {p} launched {got}, '
                                     f'expected {expected_step(p, STREAM_T, causal)}')
            if lat <= p and got != PER_STEADY_PUSH:
                raise AssertionError(f'{mode}: steady push {p}: {got}')
        want = dict.fromkeys(KERNELS, 0)
        for p in range(STREAM_T, STREAM_T + lat):
            for k, v in expected_step(p, STREAM_T, causal).items():
                want[k] += v
        if drain != want:
            raise AssertionError(f'{mode}: flush launched {drain}, expected '
                                 f'{want}')
        if len(outs) != STREAM_T:
            raise AssertionError(f'{mode}: {len(outs)} outputs for '
                                 f'{STREAM_T} frames')
        y = torch.stack(outs, dim=1)
        if not torch.isfinite(y).all():
            raise AssertionError(f'{mode}: non-finite streaming output')

        with torch.no_grad():
            ref32 = wnet_apply(net.prepared('cuda', torch.float32),
                               xm.float(), cfg)
            mimo16 = wnet_apply(net.prepared('cuda', torch.bfloat16), xm,
                                cfg)
        psnr_stream, psnr_mimo = psnr(y, ref32), psnr(mimo16, ref32)
        if not psnr_stream > psnr_mimo - 1.0:
            raise AssertionError(f'{mode}: bf16 streaming {psnr_stream} dB vs'
                                 f' fp32 MIMO, bf16 MIMO {psnr_mimo} dB')

        # a steady push_block of BLOCK_F frames (the first lat by push)
        sd.reset()
        for i in range(lat):
            sd.push(x[i])
        reset_counts()
        with _NoConv2d():
            blk = sd.push_block(x[lat:lat + BLOCK_F])
        block = counts()
        for k, v in block.items():
            launches[k] += v
        if block != PER_BLOCK:
            raise AssertionError(f'{mode}: push_block launched {block}')
        yb = torch.stack(blk, dim=1)                 # frames 0 .. BLOCK_F-1
        psnr_block = psnr(yb, ref32[:, :BLOCK_F])
        psnr_mimo_b = psnr(mimo16[:, :BLOCK_F], ref32[:, :BLOCK_F])
        if not psnr_block > psnr_mimo_b - 1.0:
            raise AssertionError(f'{mode}: push_block {psnr_block} dB, bf16 '
                                 f'MIMO {psnr_mimo_b} dB')
        del ref32, mimo16, y, yb, outs, blk

        sd.reset()
        for i in range(lat + 4):
            sd.push(x[i % STREAM_T])
        push_ms = _time_per_frame(sd, x, block=False)
        block_ms = _time_per_frame(sd, x, block=True)
        prof = _profile_pushes(sd, x)
        emit({'phase': 'stream', 'shift_mode': mode, 'latency': lat,
              'frames': STREAM_T, 'launches_fill_steady': steps,
              'launches_flush': drain, 'launches_push_block': block,
              'psnr_db_vs_fp32_mimo': {'stream_bf16': psnr_stream,
                                       'mimo_bf16': psnr_mimo,
                                       'push_block_bf16': psnr_block,
                                       'mimo_bf16_first_block': psnr_mimo_b},
              'push_ms_per_frame': push_ms,
              f'push_block{BLOCK_F}_ms_per_frame': block_ms,
              'state_gb': state_gb, 'allocated_before_gb': before_gb,
              'peak_allocated_gb': peak_gb,
              'profile': prof})
        del sd
        torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 6: streaming parity
# ---------------------------------------------------------------------------

def phase_stream_parity(nets, clips, outs, out32):
    """fp32 streaming kernels against fp32 MIMO kernels on a reduced clip;
    denoise_seq(mode='streaming') of a 540p clip against mode='mimo'.
    Returns the launches of the denoise_seq run."""
    rng = np.random.default_rng(SEED + 2)
    x = torch.from_numpy(rng.uniform(0, 1, (1, 20, 128, 224, 4))
                         .astype(np.float32)).cuda()
    for mode, net in nets.items():
        p = net.prepared('cuda', torch.float32)
        with torch.no_grad():
            ref = wnet_apply(p, x, net.cfg)
            got = streaming_apply(p, x, net.cfg)
        err, scale = rel_err(got, ref)
        emit({'phase': 'stream_parity_fp32', 'shift_mode': mode,
              'shape': list(x.shape), 'max_abs_err': err,
              'tol': FP32_TOL * scale})
        if not err <= FP32_TOL * scale:
            raise AssertionError(f'{mode}: fp32 streaming vs MIMO: {err}')

    clean, noisy = clips[0]
    reset_counts()
    with _NoConv2d():
        s16 = denoise_seq(nets['TSM'], None, noisy, noise_sigma=SIGMA,
                          mode='streaming', compute_dtype=torch.bfloat16)
    launches = counts()
    _check_out(s16, clean)
    to_t = torch.from_numpy
    psnr_s, psnr_m = psnr(to_t(s16), to_t(out32)), psnr(to_t(outs['TSM'][0]),
                                                        to_t(out32))
    emit({'phase': 'denoise_seq_streaming', 'frames': T,
          'psnr_db_vs_fp32_mimo': {'streaming_bf16': psnr_s,
                                   'mimo_bf16': psnr_m},
          'launches': launches})
    if not psnr_s > psnr_m - 1.0:
        raise AssertionError(f"denoise_seq(mode='streaming') {psnr_s} dB, "
                             f"mode='mimo' {psnr_m} dB")
    return launches


# ---------------------------------------------------------------------------
# phases 7 and 8: the train slice
# ---------------------------------------------------------------------------

def _train_opt(t_len, amp=False, ema_decay=0):
    """options/train/bsvd_c64_unblind.yml as ``parse_options`` makes it (the
    card's machine has no PyYAML); ``num_segments`` is the clip length."""
    return {
        'name': 'bsvd_c64_unblind', 'model_type': 'DenoisingModel',
        'num_gpu': 1, 'manual_seed': 10, 'is_train': True,
        'network_g': {
            'type': 'TSN', 'num_segments': t_len,
            'base_model': 'WNet_multistage', 'shift_type': 'TSM',
            'shift_div': 8, 'inplace': False,
            'net2d_opt': {'chns': [64, 128, 256], 'mid_ch': 64,
                          'shift_input': False, 'norm': 'none',
                          'interm_ch': 64, 'act': 'relu6'}},
        'path': {'strict_load_g': True},
        'train': {
            'optim_g': {'type': 'Adam', 'lr': 1e-3, 'weight_decay': 0,
                        'betas': [0.9, 0.99]},
            'scheduler': {'type': 'MultiStepLR',
                          'milestones': [50000 * k for k in range(1, 14)],
                          'gamma': 0.7},
            'total_iter': 700000, 'warmup_iter': -1,
            'gradient_clipping': 5,
            'pixel_opt': {'type': 'MSELoss', 'loss_weight': 1.0,
                          'reduction': 'mean'},
            'fp16': amp, 'ema_decay': ema_decay},
        'logger': {'print_freq': 100, 'save_checkpoint_freq': 5000}}


def _train_batch(rng, n, t_len, hw):
    """A train batch through the ported augment and noise code (noise_ival
    [5, 55], noise_shape N) from seeded synthetic uint8 clips."""
    return noisy_batch(synthetic_clips(rng, n, t_len, hw, hw), rng, [5, 55],
                       'N')


class _SharedMasks:
    """Records the activation masks of one backward (in call order) and
    hands them to a later backward on the other device, counting where
    that device's own mask differs."""

    MODULES = (conv3x3_mod, conv_chain_mod, conv_s2_mod)

    def __init__(self):
        self.masks, self.flips, self.fn = [], 0, None

    def _record(self, g, y, act):
        m = act_mask(y, act)
        self.masks.append(m)
        return g if m is None else g * m

    def _replay(self, g, y, act):
        m = self.masks.pop(0)
        if m is None:
            return g
        m = m.to(g.device, g.dtype)
        self.flips += int((act_mask(y, act) != m).sum())
        return g * m

    def record(self):
        self.fn = self._record
        return self

    def replay(self):
        self.fn = self._replay
        return self

    def __enter__(self):
        self.saved = [mod.masked for mod in self.MODULES]
        for mod in self.MODULES:
            mod.masked = self.fn

    def __exit__(self, *exc):
        for mod, fn in zip(self.MODULES, self.saved):
            mod.masked = fn


def _max_rel(got, ref):
    ref = ref.detach().float().cpu()
    err = (got.detach().float().cpu() - ref).abs().max().item()
    return err / max(ref.abs().max().item(), 1e-30)


def phase_train_grad():
    """One fp32 step of the full-width net, card against CPU."""
    opt = _train_opt(GRAD_T)
    batch = _train_batch(np.random.default_rng(SEED + 4), GRAD_N, GRAD_T,
                         GRAD_HW)
    card = DenoisingModel(copy.deepcopy(opt), device='cuda')
    cpu = DenoisingModel(copy.deepcopy(opt), device='cpu')
    before = {n: p.detach().clone() for n, p in cpu.net.named_parameters()}
    masks = _SharedMasks()
    card.feed_data(batch)
    with _NoConv2d(), masks.record():
        card.optimize_parameters(1)
    cpu.feed_data(batch)
    with masks.replay():
        cpu.optimize_parameters(1)
    # the parameters after the step: the CPU optimizer fed the card's grads
    named = dict(card.net.named_parameters())
    ref = [(n, p.requires_grad_(True)) for n, p in before.items()]
    for n, p in ref:
        p.grad = named[n].grad.cpu()
    Adam(ref, cpu.lr_schedule, betas=opt['train']['optim_g']['betas']).step()
    loss, ref_loss = card.get_current_log()['l_pix'], \
        cpu.get_current_log()['l_pix']
    errs = {'loss': abs(loss - ref_loss) / abs(ref_loss)}
    cpu_named = dict(cpu.net.named_parameters())
    grad_errs = {n: _max_rel(p.grad, cpu_named[n].grad)
                 for n, p in named.items()}
    param_errs = {n: _max_rel(named[n], p) for n, p in ref}
    worst_g = max(grad_errs, key=grad_errs.get)
    worst_p = max(param_errs, key=param_errs.get)
    emit({'phase': 'train_grad', 'batch': [GRAD_N, GRAD_T, GRAD_HW, GRAD_HW],
          'loss': loss, 'loss_rel_err': errs['loss'],
          'grad_max_rel_err': [worst_g, grad_errs[worst_g]],
          'param_max_rel_err': [worst_p, param_errs[worst_p]],
          'tensors': len(grad_errs), 'mask_flips': masks.flips,
          'tol': FP32_TOL})
    if not math.isfinite(loss):
        raise AssertionError('non-finite loss on the card')
    for what, e in [('loss', errs['loss'])] + [
            (f'grad {n}', e) for n, e in grad_errs.items()] + [
            (f'param {n}', e) for n, e in param_errs.items()]:
        if not e <= FP32_TOL:
            raise AssertionError(f'train step on the card vs the CPU: {what} '
                                 f'max rel err {e}')


def _kernel_group(name):
    n = name.lower()
    if 'conv3x3_dw' in n:
        return 'K7 conv3x3_dw'
    if 'conv3x3_kernel' in n:       # conv3x3_kernel<T, PS>: PS true is K4
        return 'K4 conv_ps' if ', true>' in n else 'K1 conv3x3'
    for key, group in (('bibuffer', 'K5/K6'), ('conv_chain', 'K2 conv_chain'),
                       ('conv_s2', 'K3 conv_s2'), ('dgrad', 'cuDNN dgrad'),
                       ('wgrad', 'cuDNN wgrad'), ('reduce_kernel', 'sums'),
                       ('copy', 'copies'), ('elementwise', 'elementwise')):
        if key in n:
            return group
    return 'other'


def _time_steps(model, steps, first_iter):
    """Host-clock ms per step over ``steps`` steps (synchronised at both
    ends), and the steps' losses read back after the timing."""
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        model.optimize_parameters(first_iter + i)
        losses.append(model.log_dict['l_pix'])
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps * 1e3, [float(v) for v in
                                                      losses]


def _profile_steps(model, n, first_iter):
    """The device profile of n train steps, with the input and weight
    gradients that aten's convolution_backward computes (cuDNN) marked as
    ranges."""
    from torch.profiler import record_function
    mods = (conv3x3_mod, conv_chain_mod, conv_s2_mod)
    saved = [(m, getattr(m, 'conv2d_input_grad', None),
              getattr(m, 'conv2d_weight_grad', None)) for m in mods]

    def ranged(fn, label):
        def call(*a, **k):
            with record_function(label):
                return fn(*a, **k)
        return call
    for m, ig, wg in saved:
        if ig is not None:
            m.conv2d_input_grad = ranged(ig, 'range:cudnn_dgrad')
        if wg is not None:
            m.conv2d_weight_grad = ranged(wg, 'range:cudnn_wgrad')
    try:
        def run():
            for i in range(n):
                model.optimize_parameters(first_iter + i)
            torch.cuda.synchronize()
        prof = _device_profile(run, n, 'train_steps')
    finally:
        for m, ig, wg in saved:
            if ig is not None:
                m.conv2d_input_grad = ig
            if wg is not None:
                m.conv2d_weight_grad = wg
    groups = {}
    for name, ms in prof.pop('by_kernel'):
        g = _kernel_group(name)
        groups[g] = groups.get(g, 0.0) + ms
    prof['device_ms_per_step_by_group'] = groups
    return prof


def _resume_round_trip(batch, root):
    """train_pipeline for 6 steps straight, against 4 steps with a save at
    step 4 followed by an auto-resumed run to step 6 (bf16 AMP, EMA on,
    one repeated batch, deterministic cuDNN). Returns the max |diff| of
    the parameters and of the EMA (both must be 0)."""
    def opt_for(tag, total):
        opt = _train_opt(TRAIN_T, amp=True, ema_decay=0.999)
        opt['train']['total_iter'] = total
        opt['logger'] = {'print_freq': 2, 'save_checkpoint_freq': 4}
        opt['path'].update(models=os.path.join(root, tag, 'models'),
                           training_states=os.path.join(root, tag, 'states'))
        return opt
    loader = [batch] * 8
    straight = train_pipeline(opt_for('a', 6), loader, device='cuda')
    train_pipeline(opt_for('b', 4), loader, device='cuda')
    resumed_opt = opt_for('b', 6)
    resumed_opt['auto_resume'] = True
    resumed = train_pipeline(resumed_opt, loader, device='cuda')
    if resumed.optimizer.count != 6:
        raise AssertionError(f'resumed optimizer count '
                             f'{resumed.optimizer.count}')
    got = dict(resumed.net.named_parameters())
    d_params = max((got[n] - p).abs().max().item()
                   for n, p in straight.net.named_parameters())
    d_ema = max((a - b).abs().max().item() for a, b in zip(
        _leaves(resumed.ema_params), _leaves(straight.ema_params)))
    return d_params, d_ema


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def phase_train():
    """The train main path. Returns the launches of its checked steps."""
    per_step = {k: PER_TRAIN_STEP.get(k, 0) for k in KERNELS}
    rng = np.random.default_rng(SEED + 5)
    batch = _train_batch(rng, TRAIN_N, TRAIN_T, TRAIN_HW)
    launches = dict.fromkeys(KERNELS, 0)
    for amp in (False, True):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = DenoisingModel(_train_opt(TRAIN_T, amp=amp), device='cuda')
        model.feed_data(batch)
        with _NoConv2d():
            for i in range(WARMUP):
                reset_counts()
                model.optimize_parameters(i + 1)
                step = counts()
                if step != per_step:
                    raise AssertionError(f'amp={amp}: train step {i + 1} '
                                         f'launched {step}')
                for k, v in step.items():
                    launches[k] += v
            reset_counts()
            ms, losses = _time_steps(model, TIMED_STEPS, WARMUP + 1)
            for k, v in counts().items():
                if v != per_step[k] * TIMED_STEPS:
                    raise AssertionError(f'amp={amp}: {k} launched {v} times '
                                         f'in {TIMED_STEPS} steps')
                launches[k] += v
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            prof = None
            if amp:
                prof = _profile_steps(model, 8, WARMUP + TIMED_STEPS + 1)
                # the profiler slows the host, so its window is longer than
                # an unprofiled step: the device's idle share of the timed
                # steps, from the profiled busy time
                prof['idle_share_of_timed_step'] = \
                    1 - prof['device_busy_ms_per_unit'] / ms
        first, last = np.mean(losses[:10]), np.mean(losses[20:30])
        emit({'phase': 'train', 'amp': amp,
              'batch': [TRAIN_N, TRAIN_T, TRAIN_HW, TRAIN_HW],
              'launches_per_step': per_step, 'ms_per_step': ms,
              'it_per_s': 1e3 / ms, 'loss_steps_1_10_mean': first,
              'loss_steps_21_30_mean': last, 'loss_last': losses[-1],
              'peak_allocated_gb': peak_gb, 'profile': prof})
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f'amp={amp}: non-finite loss')
        if not last < first:
            raise AssertionError(f'amp={amp}: loss did not fall on the '
                                 f'repeated batch ({first} -> {last})')
        del model
    # the reference's effective batch: 16 clips (8 per GPU on two GPUs)
    batch16 = _train_batch(rng, 2 * TRAIN_N, TRAIN_T, TRAIN_HW)
    for amp in (False, True):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = DenoisingModel(_train_opt(TRAIN_T, amp=amp), device='cuda')
        model.feed_data(batch16)
        with _NoConv2d():
            _time_steps(model, 2, 1)
            ms, losses = _time_steps(model, 10, 3)
        emit({'phase': 'train_batch16', 'amp': amp,
              'batch': [2 * TRAIN_N, TRAIN_T, TRAIN_HW, TRAIN_HW],
              'ms_per_step': ms, 'it_per_s': 1e3 / ms,
              'peak_allocated_gb': torch.cuda.max_memory_allocated() / 1e9})
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f'batch 16, amp={amp}: non-finite loss')
        del model
    torch.backends.cudnn.deterministic = True
    try:
        with tempfile.TemporaryDirectory() as root, _NoConv2d():
            d_params, d_ema = _resume_round_trip(batch, root)
    finally:
        torch.backends.cudnn.deterministic = False
    emit({'phase': 'train_resume', 'steps': [4, 2],
          'max_abs_diff_params': d_params, 'max_abs_diff_ema': d_ema})
    if d_params != 0 or d_ema != 0:
        raise AssertionError(f'resume differs from the uninterrupted run: '
                             f'params {d_params}, EMA {d_ema}')
    return launches


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
    out32 = phase_parity(nets, clips, outs)
    clip24 = _clips(np.random.default_rng(SEED + 3), 1, STREAM_T)[0]
    stream_launches = phase_stream(nets, clip24)
    seq_launches = phase_stream_parity(nets, clips, outs, out32)
    for k in KERNELS:
        if k not in NOT_STREAMED and not stream_launches[k] > 0:
            raise AssertionError(f'{k} never launched on the streaming path')
        launches[k] += stream_launches[k] + seq_launches[k]
    phase_train_grad()
    train_launches = phase_train()
    for k in KERNELS:
        launches[k] += train_launches[k]
        if not launches[k] > 0:
            raise AssertionError(f'{k} never launched on a main path')

    emit({'kernels': [
        {'name': k, 'route': 'cuda', 'source': src, 'replaces': rep,
         'launches': launches[k], 'max_abs_err': summary[k]['max_abs_err'],
         'ms': summary[k]['ms'], 'plain_ms': summary[k]['plain_ms'],
         'per': per}
        for k, (_, src, rep, per) in KERNELS.items()]})
    emit({'ok': True, 'device': {'platform': 'gpu', 'kind': name,
                                 'count': torch.cuda.device_count()}})


if __name__ == '__main__':
    main()
