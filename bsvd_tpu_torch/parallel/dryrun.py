"""Sharded dry runs on torch.distributed (counterpart of
bsvd_tpu/parallel/dryrun.py): the train step, the streaming client and the
whole-clip eval of the flagship BSVD-c64 config on a ('data', 'spatial')
mesh, each held against the same call unsharded on the same device.

    python -m bsvd_tpu_torch.parallel.dryrun --nproc 2 --data 1 --spatial 2 \\
        --backend gloo --device cuda [--size small|full] \\
        [--checks eval,stream,train,zoo] \\
        [--train_layouts 2x1,1x2,bn:2x1,bn:1x2,in:1x2]

spawns ``--nproc`` ranks (this module again, with ``--rank``), which join a
process group on localhost, build the mesh, run the checks and write their
results; the parent prints one JSON line (the checks' deviations, each
rank's kernel launches, gathered bytes and times) and exits non-zero if a
rank failed. Two ranks on one card need ``--backend gloo`` (NCCL refuses
them); the times of ranks that share a card say nothing about scaling.
``--target FILE.py:FUNCTION --workdir DIR`` also calls FUNCTION(mesh,
device, workdir) on every rank (the CPU tests drive their cases so).

A train layout may name a norm (``bn:2x1``): the c64 net with norm 'bn'
or 'in', its statistics taken over the global batch (NORM_STEPS steps;
the running statistics are held too). ``zoo`` runs
StyleGAN2Model and SRModel with a perceptual 'fro' on a data mesh of every
rank; the parent then runs each serially on the same device and holds the
ranks' logs and states to it (``check_zoo``).

Sizes: ``small`` are the JAX package's shapes (a few rows per rank; a
normed layout runs in float64 on the CPU, where fp32 rounding at its
sites is as large as the tolerance); ``full`` is the eval protocol's
padded 540p, (10, 3, 544, 960) in fp32 and bf16, a 544x960 stream of 24
pushes, a push_block of 8 and a flush, in fp32 and bf16, three fp32 train
steps at the train yml's batch of 8 clips of 11 x 96 x 96 per rank, and
``zoo_opts``' full widths.
"""

import argparse
import importlib.util
import json
import math
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from bsvd_tpu_torch.parallel import mesh as mesh_mod

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# the sharded fp32 output against the unsharded one: summation order only
FP32_TOL = 1e-4
# JAX's bound on the parameters after 3 Adam steps (tests/test_spatial.py)
PARAM_RTOL, PARAM_ATOL = 2e-4, 2e-5
# every step's loss against the unsharded step's, relative: the two runs
# part by Adam's amplified summation-order noise only (~3e-6 at c64 after
# 3 steps on the card)
LOSS_RTOL = 1e-4
# the train steps' learning rate; Adam moves a parameter by at most about
# lr a step, so two runs from the same parameters part by at most
# 2 x lr a step
LR = 1e-3
# bf16: PSNR against the fp32 unsharded output no more than 1 dB below the
# unsharded bf16 output's
BF16_DB = 1.0
# a normed step (BN / IN backward: means of terms that nearly cancel)
# amplifies fp32 rounding past FP32_TOL / LOSS_RTOL: on the H100 the c64
# 'bn' 2 x 1 step parted from the unsharded one by 2.0e-4 in a gradient and
# 1.5e-4 in step 2's loss, 'in' 1 x 2 by 3.2e-4 and 3.6e-4 (the CPU holds
# the same steps in float64 to 1e-5). Its layouts are held within NOISE_X
# times fp32's own gap there, where that is larger: the gap of a second
# unsharded run on the op wrappers' plain versions (cuDNN's rounding in
# every conv) from the unsharded step. The zoo check takes the gap of a
# serial run with its samples reversed (the same function)
NOISE_X = 3.0
# train steps of a layout with norm 'bn' or 'in' (the running statistics
# fold one step's batch statistics into another's)
NORM_STEPS = 2


def flagship_cfg(norm='none'):
    """BSVD-c64 (options/test/bsvd_c64.yml, the train yml's net), with
    ``norm``."""
    from bsvd_tpu_torch.archs.wnet_arch import WNetConfig
    return WNetConfig(chns=(64, 128, 256), mid_ch=64, interm_ch=64,
                      norm=norm, act='relu6', shift_mode='TSM')


def _launches():
    from bsvd_tpu_torch.ops import (bibuffer_conv, conv3x3, conv_chain,
                                    conv_s2, shift_conv)
    fns = {'conv3x3': conv3x3.conv3x3, 'conv_chain': conv_chain.conv_chain,
           'conv_s2': conv_s2.conv_s2, 'conv_ps': conv3x3.conv_ps,
           'bibuffer_conv': bibuffer_conv.bibuffer_conv,
           'bibuffer_multi': bibuffer_conv.bibuffer_multi,
           'bibuffer_chain': bibuffer_conv.bibuffer_chain,
           'conv3x3_dw': conv3x3.conv3x3_dw,
           'shift_conv_fused_v1': shift_conv.shift_conv_fused_v1}
    return {k: getattr(f, 'launches', 0) for k, f in fns.items()}


class _Counted:
    """Kernel launches, gathered bytes and wall ms of a block (the device
    synchronised at both ends)."""

    def __init__(self, device):
        self.device = torch.device(device)

    def _sync(self):
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        self._sync()
        self.l0, self.b0 = _launches(), mesh_mod.all_gather.bytes
        self.r0 = (mesh_mod.all_reduce_sum.calls,
                   mesh_mod.all_reduce_sum.bytes)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.ms = (time.perf_counter() - self.t0) * 1e3
        self.launches = {k: v - self.l0[k] for k, v in _launches().items()}
        self.bytes = mesh_mod.all_gather.bytes - self.b0
        # the norms' statistics (mesh.all_reduce_sum), forward and backward
        self.all_reduces = mesh_mod.all_reduce_sum.calls - self.r0[0]
        self.all_reduce_bytes = mesh_mod.all_reduce_sum.bytes - self.r0[1]


def _psnr(got, ref):
    mse = float(((got.float().clamp(0, 1) - ref.float().clamp(0, 1))
                 ** 2).mean())
    return 10 * math.log10(1 / mse) if mse > 0 else float('inf')


def _init_params(cfg, seed, device):
    from bsvd_tpu_torch.archs.wnet_arch import _map_tree, wnet_init
    return _map_tree(wnet_init(cfg, seed), lambda t: t.to(device))


def _device(mesh, device):
    return torch.device(device) if device is not None else mesh.device


def run_sharded_eval(mesh, seed=0, cfg=None, device=None, size='small'):
    """The whole-clip ``denoise_seq`` on ``mesh`` (the halo-exchange
    forward, parallel/spatial.py) against the unsharded call on the same
    device. Returns a dict: for each dtype run, the max abs deviation
    (fp32: asserted within 1e-4 x max|ref|; bf16: the PSNR rule), the
    sharded run's launches, gathered bytes and ms. The JAX function returns
    the fp32 deviation alone."""
    from bsvd_tpu_torch.models.seq_inference import denoise_seq
    from bsvd_tpu_torch.parallel.spatial import spatial_ok
    cfg = cfg or flagship_cfg()
    device = _device(mesh, device)
    params = _init_params(cfg, seed, device)
    n_sp = mesh.shape['spatial']
    if size == 'full':
        t, h, w, dtypes = 10, 544, 960, (torch.float32, torch.bfloat16)
    else:
        t, h, w, dtypes = 3, (4 * n_sp if (4 * n_sp) % 16 == 0
                              else 16 * n_sp), 8, (torch.float32,)
    if not spatial_ok(cfg, h, mesh):
        raise AssertionError(f'the spatial gate refused H {h} on {mesh}')
    rng = np.random.default_rng(seed)
    seq = torch.from_numpy(rng.uniform(0, 1, (t, 3, h, w)).astype(
        np.float32))
    out = {'shape': [t, 3, h, w]}
    ref32 = None
    for dtype in dtypes:
        with _Counted(device) as c:
            got = denoise_seq(params, cfg, seq, noise_sigma=0.1,
                              compute_dtype=dtype, mesh=mesh)
        ref = denoise_seq(params, cfg, seq, noise_sigma=0.1,
                          compute_dtype=dtype)
        got, ref = torch.from_numpy(got), torch.from_numpy(ref)
        rec = {'max_abs_dev': float((got - ref).abs().max()),
               'launches': c.launches, 'gathered_bytes': c.bytes,
               'ms': c.ms}
        if dtype == torch.float32:
            ref32 = ref
            bound = FP32_TOL * max(1.0, float(ref.abs().max()))
            if not rec['max_abs_dev'] <= bound:
                raise AssertionError(f'sharded eval deviates: {rec}')
        else:
            rec['psnr_db'], rec['unsharded_psnr_db'] = (_psnr(got, ref32),
                                                       _psnr(ref, ref32))
            if not rec['psnr_db'] >= rec['unsharded_psnr_db'] - BF16_DB:
                raise AssertionError(f'sharded bf16 eval: {rec}')
        out[str(dtype).split('.')[-1]] = rec
    return out


def _stream(sd, frames, n_push):
    """Push frames[:n_push], push_block the rest, flush; the outputs."""
    outs = [sd.push(f) for f in frames[:n_push]]
    outs += sd.push_block(frames[n_push:])
    outs += sd.flush()
    return torch.stack([o for o in outs if o is not None])


def run_sharded_stream_step(mesh, seed=0, cfg=None, device=None,
                            size='small'):
    """``StreamDenoiser`` on ``mesh`` (rows over 'spatial', streams over
    'data') through fill, steady pushes, a steady push_block and the drain,
    against the unsharded client on the same device. Returns a dict per
    dtype as ``run_sharded_eval`` (the JAX function returns the fp32
    deviation alone)."""
    from bsvd_tpu_torch.archs.streaming import StreamDenoiser
    cfg = cfg or flagship_cfg()
    device = _device(mesh, device)
    params = _init_params(cfg, seed, device)
    n_sp = mesh.shape['spatial']
    n = mesh.shape['data']
    if size == 'full':
        h, w, n_push, block = 544, 960, 24, 8
        dtypes = (torch.float32, torch.bfloat16)
    else:
        h, w = max(16, 4 * n_sp), 16
        n_push, block, dtypes = 16 + 2, 2, (torch.float32,)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.uniform(0, 1, (n_push + block, n, h, w,
                                            cfg.effective_in_ch)).astype(
        np.float32)).to(device)
    out = {'frames': n_push + block, 'batch': n, 'hw': [h, w]}
    ref32 = None
    for dtype in dtypes:
        sd = StreamDenoiser(params, cfg, batch=n, height=h, width=w,
                            dtype=dtype, mesh=mesh)
        if sd.mesh is None:
            raise AssertionError(f'the streaming gate refused {mesh}')
        with _Counted(device) as c:
            got = _stream(sd, x, n_push)
        ref = _stream(StreamDenoiser(params, cfg, batch=n, height=h,
                                     width=w, dtype=dtype), x, n_push)
        if got.shape != ref.shape:
            raise AssertionError(f'{tuple(got.shape)} vs {tuple(ref.shape)}')
        rec = {'max_abs_dev': float((got.float() - ref.float()).abs().max()),
               'launches': c.launches, 'gathered_bytes': c.bytes,
               'gathered_bytes_per_frame': c.bytes / len(x), 'ms': c.ms}
        if dtype == torch.float32:
            ref32 = ref
            bound = FP32_TOL * max(1.0, float(ref.abs().max()))
            if not rec['max_abs_dev'] <= bound:
                raise AssertionError(f'sharded stream deviates: {rec}')
        else:
            rec['psnr_db'], rec['unsharded_psnr_db'] = (_psnr(got, ref32),
                                                       _psnr(ref, ref32))
            if not rec['psnr_db'] >= rec['unsharded_psnr_db'] - BF16_DB:
                raise AssertionError(f'sharded bf16 stream: {rec}')
        out[str(dtype).split('.')[-1]] = rec
    return out


def _trainer(cfg, params, device, mesh=None):
    from bsvd_tpu_torch.archs.wnet_arch import _WNetBase
    from bsvd_tpu_torch.losses import build_loss
    from bsvd_tpu_torch.models.denoising_model import make_train_step
    from bsvd_tpu_torch.models.optim import Adam
    net = _WNetBase(cfg, params=params).to(device)
    opt = Adam(net.named_parameters(), lambda count: LR, betas=(0.9, 0.99))
    step = make_train_step(net, opt, build_loss(
        {'type': 'MSELoss', 'loss_weight': 1.0}), mesh=mesh)
    return net, step


def _grad_dev(net, ref_net):
    """(the largest gradient deviation over the tensors, each relative to
    max(1, its tensor's max |ref|) as chip_smoke's phase 7 holds gradients;
    the largest relative to the tensor's max |ref| alone)."""
    worst, rel = 0.0, 0.0
    for a, b in zip(net.parameters(), ref_net.parameters()):
        err, scale = float((a.grad - b.grad).abs().max()), float(
            b.grad.abs().max())
        worst = max(worst, err / max(1.0, scale))
        rel = max(rel, err / scale if scale > 0 else 0.0)
    return worst, rel


def run_sharded_train_step(mesh, seed=0, cfg=None, device=None,
                           size='small', steps=None):
    """Train steps (forward, MSE, backward, one all_reduce, Adam) on
    ``mesh``, each rank fed its shard of the global batch, against the
    unsharded step fed the whole batch on the same device, from the same
    parameters. Returns a dict: every step's loss beside the unsharded
    one (asserted within LOSS_RTOL, relative); the first step's gradients
    against the unsharded ones (asserted within 1e-4 x max(1, max|ref|)
    per tensor: the same parameters, the same batch, the summation order
    apart; also reported relative to max|ref| alone); whether every rank
    holds the same bits after the last step (asserted; the comparisons with
    the unsharded runs, which rank 0 alone makes, then hold for every
    rank, and only rank 0's dict carries them); after the last
    step the parameters' max abs deviation from the unsharded run
    (asserted at most 2 x lr a step) and how many lie outside JAX's rtol
    2e-4 / atol 2e-5 (reported, not asserted: Adam's g / (|g| + 1e-8)
    turns a summation-order difference of ~1e-7 in a gradient near zero
    into a step of up to lr, PERF.md); with norm 'bn' the running
    statistics' max abs deviation from the unsharded run's relative to
    max(1, max|ref|) (asserted at most 2 x lr a step: they fold batch
    statistics of parameters that far apart). A normed layout also runs
    the unsharded steps on the plain route (``tools._common.plain_route``):
    its gradient and loss gaps from the unsharded run
    (``grad_noise_step1``, ``loss_noise``; its losses ``loss_plain``) are
    fp32's noise there, and the
    sharded step is held within NOISE_X times them where that exceeds the
    tolerances above (``grad_tol``, ``loss_tol``).
    The sharded steps' launches,
    gathered bytes, the norms' all-reduces and bytes, and ms. The JAX
    function runs one step and returns its loss."""
    from bsvd_tpu_torch.archs.wnet_arch import _map_tree
    from bsvd_tpu_torch.parallel.mesh import all_gather, shard_batch
    cfg = cfg or flagship_cfg()
    device = _device(mesh, device)
    d, s = mesh.shape['data'], mesh.shape['spatial']
    if size == 'full':
        n, t, h, w, steps = 8 * d, 11, 96, 96, steps or 3
    else:
        n, t, h, w, steps = d, 3, 16 * s, 16, steps or 1
    # a normed site at the small sizes amplifies fp32 rounding: a serial
    # fp32 step's gradients lie ~1e-3 from float64, as far as a sharded
    # one's, so the CPU compares them in float64 there
    dtype = torch.float64 if (size != 'full' and cfg.norm != 'none'
                              and device.type == 'cpu') else torch.float32
    params = _map_tree(_init_params(cfg, seed, 'cpu'),
                       lambda v: v.to(dtype))
    net, step = _trainer(cfg, params, device, mesh)
    normed = cfg.norm != 'none'
    # the unsharded runs on rank 0 alone (the ranks hold the same bits,
    # asserted): two ranks' batch-16 BN steps at once would not fit one
    # card beside their sharded runs
    lead = mesh.rank == 0
    if lead:
        refs = {'unsharded': _trainer(cfg, _map_tree(params, torch.clone),
                                      device)}
        if normed:
            from bsvd_tpu_torch.tools._common import plain_route
            refs['plain'] = _trainer(cfg, _map_tree(params, torch.clone),
                                     device)
    rng = np.random.default_rng(seed + 1)
    out = {'norm': cfg.norm, 'dtype': str(dtype).split('.')[-1],
           'batch': [n, t, h, w], 'mesh': mesh.shape,
           'steps': steps, 'loss': []}
    if lead:
        out.update({f'loss_{k}': [] for k in refs})
    ms, launches, gathered, reduces, reduced = [], None, 0, [], 0
    for i in range(steps):
        batch = {'lq': rng.uniform(0, 1, (n, t, h, w, cfg.in_ch)),
                 'gt': rng.uniform(0, 1, (n, t, h, w, cfg.out_ch))}
        batch = {k: torch.from_numpy(v.astype(np.float32)).to(device,
                                                              dtype)
                 for k, v in batch.items()}
        local = shard_batch(mesh, batch, 0, 2)
        local = {k: v.contiguous() for k, v in local.items()}
        with _Counted(device) as c:
            loss = step(local)['l_pix']
        ms.append(c.ms)
        gathered += c.bytes
        reduces.append(c.all_reduces)
        reduced += c.all_reduce_bytes
        launches = c.launches if launches is None else {
            k: v + c.launches[k] for k, v in launches.items()}
        out['loss'].append(float(loss))
        if lead:
            out['loss_unsharded'].append(float(
                refs['unsharded'][1](batch)['l_pix']))
            if normed:
                with plain_route():
                    out['loss_plain'].append(float(
                        refs['plain'][1](batch)['l_pix']))
            if i == 0:
                ref_net = refs['unsharded'][0]
                out['grad_dev_step1'], out['grad_rel_dev_step1'] = \
                    _grad_dev(net, ref_net)
                if normed:
                    out['grad_noise_step1'] = _grad_dev(refs['plain'][0],
                                                        ref_net)[0]
        mesh_mod.barrier()
    flat = [a.detach().reshape(-1) for a in net.parameters()] + [
        a.reshape(-1) for a in net.buffers()]            # BN running stats
    flat = torch.cat(flat)
    whole = mesh_mod.Axis('world', None, mesh.rank, mesh.size)
    ranks = all_gather(flat[None], whole, 0)
    out.update(ranks_identical=bool((ranks == flat).all()),
               launches=launches, gathered_bytes=gathered,
               all_reduces_per_step=reduces, all_reduce_bytes=reduced,
               ms=ms)
    if not out['ranks_identical']:
        raise AssertionError(f'sharded train step: {out}')
    if lead:
        _held_to_unsharded(out, net, refs, steps)
    return out


def _held_to_unsharded(out, net, refs, steps):
    """The sharded run in ``out`` / ``net`` against the unsharded runs of
    ``refs`` (run_sharded_train_step's asserts), in place."""
    ref_net = refs['unsharded'][0]
    dev, outside, count = 0.0, 0, 0
    for a, b in zip(net.parameters(), ref_net.parameters()):
        diff = (a.detach() - b.detach()).abs()
        dev = max(dev, float(diff.max()))
        outside += int((diff > PARAM_ATOL + PARAM_RTOL * b.detach().abs())
                       .sum())
        count += diff.numel()
    stat_dev = 0.0
    for a, b in zip(net.buffers(), ref_net.buffers()):   # BN running stats
        stat_dev = max(stat_dev, float((a - b).abs().max()) / max(
            1.0, float(b.abs().max())))
    out.update(param_max_abs_dev=dev, params_outside_jax_bound=outside,
               params=count)
    if out['norm'] == 'bn':
        out['running_stats_dev'] = stat_dev

    def rel(key):
        return max(abs(a - b) / abs(b) for a, b in zip(
            out[key], out['loss_unsharded']))
    out['loss_rel_dev'] = rel('loss')
    grad_tol, loss_tol = FP32_TOL, LOSS_RTOL
    if 'plain' in refs:
        out['loss_noise'] = rel('loss_plain')
        grad_tol = max(grad_tol, NOISE_X * out['grad_noise_step1'])
        loss_tol = max(loss_tol, NOISE_X * out['loss_noise'])
        out.update(grad_tol=grad_tol, loss_tol=loss_tol)
    if not out['grad_dev_step1'] <= grad_tol or \
            not out['loss_rel_dev'] <= loss_tol or \
            not dev <= 2 * LR * steps or \
            not stat_dev <= 2 * LR * steps:
        raise AssertionError(f'sharded train step: {out}')


def zoo_opts(size):
    """The engines of the 'zoo' check, each with its two global batches
    of 4 (numpy, seeded): StyleGAN2Model (the train yml's generator and
    discriminator at out_size 64, narrow 0.25, R1 and the path penalty at
    iteration 2; 'small': out_size 16, narrow 0.125) and SRModel at
    msrresnet_x4.yml's widths with an L1 pixel loss and a VGG19 perceptual
    and style loss of criterion 'fro' on conv5_4 at gt 128 ('small': 8
    features, one block, conv1_1, gt 32). Both packages' options files
    name neither pairing; the widths are the shipped ones."""
    full = size == 'full'
    out_size, narrow = (64, 0.25) if full else (16, 0.125)
    sg_g = {'type': 'StyleGAN2Generator', 'out_size': out_size,
            'num_style_feat': 512 if full else 16, 'num_mlp': 8 if full
            else 2, 'channel_multiplier': 2, 'narrow': narrow}
    sg_d = {'type': 'StyleGAN2Discriminator', 'out_size': out_size,
            'channel_multiplier': 2, 'narrow': narrow}
    sg = {'name': 'stylegan2', 'model_type': 'StyleGAN2Model',
          'is_train': True, 'num_gpu': 'auto', 'manual_seed': 2021,
          'network_g': sg_g, 'network_d': sg_d, 'path': {}, 'logger': {},
          'train': {'optim_g': {'type': 'Adam', 'lr': 2e-3},
                    'optim_d': {'type': 'Adam', 'lr': 2e-3},
                    'total_iter': 2,
                    'gan_opt': {'type': 'GANLoss',
                                'gan_type': 'wgan_softplus',
                                'loss_weight': 1.0},
                    'r1_reg_weight': 10, 'path_reg_weight': 2,
                    'net_g_reg_every': 2, 'net_d_reg_every': 2,
                    'mixing_prob': 0.9}}
    gt = 128 if full else 32
    sr = {'name': 'msrresnet_x4_fro', 'model_type': 'SRModel',
          'is_train': True, 'num_gpu': 'auto', 'manual_seed': 0, 'scale': 4,
          'network_g': {'type': 'MSRResNet', 'num_in_ch': 3,
                        'num_out_ch': 3, 'num_feat': 64 if full else 8,
                        'num_block': 16 if full else 1, 'upscale': 4},
          'path': {}, 'logger': {},
          'train': {'optim_g': {'type': 'Adam', 'lr': 2e-4,
                                'betas': [0.9, 0.99]},
                    'total_iter': 2,
                    'pixel_opt': {'type': 'L1Loss', 'loss_weight': 1.0},
                    'perceptual_opt': {
                        'type': 'PerceptualLoss', 'criterion': 'fro',
                        'layer_weights': {'conv5_4' if full else 'conv1_1':
                                          1.0},
                        'perceptual_weight': 1.0, 'style_weight': 0.1}}}
    rng = np.random.default_rng(3)
    return {
        'stylegan2': (sg, [{'gt': rng.uniform(-1, 1, (4, 3, out_size,
                                                      out_size)).astype(
            np.float32)} for _ in range(2)]),
        'sr_fro': (sr, [{'lq': rng.uniform(0, 1, (4, 3, gt // 4, gt // 4))
                         .astype(np.float32),
                         'gt': rng.uniform(0, 1, (4, 3, gt, gt)).astype(
                             np.float32)} for _ in range(2)])}


def _flip(v):
    """``v`` (a tensor, or a list or dict of them) with dim 0 reversed."""
    if isinstance(v, dict):
        return {k: _flip(t) for k, t in v.items()}
    if isinstance(v, list):
        return [_flip(t) for t in v]
    return v.flip(0)


def _zoo_run(opt, batches, device, rows=None, reverse=False):
    """The engine of ``opt`` stepped on ``batches`` (``rows``: this rank's
    (index, ranks) share of each; ``reverse``: every batch and every draw
    with its samples in reverse order, the same function for these
    engines: means over the batch, StyleGAN2's minibatch stddev over one
    group of 4): logs, states, ms an iteration."""
    from bsvd_tpu_torch.models.base_model import build_model
    model = build_model(dict(opt), device=device)
    if reverse:
        for name in ('draws_d', 'draws_g'):
            draw = getattr(model, name, None)
            if draw is not None:
                setattr(model, name, lambda *a, f=draw: _flip(f(*a)))
        batches = [{k: v[::-1].copy() for k, v in b.items()}
                   for b in batches]
    logs, ms = [], []
    # cuDNN's deterministic algorithms: the runs compared here part by
    # summation order alone, the same on every call (nondeterministic
    # backward convolutions of StyleGAN2's path penalty moved one run's
    # path length by 1e-4 relative, run to run)
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        for it, batch in enumerate(batches, 1):
            if rows is not None:
                n = len(batch['gt']) // rows[1]
                batch = {k: v[rows[0] * n:(rows[0] + 1) * n]
                         for k, v in batch.items()}
            with _Counted(device) as c:
                model.feed_data(batch)
                model.optimize_parameters(it)
            ms.append(c.ms)
            logs.append(model.get_current_log())
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            flags
    nets = [a for a in ('net', 'net_g_ema', 'net_d') if
            getattr(model, a, None) is not None]
    states = {a: {k: v.detach().float().cpu() for k, v in
                  getattr(model, a).state_dict().items()} for a in nets}
    if hasattr(model, 'mean_path_length'):
        states['mean_path_length'] = {'value': model.mean_path_length
                                      .detach().float().cpu().reshape(1)}
    return logs, states, ms


def run_sharded_zoo(mesh, device, size, out_dir):
    """The 'zoo' check's rank side: each engine of ``zoo_opts`` on a data
    mesh of every rank, fed its rows of the global batches. Rank 0 saves
    the logs and states to ``out_dir`` for the parent's serial run
    (``check_zoo``). Returns, per engine, whether every rank holds the same
    bits and the ms of each iteration."""
    out, saved = {}, {}
    whole = mesh_mod.Axis('world', None, mesh.rank, mesh.size)
    for name, (opt, batches) in zoo_opts(size).items():
        logs, states, ms = _zoo_run(opt, batches, device,
                                    (mesh.rank, mesh.size))
        flat = torch.cat([v.reshape(-1) for st in states.values()
                          for v in st.values()])
        ranks = mesh_mod.all_gather(flat[None], whole, 0)
        out[name] = {'ranks_identical': bool((ranks == flat).all()),
                     'ms': ms}
        saved[name] = {'logs': logs, 'states': states}
    if mesh.rank == 0:
        torch.save(saved, os.path.join(out_dir, 'zoo.pt'))
    return out


def _log_dev(got, ref):
    return max(abs(a[k] - b[k]) / max(1.0, abs(b[k]))
               for a, b in zip(got, ref) for k in b)


def check_zoo(size, device, out_dir):
    """The 'zoo' check's parent side: each engine serial on the same
    device, fed the global batches, against the ranks' run: every state
    within 2 x lr an iteration (Adam's step of a gradient near 0;
    StyleGAN2's b1 is 0, so its first step moves every element by about
    lr and flips those whose gradient is rounding), every logged value
    within LOSS_RTOL x max(1, |ref|), or within NOISE_X times fp32's own
    gap where that is larger: the gap of a second serial run with every
    sample in reverse order (``_zoo_run``). All asserted. Returns the
    deviations and the serial ms."""
    got = torch.load(os.path.join(out_dir, 'zoo.pt'), weights_only=False)
    res = {}
    for name, (opt, batches) in zoo_opts(size).items():
        serial = dict(opt, num_gpu=1)
        logs, states, ms = _zoo_run(serial, batches, device)
        noise = _log_dev(_zoo_run(serial, batches, device, reverse=True)[0],
                         logs)
        mine = got[name]
        log_dev = _log_dev(mine['logs'], logs)
        lr = float(opt['train']['optim_g']['lr'])
        state_dev = max(float((mine['states'][a][k] - v).abs().max())
                        for a, st in states.items() for k, v in st.items())
        log_tol = max(LOSS_RTOL, NOISE_X * noise)
        rec = {'logs': mine['logs'], 'serial_logs': logs,
               'log_dev': log_dev, 'log_noise': noise, 'log_tol': log_tol,
               'state_max_abs_dev': state_dev, 'serial_ms': ms}
        if not (log_dev <= log_tol and state_dev <= 2 * lr * len(batches)
                and [list(a) for a in mine['logs']] ==
                [list(b) for b in logs]):
            raise AssertionError(f'zoo {name} on ranks vs serial: {rec}')
        res[name] = rec
    return res


def _layout(text):
    """'DxS' or 'NORM:DxS' -> (norm, data, spatial)."""
    norm, _, grid = text.rpartition(':')
    d, s = (int(v) for v in grid.split('x'))
    return norm or 'none', d, s


def _free_port():
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        return sock.getsockname()[1]


def _rank_main(args):
    from bsvd_tpu_torch.parallel.mesh import init_distributed, make_mesh
    if args.device == 'cpu':
        torch.set_num_threads(max(1, (os.cpu_count() or 2) // args.nproc))
    init_distributed(f'127.0.0.1:{args.port}', args.nproc, args.rank,
                     local_device_ids=[args.rank], backend=args.backend)
    device = torch.device('cuda', torch.cuda.current_device()) \
        if args.device == 'cuda' else torch.device('cpu')
    # fp32 means fp32 in the comparisons: cuDNN's TF32 (on by default for
    # its convs, the input gradients here) rounds the sharded and the
    # unsharded shapes' algorithms apart by ~1e-3 (chip_smoke.py sets the
    # same)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    devices = [device] * args.nproc
    mesh = make_mesh(args.nproc, spatial=args.spatial, devices=devices)
    if mesh.shape['data'] != args.data:
        raise ValueError(f'--data {args.data} with {args.nproc} ranks and '
                         f'--spatial {args.spatial}')
    res = {'rank': args.rank, 'mesh': mesh.shape, 'device': str(device)}
    checks = [c for c in args.checks.split(',') if c and c != 'none']
    for check in checks:
        if check == 'eval':
            res['eval'] = run_sharded_eval(mesh, device=device,
                                           size=args.size)
        elif check == 'stream':
            res['stream'] = run_sharded_stream_step(mesh, device=device,
                                                    size=args.size)
        elif check == 'zoo':
            res['zoo'] = run_sharded_zoo(mesh, device, args.size, args.out)
        elif check == 'train':
            res['train'] = []
            for lay in (args.train_layouts or f'{args.data}x{args.spatial}'
                        ).split(','):
                norm, d, s = _layout(lay)
                res['train'].append(run_sharded_train_step(
                    make_mesh(d * s, spatial=s, devices=devices),
                    cfg=flagship_cfg(norm), device=device, size=args.size,
                    steps=None if norm == 'none' else NORM_STEPS))
        else:
            raise ValueError(f'unknown check {check!r}')
    if args.target:
        path, fn = args.target.rsplit(':', 1)
        spec = importlib.util.spec_from_file_location('dryrun_target', path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        res['target'] = getattr(module, fn)(mesh, device, args.workdir)
    with open(os.path.join(args.out, f'rank{args.rank}.json'), 'w') as f:
        json.dump(res, f)
    torch.distributed.destroy_process_group()


def _parent_device(args):
    """The parent's device for the serial runs, TF32 off as in the
    ranks."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda' if args.device == 'cuda' else 'cpu')


def _parent_main(args, argv):
    out = tempfile.mkdtemp(prefix='dryrun_')
    port = _free_port()
    env = dict(os.environ)
    env['PYTHONPATH'] = os.pathsep.join(
        [ROOT] + [p for p in env.get('PYTHONPATH', '').split(os.pathsep)
                  if p])
    procs = [subprocess.Popen(
        [sys.executable, '-m', 'bsvd_tpu_torch.parallel.dryrun', *argv,
         '--rank', str(r), '--port', str(port), '--out', out], cwd=ROOT,
        env=env) for r in range(args.nproc)]
    t0 = time.perf_counter()
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            bad = [p.returncode for p in procs if p.returncode not in
                   (None, 0)]
            if bad or time.perf_counter() - t0 > args.timeout:
                failed = bad or 'timeout'
                break
            time.sleep(0.2)
        else:
            bad = [p.returncode for p in procs if p.returncode != 0]
            failed = bad or None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ranks = []
    for r in range(args.nproc):
        path = os.path.join(out, f'rank{r}.json')
        if os.path.isfile(path):
            with open(path) as f:
                ranks.append(json.load(f))
    zoo = None
    if failed is None and 'zoo' in args.checks.split(','):
        try:
            zoo = check_zoo(args.size, _parent_device(args), out)
        except AssertionError as err:
            failed, zoo = 'zoo', str(err)
    summary = {'dryrun': 'ok' if failed is None else 'failed',
               'nproc': args.nproc, 'mesh': {'data': args.data,
                                             'spatial': args.spatial},
               'backend': args.backend, 'device': args.device,
               'size': args.size, 'seconds': time.perf_counter() - t0,
               'ranks': ranks}
    if zoo is not None:
        summary['zoo'] = zoo
    if failed is not None:
        summary['exit_codes'] = failed
    print(json.dumps(summary), flush=True)
    return 0 if failed is None else 1


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--nproc', type=int, default=2)
    p.add_argument('--data', type=int, default=1)
    p.add_argument('--spatial', type=int, default=2)
    p.add_argument('--backend', choices=('gloo', 'nccl'), default='gloo')
    p.add_argument('--device', choices=('cpu', 'cuda'), default='cuda')
    p.add_argument('--size', choices=('small', 'full'), default='small')
    p.add_argument('--checks', default='eval,stream,train')
    p.add_argument('--train_layouts', default=None,
                   help="meshes of the train check, e.g. '2x1,1x2,bn:2x1,"
                        "in:1x2' ([norm:]data x spatial; norm 'none' "
                        'without one); default the main mesh')
    p.add_argument('--target', default=None)
    p.add_argument('--workdir', default=None)
    p.add_argument('--timeout', type=float, default=900)
    p.add_argument('--rank', type=int, default=None)
    p.add_argument('--port', type=int, default=None)
    p.add_argument('--out', default=None)
    args = p.parse_args(argv)
    if args.data * args.spatial != args.nproc:
        p.error(f'--data {args.data} x --spatial {args.spatial} != --nproc '
                f'{args.nproc}')
    if args.rank is None:
        return _parent_main(args, argv)
    _rank_main(args)
    return 0


if __name__ == '__main__':
    sys.exit(main())
