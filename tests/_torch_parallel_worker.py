"""Rank-side cases of tests/test_torch_spatial.py and
tests/test_torch_parallel.py, run on every gloo CPU rank by
``python -m bsvd_tpu_torch.parallel.dryrun --target
tests/_torch_parallel_worker.py:<function>``. Inputs come from
``inputs.pt`` in the work folder (written by the test from numpy seeds and
the JAX package's parameters); rank 0 writes ``outputs.pt``. Imports no
JAX."""

import os

import torch

from bsvd_tpu_torch.archs.streaming import StreamDenoiser
from bsvd_tpu_torch.archs.wnet_arch import WNetConfig, _map_tree, _WNetBase
from bsvd_tpu_torch.losses import build_loss
from bsvd_tpu_torch.models.denoising_model import make_train_step
from bsvd_tpu_torch.models.optim import Adam
from bsvd_tpu_torch.models.seq_inference import (BlockStreamDenoiser,
                                                 denoise_seq)
from bsvd_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_batch
from bsvd_tpu_torch.parallel.spatial import wnet_apply_spatial


def _stream(sd, frames, n_push):
    outs = [sd.push(f) for f in frames[:n_push]]
    outs += sd.push_block(frames[n_push:])
    outs += sd.flush()
    return torch.stack([o for o in outs if o is not None])


def _block_stream(bsd, frames):
    outs = []
    for f in frames:
        outs += bsd.push(f)
    outs += bsd.flush()
    return torch.stack(outs)


def _train(cfg, params, batches, mesh, amp=False):
    """The parameters after the steps, the losses, and the first step's
    gradients (after the all_reduce), by parameter name."""
    net = _WNetBase(cfg, params=_map_tree(params, torch.clone))
    opt = Adam(net.named_parameters(), lambda count: 1e-3)
    step = make_train_step(net, opt, build_loss(
        {'type': 'MSELoss', 'loss_weight': 1.0}), amp=amp, mesh=mesh)
    losses, grads = [], None
    for b in batches:
        local = {k: v.contiguous() for k, v in
                 shard_batch(mesh, b, 0, 2).items()}
        losses.append(float(step(local)['l_pix']))
        if grads is None:
            grads = {k: p.grad.clone() for k, p in net.named_parameters()}
    return net.param_tree(), losses, grads


def spatial_cases(mesh, device, workdir):
    """Every case of tests/test_torch_spatial.py on 4 ranks; ``mesh`` is
    data 2 x spatial 2."""
    inp = torch.load(os.path.join(workdir, 'inputs.pt'))
    cfg = WNetConfig(**inp['cfg'])
    params = inp['params']
    sp4 = make_mesh(4, spatial=4, devices=[device] * 4)
    dp4 = make_mesh(4, spatial=1, devices=[device] * 4)
    out = {}
    with torch.no_grad():
        for name, m in (('halo_wider', sp4), ('halo_narrower', mesh),
                        ('data_and_spatial', mesh)):
            out[name] = wnet_apply_spatial(params, inp[name], cfg, m)
        out['denoise_seq'] = denoise_seq(params, cfg, inp['seq'],
                                         noise_sigma=0.1, mesh=mesh)
        out['denoise_seq_chunked'] = denoise_seq(
            params, cfg, inp['seq'], noise_sigma=0.1, temp_psz=2,
            future_buffer_len=1, mesh=mesh)
    frames = inp['stream']
    for name, m in (('stream_spatial4', sp4), ('stream_2x2', mesh)):
        sd = StreamDenoiser(params, cfg, batch=frames.shape[1],
                            height=frames.shape[2], width=frames.shape[3],
                            mesh=m)
        out[name + '_sharded'] = sd.mesh is not None
        out[name] = _stream(sd, frames, inp['n_push'])
    out['stream_unsharded'] = _stream(StreamDenoiser(
        params, cfg, batch=frames.shape[1], height=frames.shape[2],
        width=frames.shape[3]), frames, inp['n_push'])
    out['block_stream'] = _block_stream(BlockStreamDenoiser(
        params, cfg, psz=3, future_buffer_len=1, mesh=mesh), frames)
    out['block_stream_unsharded'] = _block_stream(BlockStreamDenoiser(
        params, cfg, psz=3, future_buffer_len=1), frames)
    for name, m in (('train_data', dp4), ('train_data_spatial', mesh)):
        out[name] = _train(cfg, params, inp['batches'], m)
    # bf16 AMP with the rows split: the casts, and bf16 through the gather
    # and its backward
    out['train_amp_spatial'] = _train(cfg, params, inp['batches'][:1], sp4,
                                      amp=True)
    out['train_amp_unsharded'] = _train(cfg, params, inp['batches'][:1],
                                        Mesh(1, 1, device), amp=True)
    if mesh.rank == 0:
        torch.save(out, os.path.join(workdir, 'outputs.pt'))
    return {'cases': sorted(out)}


def validation_cli(mesh, device, workdir):
    """The test entry point on a data mesh of every rank: folders shared
    out, CSVs and log on rank 0."""
    from bsvd_tpu_torch.test import test_pipeline
    results = test_pipeline(os.path.join(workdir, 'dp'), cmd=[
        '-opt', os.path.join(workdir, 'opt.yml'), '--device', 'cpu',
        '--launcher', 'pytorch'])
    return {'results': results, 'mesh': mesh.shape}


def sr_train(mesh, device, workdir):
    """The zoo's engines on a data mesh of every rank (and DenoisingModel's
    perceptual loss with the rows split as well): each case of
    ``inputs.pt`` (options, a starting state per network, the global
    batches, each cut to this rank's rows as the loaders cut them)
    built, loaded and stepped; rank 0 writes each case's logged
    losses and final state dicts; every rank returns a checksum of its
    parameters."""
    from bsvd_tpu_torch.models.base_model import build_model
    inputs = torch.load(os.path.join(workdir, 'inputs.pt'),
                        weights_only=False)
    out, sums = {}, {}
    for name, case in sorted(inputs.items()):
        model = build_model(case['opt'], device=device)
        for attr, state in case['states'].items():
            getattr(model, attr).load_state_dict(state)
        logs = []
        for it, batch in enumerate(case['batches'], 1):
            n = len(batch['lq']) // mesh.size
            batch = {k: v[mesh.rank * n:(mesh.rank + 1) * n]
                     for k, v in batch.items()}
            model.feed_data(batch)
            model.optimize_parameters(it)
            logs.append(model.get_current_log())
        states = {attr: {k: v.detach().clone() for k, v in
                         getattr(model, attr).state_dict().items()}
                  for attr in case['states']}
        out[name] = {'logs': logs, 'states': states,
                     'mesh': dict(model.mesh.shape)}
        sums[name] = float(sum(v.double().sum() for s in states.values()
                               for v in s.values()))
    if mesh.rank == 0:
        torch.save(out, os.path.join(workdir, 'outputs.pt'))
    return {'sums': sums}
