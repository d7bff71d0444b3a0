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
from bsvd_tpu_torch.parallel.mesh import (Axis, Mesh, all_gather,
                                          all_reduce_sum, make_mesh,
                                          mean_over_ranks, shard_batch, world)
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


class _SGD:
    """Plain SGD over named parameters (``optax.sgd``): the normed steps'
    comparisons use it, since Adam turns the rounding noise of a gradient
    that is 0 in exact arithmetic (a conv bias before a norm) into a step
    of +-lr whose sign differs between two summation orders."""

    def __init__(self, named, lr):
        self.params, self.lr = [p for _, p in named], lr

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self):
        for p in self.params:
            if p.grad is not None:
                p -= self.lr * p.grad


def _train(cfg, params, batches, mesh, amp=False, sgd_lr=None):
    """The parameters after the steps, the losses, and the first step's
    gradients (after the all_reduce), by parameter name. ``sgd_lr``: SGD
    at that rate instead of Adam at 1e-3."""
    net = _WNetBase(cfg, params=_map_tree(params, torch.clone))
    opt = Adam(net.named_parameters(), lambda count: 1e-3) \
        if sgd_lr is None else _SGD(net.named_parameters(), sgd_lr)
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


def _same_on_ranks(tensors):
    """True when every rank holds the same bits in ``tensors``."""
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    whole = Axis('world', None, *world())
    return bool((all_gather(flat[None], whole, 0) == flat).all())


def _leaves(tree):
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in _leaves(tree[k])]
    return [tree]


def _all_reduce_grad(mesh, device):
    """A shared scalar w, rank q's statistic s_q = (w a_q)^2, S = sum_q s_q
    (``all_reduce_sum``), rank r's loss c_r S: the gradient averaged over
    the ranks (``mean_over_ranks``) against that of mean_r c_r S, and the
    collectives it took."""
    w = torch.tensor(1.5, device=device, requires_grad=True)
    a = [0.5 + q for q in range(mesh.size)]
    c = [2.0 - 0.3 * r for r in range(mesh.size)]
    axes = (mesh.axis('data'), mesh.axis('spatial'))
    calls = all_reduce_sum.calls
    s = all_reduce_sum((w * a[mesh.rank]) ** 2, axes)
    (c[mesh.rank] * s).backward()
    mean_over_ranks([w], [])
    got = float(w.grad)
    want = sum(c) / len(c) * sum(2 * 1.5 * v * v for v in a)
    return {'got': got, 'want': want, 'sum': float(s),
            'collectives': all_reduce_sum.calls - calls}


def mesh_stats(mesh, device, workdir):
    """The cases of tests/test_torch_mesh_stats.py on every rank: the
    normed train steps on each layout of ``inputs.pt['train']`` (SGD), the
    whole-clip eval of normed nets with the rows split, the engines of
    ``inputs.pt['models']`` (each rank fed its rows of the global batch),
    and the all-reduce's gradient. Rank 0 writes ``outputs.pt``; every rank
    returns whether it holds the bits of the others."""
    from bsvd_tpu_torch.models.base_model import build_model
    inp = torch.load(os.path.join(workdir, 'inputs.pt'), weights_only=False)
    devices = [device] * mesh.size
    out, same = {}, {}
    out['all_reduce_grad'] = _all_reduce_grad(mesh, device)
    for name, case in sorted(inp.get('train', {}).items()):
        m = make_mesh(mesh.size, spatial=case['spatial'], devices=devices)
        calls = all_reduce_sum.calls
        params, losses, grads = _train(WNetConfig(**case['cfg']),
                                       case['params'], case['batches'], m,
                                       sgd_lr=case['lr'])
        out[name] = {'params': params, 'losses': losses, 'grads': grads,
                     'mesh': dict(m.shape),
                     'collectives': all_reduce_sum.calls - calls}
        same[name] = _same_on_ranks(_leaves(params))
    for name, case in sorted(inp.get('eval', {}).items()):
        m = make_mesh(mesh.size, spatial=case['spatial'], devices=devices)
        cfg = WNetConfig(**case['cfg'])
        out[name] = denoise_seq(case['params'], cfg, case['seq'],
                                noise_sigma=0.1, mesh=m)
        with torch.no_grad():
            out[name + '_spatial'] = wnet_apply_spatial(
                case['params'], case['x'], cfg, m)
        same[name] = _same_on_ranks([torch.from_numpy(out[name]),
                                     out[name + '_spatial']])
    for name, case in sorted(inp.get('models', {}).items()):
        model = build_model(case['opt'], device=device)
        for attr, state in case['states'].items():
            getattr(model, attr).load_state_dict(state)
        logs = []
        for it, batch in enumerate(case['batches'], 1):
            n = len(batch['gt']) // mesh.size
            model.feed_data({k: v[mesh.rank * n:(mesh.rank + 1) * n]
                             for k, v in batch.items()})
            model.optimize_parameters(it)
            logs.append(model.get_current_log())
        states = {attr: {k: v.detach().clone() for k, v in
                         getattr(model, attr).state_dict().items()}
                  for attr in case['states']}
        rec = {'logs': logs, 'states': states, 'mesh': dict(
            model.mesh.shape)}
        tensors = [v for st in states.values() for v in st.values()]
        if hasattr(model, 'mean_path_length'):
            rec['mean_path_length'] = float(model.mean_path_length)
            tensors.append(model.mean_path_length.reshape(1))
        out[name] = rec
        same[name] = _same_on_ranks(tensors)
    if mesh.rank == 0:
        torch.save(out, os.path.join(workdir, 'outputs.pt'))
    return {'same_on_ranks': same}


def norm_layouts(mesh, device, workdir):
    """One train step (Adam) of a small WNet for each (norm, data,
    spatial) of ``inputs.pt['cases']`` on 2 ranks: the loss, whether the
    ranks hold the same parameters after, and the collectives the step's
    statistics took (``all_reduce_sum``). Rank 0 writes ``outputs.pt``."""
    inp = torch.load(os.path.join(workdir, 'inputs.pt'), weights_only=False)
    out = {}
    for norm, data, spatial in inp['cases']:
        m = make_mesh(mesh.size, spatial=spatial, devices=[device] * 2)
        cfg = WNetConfig(chns=(8, 16, 32), mid_ch=8, interm_ch=8, norm=norm,
                         act='relu6')
        calls = all_reduce_sum.calls
        params, losses, _ = _train(cfg, _WNetBase(cfg).param_tree(),
                                   inp['batches'], m)
        out[(norm, data, spatial)] = {
            'mesh': dict(m.shape), 'loss': losses[0],
            'collectives': all_reduce_sum.calls - calls,
            'same_on_ranks': _same_on_ranks(_leaves(params))}
    if mesh.rank == 0:
        torch.save(out, os.path.join(workdir, 'outputs.pt'))
    return {}
