"""Process groups and the ('data', 'spatial') mesh on torch.distributed
(counterpart of bsvd_tpu/parallel/mesh.py).

The JAX package is single-controller SPMD: one process, a ``Mesh`` of
devices, ``shard_map`` bodies with ``all_gather`` / ``pmean``. PyTorch runs
one process per rank, so here a ``Mesh`` is this rank's view of a grid of
ranks over the default process group: ``shape`` ({'data': d, 'spatial':
s}), ``size``, this rank's coordinates (rank r sits at data r // s,
spatial r % s) and one process group per axis (``Mesh.axis``). A
``shard_map`` body becomes the same function run on every rank on its own
slice (``shard_batch``), and its collectives run on the axis' group
(``all_gather``, ``GatherRows``, ``all_reduce_mean``). A mesh spans every
rank of the group.

Launching on several cards::

    python -m torch.distributed.run --nproc_per_node 2 -m bsvd_tpu_torch.train \\
        -opt options/train/bsvd_c64_unblind.yml --launcher pytorch

with ``num_gpu: auto`` (or the number of processes) and, for rows split
over cards, ``parallel: {spatial: 2}`` in the options. NCCL needs a card
per rank: two ranks that share one card (or a CPU run) pass
``backend='gloo'`` to ``init_distributed``.

The JAX package's ``get_shard_map`` (a shim between JAX versions) has no
counterpart.
"""

import functools
import os
import subprocess
import warnings

import torch
import torch.distributed as dist

AXES = ('data', 'spatial')


def world():
    """(rank, world size) of the default process group; (0, 1) without
    one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_main_process():
    """True on rank 0, and in a run without a process group."""
    return world()[0] == 0


def master_only(func):
    """Run ``func`` on the main process only (None elsewhere): every rank
    runs the same script, so writes to a shared file system are made
    once."""
    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        if is_main_process():
            return func(*args, **kwargs)
        return None
    return wrapper


def barrier():
    """Wait for every rank (nothing without a process group)."""
    if world()[1] > 1:
        dist.barrier()


def _slurm_head(env):
    nodelist = env.get('SLURM_STEP_NODELIST', env.get('SLURM_NODELIST', ''))
    try:
        out = subprocess.run(['scontrol', 'show', 'hostname', nodelist],
                             capture_output=True, text=True, check=True,
                             timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return ''
    return out.splitlines()[0].strip() if out.strip() else ''


def _local_ranks(env, num_processes):
    """Ranks on this host: the launcher's count, else all of them."""
    for key in ('LOCAL_WORLD_SIZE', 'SLURM_NTASKS_PER_NODE'):
        if env.get(key, '').isdigit():
            return int(env[key])
    return num_processes


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, local_device_ids=None, port=None,
                     backend=None):
    """Join the default process group, from explicit arguments or the
    environment, in the JAX package's order:

      1. explicit arguments;
      2. ``BSVD_COORDINATOR`` / ``BSVD_NUM_PROCESSES`` / ``BSVD_PROCESS_ID``;
      3. torchrun's ``MASTER_ADDR`` / ``MASTER_PORT`` / ``RANK`` /
         ``WORLD_SIZE`` / ``LOCAL_RANK``;
      4. SLURM with more than one task (``SLURM_PROCID`` / ``SLURM_NTASKS``,
         the first host of the step's node list and ``port``, else
         ``BSVD_PORT``, else 12321).

    A no-op that returns (0, 1) where none applies. Idempotent.

    ``backend``: None chooses NCCL, which needs a card for every rank of a
    host; where there is no card, or fewer cards than ranks (two ranks on
    one card), it raises and asks for ``backend='gloo'``. A failed NCCL
    init is not retried on gloo. Each rank's card is ``local_device_ids[0]``,
    else its local rank (``LOCAL_RANK``, ``SLURM_LOCALID``, else its rank),
    modulo the cards present, and is made the current one.

    Returns:
        (rank, world size)
    """
    if dist.is_initialized():
        return world()
    env = os.environ
    local_rank = None
    if coordinator_address is None and 'BSVD_COORDINATOR' in env:
        coordinator_address = env['BSVD_COORDINATOR']
        num_processes = int(env.get('BSVD_NUM_PROCESSES', num_processes or 1))
        process_id = int(env.get('BSVD_PROCESS_ID', process_id or 0))
    if (coordinator_address is None and 'MASTER_ADDR' in env
            and 'RANK' in env and 'WORLD_SIZE' in env):
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', port or 29500)}")
        num_processes, process_id = int(env['WORLD_SIZE']), int(env['RANK'])
        local_rank = int(env.get('LOCAL_RANK', 0))
    if (coordinator_address is None and 'SLURM_PROCID' in env
            and int(env.get('SLURM_NTASKS', '1')) > 1):
        # single-task jobs skip the group: a default-port coordinator
        # would collide between unrelated jobs sharing a node
        process_id = int(env['SLURM_PROCID'])
        num_processes = int(env['SLURM_NTASKS'])
        local_rank = int(env.get('SLURM_LOCALID', 0))
        head = _slurm_head(env)
        if head:
            coordinator_address = f"{head}:{port or env.get('BSVD_PORT', 12321)}"
    if coordinator_address is None:
        return 0, 1

    if num_processes is None:
        num_processes = env.get('BSVD_NUM_PROCESSES')
    if process_id is None:
        process_id = env.get('BSVD_PROCESS_ID')
    if num_processes is None or process_id is None:
        raise ValueError(
            'init_distributed: coordinator_address given but '
            'num_processes/process_id unresolved — pass them explicitly '
            'or export BSVD_NUM_PROCESSES/BSVD_PROCESS_ID')
    num_processes, process_id = int(num_processes), int(process_id)
    if local_device_ids:
        local_rank = int(local_device_ids[0])
    elif local_rank is None:
        local_rank = process_id
    cards = torch.cuda.device_count()
    if backend is None:
        if cards == 0 or cards < _local_ranks(env, num_processes):
            raise ValueError(
                f'init_distributed: NCCL needs a card for every rank '
                f'({cards} card(s) for {_local_ranks(env, num_processes)} '
                f"local rank(s)): pass backend='gloo' for ranks that share "
                f'a card or run on the CPU')
        backend = 'nccl'
    if cards:
        torch.cuda.set_device(local_rank % cards)
    init = coordinator_address if '://' in coordinator_address \
        else f'tcp://{coordinator_address}'
    dist.init_process_group(backend, init_method=init,
                            world_size=num_processes, rank=process_id)
    return world()


class Axis:
    """One axis of a mesh as this rank sees it (what an axis name is inside
    a JAX shard_map body): its process group (None where the axis holds
    this rank alone), this rank's index on it and its size."""

    def __init__(self, name, group, index, size):
        self.name, self.group, self.index, self.size = name, group, index, size

    def __repr__(self):
        return f'Axis({self.name!r}, index={self.index}, size={self.size})'


class Mesh:
    """A ('data', 'spatial') grid of the ranks of the default process group
    (``make_mesh``): ``shape``, ``size``, ``coords`` (this rank's index on
    each axis), ``device`` (this rank's) and ``axis(name)``."""

    def __init__(self, data, spatial, device, groups=None):
        self.rank = world()[0]
        self.shape = {'data': data, 'spatial': spatial}
        self.size = data * spatial
        self.coords = {'data': self.rank // spatial,
                       'spatial': self.rank % spatial}
        self.device = torch.device(device)
        self._groups = dict(groups or {})

    def axis(self, name):
        return Axis(name, self._groups.get(name), self.coords[name],
                    self.shape[name])

    def __repr__(self):
        return f'Mesh({self.shape}, rank={self.rank}, device={self.device})'


def _default_device():
    if torch.cuda.is_available():
        return torch.device('cuda', torch.cuda.current_device())
    return torch.device('cpu')


def make_mesh(num_devices=None, spatial=1, devices=None, strict=True):
    """Build a ('data', 'spatial') mesh over every rank.

    Args:
        num_devices: ranks in the mesh (None or 'auto': the world size;
            more than there are is cut to the world size, as the JAX
            package cuts it to its devices; fewer raises, since a mesh spans
            every rank).
        spatial: size of the spatial axis (must divide the ranks).
        devices: each rank's device, indexed by rank (None: its current
            card, else the CPU).
        strict: raise when ``spatial`` does not divide the ranks;
            ``strict=False`` degrades to spatial 1 with a warning.

    Every rank must call it, in the same order as the others: it makes
    the axes' process groups.
    """
    rank, size = world()
    n = size if num_devices in (None, 'auto') else int(num_devices)
    n = max(1, min(n, size))
    if n != size:
        raise ValueError(f'make_mesh: {n} of {size} ranks; a mesh spans '
                         f'every rank')
    if n % spatial != 0:
        if strict:
            raise ValueError(f'spatial axis {spatial} does not divide '
                             f'device count {n}')
        warnings.warn(f'spatial axis {spatial} does not divide device count '
                      f'{n}; degrading to spatial=1', stacklevel=2)
        spatial = 1
    data = n // spatial
    groups = {}
    if size > 1:
        # every rank makes every group, in one order (new_group is
        # collective), and keeps those it belongs to
        layouts = {'spatial': [[d * spatial + j for j in range(spatial)]
                               for d in range(data)],
                   'data': [[j * spatial + s for j in range(data)]
                            for s in range(spatial)]}
        for name in AXES:
            if len(layouts[name][0]) == 1:
                continue
            for ranks in layouts[name]:
                g = dist.new_group(ranks)
                if rank in ranks:
                    groups[name] = g
    device = devices[rank] if devices is not None else _default_device()
    return Mesh(data, spatial, device, groups)


class Sharding:
    """Which mesh axis (or None) splits each dimension of an array: the
    PartitionSpec of a JAX NamedSharding. ``local`` is this rank's block of
    a global array."""

    def __init__(self, mesh, spec):
        self.mesh, self.spec = mesh, tuple(spec)

    def local(self, x):
        for dim, name in enumerate(self.spec):
            if name is not None and self.mesh.shape[name] > 1:
                k, i = self.mesh.shape[name], self.mesh.coords[name]
                if x.shape[dim] % k:
                    raise ValueError(f'dimension {dim} ({x.shape[dim]}) does '
                                     f'not divide over {name} ({k})')
                step = x.shape[dim] // k
                x = x[(slice(None),) * dim + (slice(i * step,
                                                    (i + 1) * step),)]
        return x


def batch_sharding(mesh, ndim, batch_axis=0, spatial_axis=None):
    """The sharding of an activation batch: dim ``batch_axis`` over 'data'
    (None leaves the batch whole, e.g. N=1 inference), dim ``spatial_axis``
    over 'spatial' where that axis has more than one rank."""
    spec = [None] * ndim
    if batch_axis is not None:
        spec[batch_axis] = 'data'
    if spatial_axis is not None and mesh.shape['spatial'] > 1:
        spec[spatial_axis] = 'spatial'
    return Sharding(mesh, spec)


def replicated_sharding(mesh):
    """Every rank holds the whole array: ``local`` is the identity."""
    return Sharding(mesh, ())


def shard_batch(mesh, tree, batch_axis=0, spatial_axis=None):
    """This rank's block of every array of a (nested dict / list) tree,
    batch over 'data' and optionally rows over 'spatial'."""
    if isinstance(tree, dict):
        return {k: shard_batch(mesh, v, batch_axis, spatial_axis)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_batch(mesh, v, batch_axis, spatial_axis)
                          for v in tree)
    return batch_sharding(mesh, tree.ndim, batch_axis,
                          spatial_axis).local(tree)


# ---------------------------------------------------------------------------
# collectives on an axis
# ---------------------------------------------------------------------------

def all_gather(x, axis, dim):
    """The blocks of ``x`` of every rank of ``axis``, concatenated along
    ``dim`` in axis order (JAX all_gather with tiled=True); ``x`` itself
    where the axis has one rank. Not differentiable (``GatherRows`` is).
    ``all_gather.bytes`` counts the bytes this rank received from the
    others."""
    if axis.size == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(axis.size)]
    dist.all_gather(parts, x, group=axis.group)
    all_gather.bytes += (axis.size - 1) * x.numel() * x.element_size()
    return torch.cat(parts, dim=dim)


all_gather.bytes = 0


class GatherRows(torch.autograd.Function):
    """``all_gather`` with its transpose as the backward: every rank's
    gradient of the gathered tensor is summed over the axis
    (``all_reduce``) and this rank keeps its own block, JAX's
    psum_scatter. Written here rather than taken from
    torch.distributed.nn, whose backward needs all_to_all, which gloo does
    not run on CUDA tensors."""

    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim, ctx.n = axis, dim, x.shape[dim]
        return all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.axis.group)
        return g.narrow(ctx.dim, ctx.axis.index * ctx.n, ctx.n), None, None


def gather_rows(x, axis, dim):
    """``all_gather`` along ``dim``, differentiable where ``x`` needs a
    gradient."""
    if axis.size > 1 and torch.is_grad_enabled() and x.requires_grad:
        return GatherRows.apply(x, axis, dim)
    return all_gather(x, axis, dim)


def all_reduce_mean(flat):
    """In place: the mean of ``flat`` over every rank (one collective)."""
    n = world()[1]
    if n > 1:
        dist.all_reduce(flat)
        flat.div_(n)
    return flat


def mean_over_ranks(params, losses):
    """Every parameter's gradient and each loss, averaged over every rank
    in one all_reduce of one flat fp32 buffer (nothing where there is one
    rank); returns the losses' means."""
    if world()[1] == 1:
        return [v.detach() for v in losses]
    grads = [torch.zeros_like(p) if p.grad is None else p.grad
             for p in params]
    flat = torch.cat([g.reshape(-1).float() for g in grads]
                     + [v.detach().reshape(1).float() for v in losses])
    all_reduce_mean(flat)
    at = 0
    for p, g in zip(params, grads):
        p.grad = flat[at:at + g.numel()].view_as(g).to(g.dtype)
        at += g.numel()
    return list(flat[at:])


def gather_objects(obj):
    """[obj of rank 0, obj of rank 1, ...] on every rank (pickled)."""
    n = world()[1]
    if n == 1:
        return [obj]
    out = [None] * n
    dist.all_gather_object(out, obj)
    return out


def broadcast_object(obj):
    """Rank 0's ``obj`` on every rank."""
    if world()[1] == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]
