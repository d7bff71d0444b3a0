"""Spatially sharded WNet forward and streaming step that keep the kernels
(counterpart of bsvd_tpu/parallel/spatial.py).

H is split over the mesh's 'spatial' axis. Each rank computes its row
block stage by stage on a HALO-EXTENDED block: the stage input (3-4
channels at stage 0, ``mid_ch`` after) is all-gathered over the axis, each
rank takes its rows +- ``stage_halo`` (zero past the image), runs the whole
stage as on one card (K1, K3, K4; K5 in the streaming step) and keeps its
centre rows. The gather is differentiable (``mesh.GatherRows``), so the
train step's gradients reach the rows other ranks computed.

Global edges: rows outside the image are zero on the edge ranks' blocks,
and a conv would write act(bias) there; a row-validity mask
(``_row_mask``) zeroes them after every conv site (the ``mask`` of
``archs.wnet_arch._Norms``), which reproduces per-conv zero padding. On
interior ranks every row is in the image and the mask is the identity.
Under a mask the two-conv K2 sites run as two K1 launches, since a chain
cannot mask its intermediate; the streaming K6 is excluded likewise.

Norms. A norm's statistics are taken over the rows each rank owns (the
centre of its extended block, ``halo / level`` rows in at each site's
resolution level: never a halo row, never a row outside the image),
all-reduced over the axis (and over 'data' for BN in a train step,
``nn.layers.norm_apply``), and every extended row is normalised with
them. A norm is then pointwise, so the halo recompute stays exact. The
mask comes after the norm and the act. A rematerialised stage replays its
all-reduces in the same order on every rank.

H must divide by 4 * n_spatial (two stride-2 levels, even shard offsets);
``spatial_ok`` gates the callers.
"""

import torch

from bsvd_tpu_torch.archs.wnet_arch import (_folded, _Norms, _remat_stage,
                                            _stage_apply)
from bsvd_tpu_torch.parallel.mesh import all_gather, gather_rows, norm_axes


def stage_halo(cfg):
    """Rows of halo one DenBlock stage needs at its input resolution: the
    garbage growth through the stage's convs (a 3x3 conv one row, stride 2
    g -> ceil((g + 1) / 2), the r=2 pixel shuffle doubles), rounded up to
    a multiple of 4 so shard offsets stay on both stride-2 grids."""
    del cfg                  # every WNet stage has this topology
    g = 2                    # inc: two 3x3 convs at full res
    g = (g + 2) // 2         # down0 stride-2 conv -> level 2
    g += 2                   # down0 cvblock
    g1 = g                   # skip x1 garbage (level 2)
    g = (g + 2) // 2         # down1 stride-2 conv -> level 4
    g += 2                   # down1 cvblock
    g += 2                   # up2 cvblock
    g += 1                   # up2 conv
    g *= 2                   # pixel shuffle -> level 2
    g = max(g, g1)           # + skip x1
    g += 2                   # up1 cvblock
    g += 1                   # up1 conv
    g *= 2                   # pixel shuffle -> level 1
    g = max(g, 2)            # + skip x0
    g += 2                   # outc
    return -(-g // 4) * 4


def spatial_ok(cfg, h, mesh, norms=False):
    """True when the sharded forward handles (cfg, H, mesh): a spatial axis
    of more than one rank, H % (4 * n_spatial) == 0, and norm 'none'
    unless ``norms``. The train step passes ``norms=True``: its norms take
    their statistics across the rows' ranks (``_local_forward``). The
    whole-clip eval keeps the JAX package's gate, so a normed net's eval
    on a spatial mesh computes the unsharded function on every rank."""
    if mesh is None:
        return False
    n_sp = mesh.shape.get('spatial', 1)
    if n_sp <= 1:
        return False
    return (norms or cfg.norm == 'none') and h % (4 * n_sp) == 0


def stream_spatial_ok(cfg, h, mesh):
    """True when spatially sharded streaming handles (cfg, H, mesh): the
    same gate as ``spatial_ok``."""
    return spatial_ok(cfg, h, mesh)


def _row_mask(s_ext, h_global):
    """The row-validity mask of an extended block whose row 0 is global row
    ``s_ext``: ``mask(v, level)`` zeroes the rows of ``v`` (H at axis -3)
    outside the image at resolution level ``level`` (1, 2, 4). In place on
    a tensor outside autograd; a ``torch.where`` under it."""
    def mask(v, level):
        start = s_ext // level     # floor division: exact, s_ext % 4 == 0
        rows = v.shape[-3]
        lo = min(max(-start, 0), rows)
        hi = max(min(h_global // level - start, rows), lo)
        if lo == 0 and hi == rows:
            return v
        if v.requires_grad:
            keep = torch.zeros(rows, 1, 1, dtype=torch.bool, device=v.device)
            keep[lo:hi] = True
            return torch.where(keep, v, v.new_zeros(()))
        v[..., :lo, :, :] = 0
        v[..., hi:, :, :] = 0
        return v
    return mask


def _extend_rows(full, start, rows):
    """Rows [start, start + rows) of ``full`` (H at axis -3), zero where
    they lie outside it; contiguous."""
    h = full.shape[-3]
    lo, hi = max(start, 0), min(start + rows, h)
    if lo == start and hi == start + rows:
        return full.narrow(-3, start, rows).contiguous()
    out = full.new_zeros(full.shape[:-3] + (rows,) + full.shape[-2:])
    if hi > lo:
        out[..., lo - start:hi - start, :, :] = full[..., lo:hi, :, :]
    return out


def _local_forward(params, x_local, cfg, h_global, axis, x_full=None,
                   bn_stats=None, axes=()):
    """Per-rank stage loop (the body JAX runs inside shard_map).

    Args:
        x_local: (N, T, H_local, W, C), this rank's row block.
        h_global: the image height.
        axis: the mesh's 'spatial' ``Axis``.
        x_full: the whole (N, T, H, W, C) input where the caller has it
            (stage 0 then takes its block without a gather).
        bn_stats: a list for train-mode BN (``wnet_arch.wnet_apply``).
        axes: the axes a norm's statistics are taken over
            (``mesh.norm_axes``; ``axis`` among them).
    Returns this rank's (N, T, H_local, W, out_ch) block; differentiable.
    """
    n, t, h_local, w, _ = x_local.shape
    halo = stage_halo(cfg)
    s_ext = axis.index * h_local - halo
    h_ext = h_local + 2 * halo
    nrm = _Norms(cfg, bn_stats, mask=_row_mask(s_ext, h_global), axes=axes,
                 owned=lambda level: (halo // level,
                                      (halo + h_local) // level))
    if not nrm.normed:
        params = _folded(params)
    stage = _remat_stage if cfg.remat and torch.is_grad_enabled() \
        else _stage_apply
    y = x_local
    for i in range(cfg.stage_num):
        full = x_full if (i == 0 and x_full is not None) else gather_rows(
            y, axis, 2)
        x_ext = _extend_rows(full, s_ext, h_ext)
        ye = stage(params[f'stage{i}'], x_ext.reshape(n * t, h_ext, w, -1),
                   cfg, t, nrm)
        y = ye.reshape(n, t, h_ext, w, -1)[:, :, halo:halo + h_local]
    return y


def wnet_apply_spatial(params, x, cfg, mesh):
    """MIMO forward with H split over the mesh's 'spatial' axis, the
    kernels kept per rank. x: the whole (N, T, H, W, C) on every rank ->
    the whole (N, T, H, W, out_ch) on every rank.

    N rides the 'data' axis when it divides; otherwise every data row
    computes the whole batch (N=1 inference)."""
    n = x.shape[0]
    data = mesh.axis('data')
    batch = data.size > 1 and n % data.size == 0
    if batch:
        step = n // data.size
        x = x[data.index * step:(data.index + 1) * step]
    sp = mesh.axis('spatial')
    h = x.shape[2]
    h_local = h // sp.size
    x_local = x[:, :, sp.index * h_local:(sp.index + 1) * h_local]
    y = all_gather(_local_forward(params, x_local, cfg, h, sp, x_full=x,
                                  axes=norm_axes(cfg.norm, mesh)), sp, 2)
    return all_gather(y, data, 0) if batch else y


# ---------------------------------------------------------------------------
# spatially sharded streaming (StreamDenoiser on a spatial mesh)
# ---------------------------------------------------------------------------
#
# The same halo recompute on the carried state: each rank holds the
# halo-extended row block (h_local + 2 * halo rows) of every buffer and
# ring (stream_init at that height); garbage grows inward through a stage
# exactly as in the extended MIMO block, so the centre rows stay exact
# frame after frame. The state needs no mask of its own: it holds lane
# slices of inputs already masked.


def stream_local_step(params, state, x_local, cfg, h_global, axis,
                      x_full=None):
    """One streaming frame on this rank (``archs.streaming.stream_step``
    on the halo-extended block: like it, no ``valid`` / ``assume_filled``
    of the JAX signature; a frame of None is the invalid one and the fill
    is read from the state).

    Args:
        state: this rank's halo-extended state (``stream_init`` at
            h_local + 2 * halo rows), BN folded params as for
            ``stream_step``.
        x_local: (N, h_local, W, C_in), this rank's rows of the frame, or
            None (an invalid frame, the drain).
        axis: the mesh's 'spatial' ``Axis``.
        x_full: the whole (N, H, W, C_in) frame where the caller has it.
    Returns (new state, this rank's (N, h_local, W, out_ch) output or
    None).
    """
    from bsvd_tpu_torch.archs.streaming import _stage_stream_step
    h_local = h_global // axis.size
    halo = stage_halo(cfg)
    s_ext = axis.index * h_local - halo
    nrm = _Norms(cfg, mask=_row_mask(s_ext, h_global))
    x = x_local
    new_state = []
    for i in range(cfg.stage_num):
        if x is not None:
            full = x_full if (i == 0 and x_full is not None) else \
                all_gather(x, axis, 1)
            x = _extend_rows(full, s_ext, h_local + 2 * halo)
        st, y = _stage_stream_step(params[f'stage{i}'], state[i], x, cfg,
                                   nrm)
        new_state.append(st)
        x = None if y is None else y[:, halo:halo + h_local]
    return new_state, x


def stream_local_step_block(params, state, xs_local, cfg, h_global, axis,
                            xs_full=None):
    """F frames in steady state on this rank (the block step,
    ``archs.streaming.stream_step_block``). xs_local: (F, N, h_local, W,
    C_in); ``xs_full`` the whole (F, N, H, W, C_in) where the caller has
    it. Returns (new state, this rank's (F, N, h_local, W, out_ch))."""
    from bsvd_tpu_torch.archs.streaming import _stage_stream_step_block
    h_local = h_global // axis.size
    halo = stage_halo(cfg)
    s_ext = axis.index * h_local - halo
    nrm = _Norms(cfg, mask=_row_mask(s_ext, h_global))
    xs = xs_local
    new_state = []
    for i in range(cfg.stage_num):
        full = xs_full if (i == 0 and xs_full is not None) else \
            all_gather(xs, axis, 2)
        x_ext = _extend_rows(full, s_ext, h_local + 2 * halo)
        st, y = _stage_stream_step_block(params[f'stage{i}'], state[i],
                                         x_ext, cfg, nrm)
        new_state.append(st)
        xs = y[:, :, halo:halo + h_local]
    return new_state, xs
