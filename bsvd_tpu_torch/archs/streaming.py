"""Streaming (pipeline) inference with explicit buffer state, in PyTorch
(counterpart of bsvd_tpu/archs/streaming.py, natural layout).

Every temporal conv holds one packed frame per stream (``_bibuffer_init``)
and one streaming step advances the whole pipeline (``shift_num`` deep:
16, or 20 with shift_input, whose two inc convs are buffered too) by one
frame;
the U-Net skips cross the pipeline delay through fixed-depth rings. A clip
fed frame by frame, then drained, equals whole-clip MIMO ``wnet_apply``
(zero temporal boundaries on both sides).

Validity is a host bool here, where the JAX package traces it: the
schedule is fixed by the push count, so an invalid frame is ``None``, a
site whose output would be invalid is skipped, and no step reads anything
back from the device. Per site:

- steady (valid input, primed buffer; every causal step): K5
  ``bibuffer_conv``, or K6 ``bibuffer_chain`` for a whole MemCvBlock when
  both its buffers are primed and ``chain_route`` takes it (at most
  ``CHAIN_MAX_C`` channels wide; the TPU routes the chain at 128 channels,
  two steps at 256; on the H100 two K5 steps beat K6 at both widths in
  both modes, so no MemCvBlock takes it);
- drain (invalid input, primed buffer): the input assembled with
  ``torch.cat`` and K1 ``conv3x3`` (shift 'none');
- fill (valid input, empty buffer): no conv, the frame is stored;
- stems and ups: K2 ``conv_chain`` / ``conv_chain_add2_res``, K3
  ``conv_s2`` and K4 ``conv_ps`` at one frame.

Norms as in archs/wnet_arch: BN runs folded into the convs (the routes of
norm 'none'); norm 'in' splits every site (kernels with act 'none', then
the norm and the act, the two-conv K2 sites as two K1, every MemCvBlock as
two K5 steps).

``stream_step_block`` advances F frames in steady state with K5
``bibuffer_multi`` at every temporal conv and the stem / up kernels at F
frames (``StreamDenoiser.push_block``).

State: a list (one per stage) of dicts. A buffered conv is ``{'packed':
(N, h, w, c) tensor, 'has_center': bool}``; a skip ring ``{'buf': (depth,
N, h, w, c) tensor, 'w': int, 'r': int}``, as the JAX state (see
convert.torch_ckpt.from_jax_stream_state). A step returns new packed
tensors (the kernels never write the state they read) and advances the
rings' buffers in place. The width-folded TPU layout is not ported.

On a mesh (``StreamDenoiser(mesh=...)``) the streams ride the 'data' axis
and the rows the 'spatial' one (parallel/spatial.py). With the rows split,
every conv output passes the row mask (``_Norms.mask``), which also keeps
K6 and K2 off the path.
"""

import logging

import torch

from bsvd_tpu_torch.archs.wnet_arch import (_cw, _down, _folded, _has_bn,
                                            _Norms, _outc, _stem, _WNetBase,
                                            prepare_params)
from bsvd_tpu_torch.ops.bibuffer_conv import (bibuffer_chain, bibuffer_conv,
                                              bibuffer_multi)
from bsvd_tpu_torch.ops.conv3x3 import conv3x3, conv_ps
from bsvd_tpu_torch.parallel.mesh import Mesh, all_gather
from bsvd_tpu_torch.parallel.spatial import (stage_halo, stream_local_step,
                                             stream_local_step_block,
                                             stream_spatial_ok)

# widest MemCvBlock (input or intermediate channels) whose step runs as
# one K6: none. K6 (the pipelined loop, the halo recompute only for the y1
# lanes conv2 reads) takes 0.53-0.61 / 0.55-0.65 ms bidirectional and
# 0.63-0.70 / 0.71-0.78 causal at 270x480x128 / 135x240x256, two K5 steps
# 0.32-0.41 in either mode (NVIDIA H100 80GB HBM3, 700.00 W;
# tools/torch_kernel_variants.py --group k6, chip_smoke.py phase 2,
# PERF.md): every MemCvBlock takes two K5 steps, in both modes
CHAIN_MAX_C = 0

_CV_SITES = ('down0', 'down1', 'up2', 'up1')


def _is_causal(cfg):
    return 'toFutureOnly' in cfg.shift_mode


# ---------------------------------------------------------------------------
# buffered temporal conv (BiBufferConv)
# ---------------------------------------------------------------------------

def _bibuffer_init(n, h, w, c, dtype, device):
    return {'packed': torch.zeros((n, h, w, c), dtype=dtype, device=device),
            'has_center': False}


def _bibuffer_step(p, k, st, x, cfg, nrm, level=1):
    """One step of buffered shift conv ``k`` ('c1' / 'c2') of block ``p``
    (+ bias, + norm, + act, then the mask at ``level``); ``x`` is the live
    frame or None (invalid). Returns (new state, output or None)."""
    cw, leaf = _cw(p[k]), p.get('n' + k[1:])
    act, fold_div = nrm.kernel_act, cfg.fold_div
    B = st['packed']
    if _is_causal(cfg):
        if x is None:
            return st, None
        y, nb = bibuffer_conv(x, B, cw, fold_div=fold_div, act=act,
                              causal=True)
        return ({'packed': nb, 'has_center': st['has_center']},
                nrm(y, leaf, level))
    f = B.shape[-1] // fold_div
    if st['has_center']:
        if x is not None:
            y, nb = bibuffer_conv(x, B, cw, fold_div=fold_div, act=act)
            return {'packed': nb, 'has_center': True}, nrm(y, leaf, level)
        # drain: the future slice is the clip's zero boundary
        inp = torch.cat([torch.zeros_like(B[..., :f]), B[..., :f],
                         B[..., 2 * f:]], dim=-1)
        nb = torch.cat([B[..., f:2 * f], B[..., f:]], dim=-1)
        return ({'packed': nb, 'has_center': False},
                nrm(conv3x3(inp, cw, act=act), leaf, level))
    if x is None:
        return st, None
    # fill: the first frame becomes the center; nothing to output yet
    nb = torch.cat([B[..., :f], x[..., f:]], dim=-1)
    return {'packed': nb, 'has_center': True}, None


def chain_route(width, max_c=None):
    """Whether a primed MemCvBlock ``width`` channels wide (input or
    intermediate) runs as one K6 ``bibuffer_chain`` rather than two K5
    steps: up to ``CHAIN_MAX_C`` channels (or ``max_c``), bidirectional
    and causal alike (K6 loses to two K5 steps in both modes). A block
    whose sites split (``_Norms.split``: a norm between conv and act, or
    the row mask of a spatial shard) never chains: K6 applies the act to
    its intermediate and cannot mask it."""
    return width <= (CHAIN_MAX_C if max_c is None else max_c)


def _buffered_pair(p, pair, x, cfg, nrm, level=1):
    """Two buffered shift convs in turn (a MemCvBlock, or shift_input's
    inc), each one step."""
    s1, y = _bibuffer_step(p, 'c1', pair[0], x, cfg, nrm, level)
    s2, y = _bibuffer_step(p, 'c2', pair[1], y, cfg, nrm, level)
    return [s1, s2], y


def _memcv_step(p, pair, x, cfg, nrm, level):
    """MemCvBlock at resolution ``level``: two buffered shift convs (+
    norm) + act; one K6 where ``chain_route`` takes it."""
    c1, c2 = _cw(p['c1']), _cw(p['c2'])
    causal = _is_causal(cfg)
    primed = causal or (pair[0]['has_center'] and pair[1]['has_center'])
    if (x is not None and primed and not nrm.split
            and chain_route(max(c1.cin, c1.cout))):
        y, s1, s2 = bibuffer_chain(x, pair[0]['packed'], pair[1]['packed'],
                                   c1, None, c2, None, fold_div=cfg.fold_div,
                                   act=cfg.act, act2=cfg.act, causal=causal)
        return [dict(pair[0], packed=s1), dict(pair[1], packed=s2)], y
    return _buffered_pair(p, pair, x, cfg, nrm, level)


# ---------------------------------------------------------------------------
# skip rings (MemSkip, fixed depth)
# ---------------------------------------------------------------------------

def _ring_init(depth, n, h, w, c, dtype, device):
    return {'buf': torch.zeros((depth, n, h, w, c), dtype=dtype,
                               device=device), 'w': 0, 'r': 0}


def _ring_push(ring, x):
    buf = ring['buf']
    buf[ring['w'] % buf.shape[0]].copy_(x)
    return dict(ring, w=ring['w'] + 1)


def _ring_pop(ring):
    """(advanced ring, the oldest entry as a view of its slot; the slot is
    rewritten only by a later step's push)."""
    buf = ring['buf']
    return dict(ring, r=ring['r'] + 1), buf[ring['r'] % buf.shape[0]]


def _ring_thread(ring, frames):
    """F push-then-pop pairs through a ring in steady state, where it is a
    pure delay line of depth - 1 frames (streaming.py _ring_thread): the
    first pops come from the stored entries, the rest from ``frames``
    (F, N, h, w, c); the entries left are rewritten to slots 0..depth-2
    (r = 0, w = depth - 1). Returns (ring, pops (F, N, h, w, c))."""
    buf = ring['buf']
    depth = buf.shape[0]
    dly = depth - 1
    f = frames.shape[0]
    if dly == 0:
        return ring, frames
    r = ring['r'] % depth
    stored = [buf[(r + j) % depth] for j in range(min(dly, f))]
    if f >= dly:
        pops = torch.stack(stored + list(frames[:f - dly]))
        new_entries = frames[f - dly:]
    else:
        pops = torch.stack(stored)
        new_entries = torch.stack([buf[(r + f + j) % depth]
                                   for j in range(dly - f)] + list(frames))
    buf[:dly].copy_(new_entries)
    return dict(ring, w=dly, r=0), pops


# ---------------------------------------------------------------------------
# streaming DenBlock stage
# ---------------------------------------------------------------------------

def _stage_stream_init(cfg, i, n, h, w, dtype, device):
    """State of stage ``i`` at input resolution (h, w)."""
    if h % 4 or w % 4:
        raise ValueError(f'streaming needs H and W multiples of 4, got '
                         f'{h}x{w}')
    c0, c1, c2 = cfg.chns
    h2, w2, h4, w4 = h // 2, w // 2, h // 4, w // 4
    kw = dict(dtype=dtype, device=device)
    st = {}
    if cfg.shift_input:
        st['inc'] = [_bibuffer_init(n, h, w, cfg.stage_io(i)[0], **kw),
                     _bibuffer_init(n, h, w, c0, **kw)]
    for site, (hh, ww, c) in zip(_CV_SITES, ((h2, w2, c1), (h4, w4, c2),
                                             (h4, w4, c2), (h2, w2, c1))):
        st[site] = [_bibuffer_init(n, hh, ww, c, **kw) for _ in range(2)]
    # ring depth = frames in flight across the skip + 1 (bidirectional);
    # skip1 also spans shift_input's two buffered inc convs
    d_inc = 2 * cfg.shift_input
    d1, d2, d3 = (1, 1, 1) if _is_causal(cfg) else (d_inc + 9, 9, 5)
    st['skip1'] = _ring_init(d1, n, h, w, cfg.residual_ch, **kw)
    st['skip2'] = _ring_init(d2, n, h, w, c0, **kw)
    st['skip3'] = _ring_init(d3, n, h2, w2, c1, **kw)
    return st


def _stage_stream_step(p, st, x, cfg, nrm):
    """One frame (or None) through one stage (reference streaming DenBlock,
    bsvd_arch.py:374-396). Returns (new state, output or None)."""
    rc = cfg.residual_ch
    new = dict(st)
    if x is not None:
        new['skip1'] = _ring_push(st['skip1'], x[..., :rc])
    if cfg.shift_input:
        new['inc'], x0 = _buffered_pair(p['inc'], st['inc'], x, cfg, nrm)
    else:
        x0 = None if x is None else _stem(p['inc'], x, cfg, nrm)
    if x0 is not None:
        new['skip2'] = _ring_push(st['skip2'], x0)

    d = p['down0']
    y = None if x0 is None else _down(d, x0, nrm, 2)
    new['down0'], x1 = _memcv_step(d['cv'], st['down0'], y, cfg, nrm, 2)
    if x1 is not None:
        new['skip3'] = _ring_push(new['skip3'], x1)

    d = p['down1']
    y = None if x1 is None else _down(d, x1, nrm, 4)
    new['down1'], x2 = _memcv_step(d['cv'], st['down1'], y, cfg, nrm, 4)

    u = p['up2']
    new['up2'], x2 = _memcv_step(u['cv'], st['up2'], x2, cfg, nrm, 4)
    if x2 is not None:
        x2 = nrm.rows(conv_ps(x2, _cw(u['conv'])), 2)
        new['skip3'], sk3 = _ring_pop(new['skip3'])
        x2 = x2 + sk3

    u = p['up1']
    new['up1'], x1u = _memcv_step(u['cv'], st['up1'], x2, cfg, nrm, 2)
    if x1u is None:
        return new, None
    x1u = nrm.rows(conv_ps(x1u, _cw(u['conv'])), 1)
    new['skip2'], sk2 = _ring_pop(new['skip2'])
    new['skip1'], sk1 = _ring_pop(new['skip1'])
    return new, _outc(p['outc'], x1u, sk2, sk1, cfg, nrm)


def _memcv_multi(p, pair, xs, cfg, nrm, level=1):
    """F-frame advance of two buffered convs in steady state (a MemCvBlock
    or shift_input's inc): K5 over F frames at each conv, then its norm
    and act where the route splits, and the mask at ``level``."""
    causal = _is_causal(cfg)
    new = []
    for k, st in zip(('c1', 'c2'), pair):
        xs, packed = bibuffer_multi(xs, st['packed'], _cw(p[k]),
                                    fold_div=cfg.fold_div,
                                    act=nrm.kernel_act, causal=causal)
        xs = nrm(xs, p.get('n' + k[1:]), level)
        new.append(dict(st, packed=packed))
    return new, xs


def _stage_stream_step_block(p, st, xs, cfg, nrm):
    """F frames (F, N, H, W, C) through one stage in steady state: F
    repetitions of _stage_stream_step with every frame valid and every
    buffer primed."""
    rc = cfg.residual_ch
    f, n = xs.shape[:2]

    def merge(v):
        return v.reshape((f * n,) + tuple(v.shape[2:]))

    def split(v):
        return v.reshape((f, n) + tuple(v.shape[1:]))

    new = dict(st)
    if cfg.shift_input:
        new['inc'], x0 = _memcv_multi(p['inc'], st['inc'], xs, cfg, nrm)
    else:
        x0 = split(_stem(p['inc'], merge(xs), cfg, nrm))
    d = p['down0']
    y = split(_down(d, merge(x0), nrm, 2))
    new['down0'], x1 = _memcv_multi(d['cv'], st['down0'], y, cfg, nrm, 2)
    d = p['down1']
    y = split(_down(d, merge(x1), nrm, 4))
    new['down1'], x2 = _memcv_multi(d['cv'], st['down1'], y, cfg, nrm, 4)
    u = p['up2']
    new['up2'], x2 = _memcv_multi(u['cv'], st['up2'], x2, cfg, nrm, 4)
    x2 = split(nrm.rows(conv_ps(merge(x2), _cw(u['conv'])), 2))
    new['skip3'], sk3 = _ring_thread(st['skip3'], x1)
    u = p['up1']
    new['up1'], x1u = _memcv_multi(u['cv'], st['up1'], x2 + sk3, cfg, nrm,
                                   2)
    x1u = nrm.rows(conv_ps(merge(x1u), _cw(u['conv'])), 1)
    new['skip2'], sk2 = _ring_thread(st['skip2'], x0)
    new['skip1'], sk1 = _ring_thread(st['skip1'], xs[..., :rc])
    return new, split(_outc(p['outc'], x1u, merge(sk2), merge(sk1), cfg,
                            nrm))


# ---------------------------------------------------------------------------
# whole net
# ---------------------------------------------------------------------------

def stream_init(cfg, n, h, w, dtype=torch.float32, device='cuda'):
    """Zero streaming state for the whole net at input resolution (h, w)."""
    return [_stage_stream_init(cfg, i, n, h, w, dtype, torch.device(device))
            for i in range(cfg.stage_num)]


def _check_folded(params):
    if _has_bn(params):
        raise ValueError('streaming takes BN folded into the convs: pass '
                         'prepare_params(...) or fold_bn(...) of the tree')


def stream_step(params, state, x, cfg):
    """Advance the pipeline by one frame.

    Args:
        params: a tree without BN leaves (``prepare_params``, or
            ``fold_bn`` of a BN tree).
        x: (N, H, W, C_in) frame, or None for an invalid one (the drain).
    Returns:
        (new state, out (N, H, W, out_ch), or None while no output is
        valid).
    """
    _check_folded(params)
    nrm = _Norms(cfg)
    new_state = []
    for i in range(cfg.stage_num):
        st, x = _stage_stream_step(params[f'stage{i}'], state[i], x, cfg, nrm)
        new_state.append(st)
    return new_state, x


def stream_step_block(params, state, xs, cfg):
    """Advance the pipeline by F frames (F, N, H, W, C_in) in steady state
    (every buffer primed, every frame valid): F ``stream_step`` advances,
    with each temporal conv one K5 launch over the F frames. Returns
    (new state, outs (F, N, H, W, out_ch)); ``params`` as for
    ``stream_step``."""
    _check_folded(params)
    nrm = _Norms(cfg)
    new_state = []
    for i in range(cfg.stage_num):
        st, xs = _stage_stream_step_block(params[f'stage{i}'], state[i], xs,
                                          cfg, nrm)
        new_state.append(st)
    return new_state, xs


def pipeline_latency(cfg):
    """Output delay in frames: shift_num (16 for two stages, 20 with
    shift_input) for the bidirectional net, 0 for the causal one."""
    return 0 if _is_causal(cfg) else cfg.shift_num


def _cast_state(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast_state(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast_state(v, dtype) for v in tree]
    return tree.to(dtype) if isinstance(tree, torch.Tensor) else tree


def streaming_apply(params, x, cfg, state_dtype=None):
    """Whole-clip streaming forward (reference BSVD.streaming_forward,
    bsvd_arch.py:501-552): feed T frames, drain with ``latency`` invalid
    steps, keep the valid outputs.

    Args:
        params: a wnet_init tree (or prepared ConvWeights) on x's device.
        x: (N, T, H, W, C_in).
        state_dtype: the dtype the buffers are carried in between frames
            (default x's); each step computes in x's dtype.
    Returns:
        (N, T, H, W, out_ch)
    """
    n, t, h, w, _ = x.shape
    params = _folded(params)
    lat = pipeline_latency(cfg)
    carry = state_dtype or x.dtype
    state = stream_init(cfg, n, h, w, carry, x.device)
    outs = []
    for i in range(t + lat):
        if carry != x.dtype:
            state = _cast_state(state, x.dtype)
        state, out = stream_step(params, state, x[:, i] if i < t else None,
                                 cfg)
        if carry != x.dtype:
            state = _cast_state(state, carry)
        if out is not None:
            outs.append(out)
    if len(outs) != t:
        raise AssertionError(f'{len(outs)} outputs for {t} frames')
    return torch.stack(outs, dim=1)


class StreamDenoiser:
    """Low-latency frame-by-frame streaming client (JAX StreamDenoiser).

    Push frames one at a time; each push returns a denoised frame delayed by
    ``latency`` frames (None while the pipeline fills). ``flush()`` drains
    the rest. No call synchronises with the device: outputs are device
    tensors, and validity follows from the push count.

    ``mesh`` (a ``parallel.mesh.Mesh``; every rank of it makes the same
    calls with the same whole frames and gets the same whole outputs):
    N-stream serving puts the N streams on the 'data' axis when it divides
    ``batch``, each rank advancing its streams; a 'spatial' axis splits the
    frame rows, each rank holding the halo-extended row block (h_local + 2 *
    halo rows) of every buffer and ring (``parallel.spatial.
    stream_local_step``). Where ``stream_spatial_ok`` refuses a spatial
    mesh (a norm, or H not a multiple of 4 * n_spatial), every rank runs
    the whole frame on its own card, as the JAX client runs unsharded
    there, and one line says so.

    Example::

        net = build_network(dict(type='BSVD', ...))   # on the card
        sd = StreamDenoiser(net, None, batch=1, height=540, width=960,
                            dtype=torch.bfloat16)
        for frame in video:          # (1, H, W, 4): RGB + noise map
            out = sd.push(frame)
            if out is not None:
                emit(out)
        for out in sd.flush():
            emit(out)
    """

    def __init__(self, params, cfg, batch, height, width,
                 dtype=torch.float32, mesh=None):
        if isinstance(params, _WNetBase):
            cfg = cfg or params.cfg
            self.device = next(params.parameters()).device
            self.params = params.prepared(self.device, dtype)
        else:
            self.device = _cw(params['stage0']['inc']['c1']).w.device
            self.params = prepare_params(params, self.device, dtype)
        self.cfg = cfg
        self.dtype = dtype
        self._shape = (batch, height, width)
        self.latency = pipeline_latency(cfg)
        self.mesh, self._data, self._spatial = None, None, None
        if mesh is not None:
            self._place(mesh, batch, height)
        self.reset()

    def _place(self, mesh, batch, height):
        """The axes this client shards over (see the class docstring)."""
        if not isinstance(mesh, Mesh):
            raise TypeError(f'mesh must be a parallel.mesh.Mesh, got '
                            f'{type(mesh).__name__}')
        data = mesh.axis('data')
        rides = data.size > 1 and batch % data.size == 0
        if mesh.shape['spatial'] > 1:
            if not stream_spatial_ok(self.cfg, height, mesh):
                logging.getLogger('bsvd_tpu_torch').warning(
                    f'StreamDenoiser: norm {self.cfg.norm!r}, H {height} '
                    f'over spatial {mesh.shape["spatial"]}: the rows are '
                    f'not split; every rank streams the whole frame')
                return
            sp = mesh.axis('spatial')
            self._spatial = {'axis': sp, 'halo': stage_halo(self.cfg),
                             'h_local': height // sp.size}
        elif not rides:
            return
        self.mesh = mesh
        self._data = data if rides else None

    def reset(self):
        n, h, w = self._shape
        if self._data is not None:
            n //= self._data.size
        if self._spatial is not None:
            h = self._spatial['h_local'] + 2 * self._spatial['halo']
        # the old state goes before the new one is built: both at once
        # would double the state's memory (16 GB at 8 streams of 540p)
        self.state = None
        self.state = stream_init(self.cfg, n, h, w, self.dtype, self.device)
        self._pushed = 0
        self._emitted = 0

    def _frame(self, frame):
        return torch.as_tensor(frame).to(self.device, self.dtype)

    def _local(self, frames, dim):
        """This rank's streams of whole frames (N at ``dim``)."""
        d = self._data
        if d is None:
            return frames
        step = frames.shape[dim] // d.size
        return frames.narrow(dim, d.index * step, step)

    def _step(self, x):
        """One step on this rank's streams: x (N, H, W, C_in) or None ->
        the whole output (gathered over the mesh) or None."""
        with torch.no_grad():
            if x is not None:
                x = self._local(x, 0)
            sp = self._spatial
            if sp is None:
                self.state, out = stream_step(self.params, self.state, x,
                                              self.cfg)
            else:
                a, h = sp['axis'], sp['h_local']
                x_loc = None if x is None else x[:, a.index * h:
                                                 (a.index + 1) * h]
                self.state, out = stream_local_step(
                    self.params, self.state, x_loc, self.cfg,
                    self._shape[1], a, x_full=x)
                if out is not None:
                    out = all_gather(out, a, 1)
        if out is not None and self._data is not None:
            out = all_gather(out, self._data, 0)
        return out

    def _emit(self, out):
        self._pushed += 1
        if self._pushed > self.latency:
            self._emitted += 1
            return out
        return None

    def push(self, frame):
        """frame (N, H, W, C_in) -> the output ``latency`` frames back, or
        None while the pipeline fills."""
        return self._emit(self._step(self._frame(frame)))

    def push_block(self, frames):
        """Advance by F frames, (F, N, H, W, C_in) or a list of (N, H, W,
        C_in): in steady state one K5 launch per temporal conv over the F
        frames; while filling, F pushes. Returns F outputs (None while
        filling)."""
        if isinstance(frames, (list, tuple)):
            frames = torch.stack([self._frame(f) for f in frames])
        else:
            frames = self._frame(frames)
        if self._pushed < self.latency:
            return [self.push(f) for f in frames]
        xs = self._local(frames, 1)
        sp = self._spatial
        with torch.no_grad():
            if sp is None:
                self.state, outs = stream_step_block(self.params, self.state,
                                                     xs, self.cfg)
            else:
                a, h = sp['axis'], sp['h_local']
                self.state, outs = stream_local_step_block(
                    self.params, self.state,
                    xs[:, :, a.index * h:(a.index + 1) * h], self.cfg,
                    self._shape[1], a, xs_full=xs)
                outs = all_gather(outs, a, 2)
        if self._data is not None:
            outs = all_gather(outs, self._data, 1)
        return [self._emit(o) for o in outs]

    def flush(self):
        """Drain the pipeline and return the outstanding outputs: always
        ``latency`` drain steps (an output exists only ``latency`` steps
        after its push), keeping the last ``pushed - emitted``."""
        if self._emitted >= self._pushed:
            return []
        outs = []
        first_valid = self.latency + self._emitted - self._pushed
        for d in range(self.latency):
            out = self._step(None)
            if d >= first_valid:
                outs.append(out)
                self._emitted += 1
        return outs
