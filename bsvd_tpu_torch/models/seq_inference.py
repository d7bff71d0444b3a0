"""Sequence denoising (counterpart of bsvd_tpu/models/seq_inference.py):
``denoise_seq`` over a whole clip (``temp_psz=-1``: ``mode='mimo'`` one
batched forward, ``mode='streaming'`` the frame-by-frame pipeline of
archs/streaming.streaming_apply; both give the same function) or by the
chunked MIMO protocol (``temp_psz`` < T, with ``future_buffer_len``
look-ahead frames and per-site carries, archs/wnet_arch.wnet_apply_chunk),
and ``BlockStreamDenoiser``, the chunked protocol delivered incrementally;
``denoise_seq_async`` is the whole clip left on the device, unsynchronised.

On a mesh (``parallel.mesh.Mesh``, every rank making the same call with the
same clip): a whole clip on a spatial mesh that ``spatial_ok`` takes runs
``parallel.spatial.wnet_apply_spatial``, the rows split over the ranks;
the chunked and streaming protocols on a spatial mesh, and any protocol on
a data-only mesh (N = 1), compute the unsharded function on every rank's
card (the JAX package partitions those with GSPMD). Every rank returns the
whole array. ``BlockStreamDenoiser`` puts its streams on the 'data' axis.

A whole-clip MIMO call whose activations would exceed the device's
memory budget (``_memory_budget``) runs the streaming pipeline instead,
with a warning naming the route: the streaming route computes the same
whole-clip function in O(1) frames of state. The JAX package warns and
auto-chunks there, which drops the temporal shift's future slice at chunk
ends (not the whole-clip function for bidirectional nets, ROADMAP.md
Queue 3); the port does not copy that.
"""

import logging

import numpy as np
import torch

from bsvd_tpu_torch.archs.streaming import streaming_apply
from bsvd_tpu_torch.archs.wnet_arch import (_cw, _WNetBase, prepare_params,
                                            wnet_apply, wnet_apply_chunk)
from bsvd_tpu_torch.parallel.mesh import Mesh, all_gather
from bsvd_tpu_torch.parallel.spatial import spatial_ok, wnet_apply_spatial

_log = logging.getLogger('bsvd_tpu_torch')


def _memory_budget(device, frac=0.8):
    """Usable device memory in bytes: ``frac`` of the card's total; None
    (no budget) off the card."""
    if device.type != 'cuda':
        return None
    return frac * torch.cuda.mem_get_info(device)[1]


def _resolve(params, cfg, dtype):
    """(prepared parameter tree, cfg, device) of a BSVD / TSN module or a
    parameter tree of wnet_init; the device is the one the weights lie
    on."""
    if isinstance(params, _WNetBase):
        device = next(params.parameters()).device
        return params.prepared(device, dtype), cfg or params.cfg, device
    device = _cw(params['stage0']['inc']['c1']).w.device
    return prepare_params(params, device, dtype), cfg, device


def _chunk_forward(p, x, cfg, carries, future):
    out, carries = wnet_apply_chunk(p, x, cfg, carries,
                                    future_buffer_len=future)
    return torch.clamp(out, 0., 1.), carries


def _reflect_tail(frames, t, psz, rem):
    """The ragged tail chunk: the last ``rem`` frames, then frames
    ``t-(psz-rem)-1 .. t-2`` mirrored (validation_seq_infer.py:75-81)."""
    return torch.cat([frames[t - rem:], torch.flip(
        frames[t - (psz - rem) - 1:t - 1], dims=(0,))], dim=0)


def _chunked_mimo(p, x, cfg, psz, future, den):
    """The temp_psz protocol over x (T, H, W, C) on the device: chunks of
    psz frames plus ``future`` look-ahead frames, the look-ahead disabled
    for good at the first chunk it would overrun (validation_seq_infer.py
    :67-69), then the reflect-padded ragged tail; carries threaded through.
    Each chunk's kept frames are copied into ``den`` (T, out_ch, H, W),
    without a synchronise (pinned host memory, or a CPU tensor)."""
    t = x.shape[0]
    num_seg, rem = divmod(t, psz)
    carries = None

    def keep(out, start, n):
        y = out[0, :n].permute(0, 3, 1, 2).float().contiguous()
        den[start:start + n].copy_(y, non_blocking=True)

    for i in range(num_seg):
        start, end = i * psz, (i + 1) * psz
        if end + future > t:
            future = 0
        out, carries = _chunk_forward(p, x[None, start:end + future], cfg,
                                      carries, future)
        keep(out, start, psz)
    if rem:
        out, _ = _chunk_forward(p, _reflect_tail(x, t, psz, rem)[None], cfg,
                                carries, 0)
        keep(out, num_seg * psz, rem)


_warned = set()


def _warn_once(msg):
    if msg not in _warned:
        _warned.add(msg)
        _log.warning(msg)


def _check_mesh(mesh):
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f'mesh must be a parallel.mesh.Mesh, got '
                        f'{type(mesh).__name__}')


def _clip_input(seq, noise_sigma, cfg, device, dtype):
    """(T, C, H, W) -> (T, H, W, C') on ``device`` in ``dtype``, with the
    constant noise-map channel unless the net is blind."""
    if not torch.is_tensor(seq):
        seq = torch.as_tensor(np.asarray(seq))
    t, _, h, w = seq.shape
    x = seq.to(device, dtype).permute(0, 2, 3, 1)
    if not cfg.blind and noise_sigma is not None:
        nm = torch.full((t, h, w, 1), float(noise_sigma), dtype=dtype,
                        device=device)
        x = torch.cat([x, nm], dim=-1)
    return x


def denoise_seq_async(params, cfg, seq, noise_sigma=None, mode='mimo',
                      compute_dtype=None, device=None):
    """Whole-clip denoise left on the device, without a synchronise: the
    (T, H, W, out_ch) tensor clipped to [0, 1] (the JAX package's
    validation queues the next folder with it while the host scores the
    last; the port's validation calls ``denoise_seq``, whose unsharded
    whole clip runs the same ``_whole_clip``). ``params`` as for
    ``denoise_seq``; ``device`` (default: the weights') is where it runs
    (weights elsewhere are copied there)."""
    if mode not in ('mimo', 'streaming'):
        raise ValueError(f"mode must be 'mimo' or 'streaming', got {mode!r}")
    if not torch.is_tensor(seq):
        seq = torch.as_tensor(np.asarray(seq))
    dtype = compute_dtype or seq.dtype
    p, cfg, wdev = _resolve(params, cfg, dtype)
    device = wdev if device is None else torch.device(device)
    if device != wdev:
        p = prepare_params(p, device, dtype)
    return _whole_clip(p, _clip_input(seq, noise_sigma, cfg, device, dtype),
                       cfg, mode)


def _whole_clip(p, x, cfg, mode):
    """(T, H, W, C) on the weights' device -> the clipped (T, H, W,
    out_ch), unsharded, in one forward or streamed."""
    apply = streaming_apply if mode == 'streaming' else wnet_apply
    with torch.no_grad():
        return torch.clamp(apply(p, x[None], cfg), 0., 1.)[0]


def denoise_seq(params, cfg, seq, noise_sigma=None, temp_psz=-1,
                future_buffer_len=0, mode='mimo', compute_dtype=None,
                mesh=None, host_chunks=False, device_program=False):
    """Denoise a frame sequence (the JAX signature and argument order).

    Args:
        params: a BSVD / TSN module (its cached, packed weights are used;
            ``cfg`` may then be None) or a parameter tree of wnet_init. The
            forward runs on the device the weights lie on.
        seq: (T, C, H, W) float array or tensor (on any device) in [0, 1]
            (reference layout).
        noise_sigma: noise std in [0, 1] units (a constant noise-map
            channel is appended), or None for blind nets.
        temp_psz: -1 (or >= T) denoises the whole clip; else the chunked
            MIMO protocol with chunks of ``temp_psz`` frames, each fed
            ``future_buffer_len`` look-ahead frames (the training-validation
            protocol, validation_seq_infer.py:54-89). ``mode`` then changes
            nothing, as in the JAX package.
        mode: 'mimo' (one batched forward) or 'streaming' (frame by
            frame through the buffered pipeline, drained at the end) for
            the whole clip.
        compute_dtype: torch dtype the input and weights are cast to
            (e.g. torch.bfloat16); None keeps the sequence's dtype.
        mesh: a ``parallel.mesh.Mesh`` (see the module docstring), or None.
        host_chunks, device_program: how the JAX package schedules the
            chunked protocol (a synchronising loop, one device program);
            its three schedules give the same array, and so does the port's
            one loop, which copies each chunk to pinned host memory without
            a synchronise and synchronises once at the end.
    Returns:
        (T, out_ch, H, W) numpy float32 clipped to [0, 1].
    """
    del host_chunks, device_program
    if mode not in ('mimo', 'streaming'):
        raise ValueError(f"mode must be 'mimo' or 'streaming', got {mode!r}")
    _check_mesh(mesh)
    if not torch.is_tensor(seq):
        seq = torch.as_tensor(np.asarray(seq))
    t, c, h, w = seq.shape
    dtype = compute_dtype or seq.dtype
    p, cfg, device = _resolve(params, cfg, dtype)
    whole_clip = temp_psz == -1 or temp_psz >= t
    sharded = whole_clip and mode == 'mimo' and spatial_ok(cfg, h, mesh)
    if mesh is not None and mesh.shape['spatial'] > 1 and not sharded:
        _warn_once(f'denoise_seq: {"chunked" if not whole_clip else mode} '
                   f'protocol, H {h}, norm {cfg.norm!r} on a spatial mesh: '
                   f'every rank denoises the whole clip on its card')

    if whole_clip and mode == 'mimo' and not sharded:
        # a whole-clip forward holds O(T) full-resolution activations
        per_frame = h * w * 256 * torch.empty((), dtype=dtype).element_size()
        budget = _memory_budget(device)
        if budget is not None and t * per_frame > budget:
            _log.warning(
                f'denoise_seq: whole-clip MIMO of {t} frames at {h}x{w} (~'
                f'{t * per_frame / 2**30:.1f} GB of activations) exceeds the '
                f'device budget (~{budget / 2**30:.1f} GB): running the '
                f"streaming route (mode='streaming'), the same whole-clip "
                f'function')
            mode = 'streaming'

    x = _clip_input(seq, noise_sigma, cfg, device, dtype)     # (T, H, W, C)
    # pinned host memory: a pageable copy of the permuted tensor ran at
    # ~2.4 GB/s on the H100 host (26 ms per 540p clip)
    den = torch.empty((t, cfg.out_ch, h, w), dtype=torch.float32,
                      pin_memory=device.type == 'cuda')
    with torch.no_grad():
        if sharded:
            out = torch.clamp(wnet_apply_spatial(p, x[None], cfg, mesh),
                              0., 1.)[0]
            den.copy_(out.permute(0, 3, 1, 2).float().contiguous())
        elif whole_clip:
            out = _whole_clip(p, x, cfg, mode)
            den.copy_(out.permute(0, 3, 1, 2).float().contiguous())
        else:
            _chunked_mimo(p, x, cfg, int(temp_psz), int(future_buffer_len),
                          den)
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    return den.numpy()


class BlockStreamDenoiser:
    """Throughput-mode streaming client on the chunked MIMO protocol (JAX
    BlockStreamDenoiser): frames accumulate until ``psz +
    future_buffer_len`` exist, then run as one chunk with the carried
    shift state, and ``psz`` outputs come out. ``flush()`` drains the rest
    with the look-ahead off and the reflect-padded ragged tail, so pushing
    a whole clip and flushing equals ``denoise_seq(temp_psz=psz,
    future_buffer_len=future)`` frame for frame.

    Frames are (N, H, W, C_in) (RGB + noise map unless blind), cast to
    ``dtype`` (default fp32) on the weights' device; outputs are (N, H, W,
    out_ch) device tensors clipped to [0, 1]. No call synchronises.

    ``mesh`` (a ``parallel.mesh.Mesh``; every rank pushes the same whole
    frames and gets the same whole outputs): with more than one rank on
    its 'data' axis, N-stream serving, each rank running the chunks of its
    N / data streams; where N does not divide, every rank runs them all.

    Example::

        bsd = BlockStreamDenoiser(net, None, psz=8, future_buffer_len=2,
                                  dtype=torch.bfloat16)
        for frame in video:
            for out in bsd.push(frame):   # 0 or psz frames
                emit(out)
        for out in bsd.flush():
            emit(out)
    """

    def __init__(self, params, cfg, psz=8, future_buffer_len=2, dtype=None,
                 mesh=None):
        _check_mesh(mesh)
        if psz < 1:
            raise ValueError(f'psz must be >= 1, got {psz}')
        self.dtype = dtype or torch.float32
        self.params, self.cfg, self.device = _resolve(params, cfg,
                                                      self.dtype)
        self.psz = int(psz)
        self.future = int(future_buffer_len)
        self.mesh = None
        if mesh is not None and mesh.shape['data'] > 1:
            self.mesh = mesh
        self.reset()

    def reset(self):
        self._pending = []    # frames awaiting a full chunk
        self._history = []    # the last psz + 1 frames (the flush's tail)
        self._carries = None

    @property
    def latency(self):
        """Worst-case output lag in frames (batching + look-ahead)."""
        return self.psz - 1 + self.future

    def _forward(self, frames, future):
        x = torch.stack(frames, dim=1)
        data = None if self.mesh is None else self.mesh.axis('data')
        if data is not None and x.shape[0] % data.size:
            data = None
        if data is not None:
            step = x.shape[0] // data.size
            x = x[data.index * step:(data.index + 1) * step]
        out, self._carries = _chunk_forward(self.params, x, self.cfg,
                                            self._carries, future)
        if data is not None:
            out = all_gather(out, data, 0)
        return list(out.unbind(1))

    def push(self, frame):
        """Push one frame; returns the outputs that became ready (none, or
        psz frames when a chunk completes), oldest first."""
        return self.push_block([frame])

    def push_block(self, frames):
        """Push several frames (a sequence, or a tensor with frames on its
        first axis); returns every output that became ready, oldest
        first."""
        for f in frames:
            f = torch.as_tensor(f).to(self.device, self.dtype)
            self._pending.append(f)
            self._history.append(f)
        del self._history[:-(self.psz + 1)]
        outs = []
        need = self.psz + self.future
        while len(self._pending) >= need:
            outs += self._forward(self._pending[:need], self.future)[
                :self.psz]
            del self._pending[:self.psz]
        return outs

    def flush(self):
        """End of stream: the pending frames in chunks with the look-ahead
        off, then the reflect-padded ragged tail; returns the remaining
        outputs oldest first."""
        outs = []
        while len(self._pending) >= self.psz:
            outs += self._forward(self._pending[:self.psz], 0)
            del self._pending[:self.psz]
        rem = len(self._pending)
        if rem:
            pad = self.psz - rem
            if len(self._history) < pad + 1:
                raise ValueError(
                    f'stream too short for the ragged tail: the protocol '
                    f'reflect-pads {pad} frames from before the last frame, '
                    f'but only {len(self._history) - 1} exist (total pushed '
                    f'must be > psz - rem = {pad})')
            window = self._history[-pad - 1:-1]        # frames t-pad-1..t-2
            outs += self._forward(self._pending + window[::-1], 0)[:rem]
            self._pending = []
        return outs
