"""Sequence denoising of a whole clip (counterpart of bsvd_tpu/models/
seq_inference.py denoise_seq with ``temp_psz=-1``): ``mode='mimo'`` runs
one batched forward, ``mode='streaming'`` the frame-by-frame pipeline
(archs/streaming.streaming_apply); both give the same function.

The chunked protocol (``temp_psz``, carries, auto-chunking of long clips)
is not ported yet: asking for it raises NotImplementedError rather than
answering another way.
"""

import numpy as np
import torch

from bsvd_tpu_torch.archs.streaming import streaming_apply
from bsvd_tpu_torch.archs.wnet_arch import (_cw, _WNetBase, prepare_params,
                                            wnet_apply)

_LATER = ('waits for the chunked inference port (ROADMAP.md Queue 1, '
          'seq_inference)')


def _memory_budget(device, frac=0.8):
    """Usable device memory in bytes: ``frac`` of the card's total."""
    return frac * torch.cuda.mem_get_info(device)[1]


def denoise_seq(params, cfg, seq, noise_sigma=None, temp_psz=-1,
                future_buffer_len=0, mode='mimo', compute_dtype=None,
                mesh=None, host_chunks=False, device_program=False):
    """Denoise a frame sequence as one whole clip (the JAX signature and
    argument order).

    Args:
        params: a BSVD / TSN module (its cached, packed weights are used;
            ``cfg`` may then be None) or a parameter tree of wnet_init. The
            forward runs on the device the weights lie on.
        seq: (T, C, H, W) float array in [0, 1] (reference layout).
        noise_sigma: noise std in [0, 1] units (a constant noise-map
            channel is appended), or None for blind nets.
        temp_psz, future_buffer_len: the chunked protocol; only the whole
            clip (``temp_psz`` -1 or >= T) is ported, where the look-ahead
            changes nothing.
        mode: 'mimo' (one batched forward) or 'streaming' (frame by
            frame through the buffered pipeline, drained at the end).
        compute_dtype: torch dtype the input and weights are cast to
            (e.g. torch.bfloat16); None keeps the sequence's dtype.
        mesh: must be None (spatial sharding is not ported).
        host_chunks, device_program: how the JAX package runs the chunked
            protocol; nothing to choose on the whole clip.
    Returns:
        (T, out_ch, H, W) numpy float32 clipped to [0, 1].
    """
    if mode not in ('mimo', 'streaming'):
        raise ValueError(f"mode must be 'mimo' or 'streaming', got {mode!r}")
    if mesh is not None:
        raise NotImplementedError('denoise_seq(mesh=...): spatial sharding '
                                  'waits for the parallel port (ROADMAP.md '
                                  'Queue 1 item 5)')
    seq = torch.as_tensor(np.asarray(seq))
    t, c, h, w = seq.shape
    if not (temp_psz == -1 or temp_psz >= t):
        raise NotImplementedError(f'temp_psz={temp_psz} (chunked MIMO) '
                                  f'{_LATER}')
    net = params if isinstance(params, _WNetBase) else None
    if net is not None:
        cfg = cfg or net.cfg
        device = next(net.parameters()).device
    else:
        device = _cw(params['stage0']['inc']['c1']).w.device
    dtype = compute_dtype or seq.dtype

    if device.type == 'cuda' and mode == 'mimo':
        # a whole-clip forward holds O(T) full-resolution activations
        per_frame = h * w * 256 * torch.empty((), dtype=dtype).element_size()
        budget = _memory_budget(device)
        if t * per_frame > budget:
            raise NotImplementedError(
                f'whole-clip MIMO of {t} frames at {h}x{w} (~'
                f'{t * per_frame / 2**30:.1f} GB of activations) exceeds the '
                f'device budget (~{budget / 2**30:.1f} GB); auto-chunking '
                f'{_LATER}')

    p = (net.prepared(device, dtype) if net is not None
         else prepare_params(params, device, dtype))
    x = seq.to(device, dtype).permute(0, 2, 3, 1)           # (T, H, W, C)
    if not cfg.blind and noise_sigma is not None:
        nm = torch.full((t, h, w, 1), float(noise_sigma), dtype=dtype,
                        device=device)
        x = torch.cat([x, nm], dim=-1)
    with torch.no_grad():
        apply = streaming_apply if mode == 'streaming' else wnet_apply
        out = torch.clamp(apply(p, x[None], cfg), 0., 1.)[0]
    out = out.permute(0, 3, 1, 2).float().contiguous()
    if device.type != 'cuda':
        return out.numpy()
    # one contiguous copy into pinned host memory: a pageable copy of the
    # permuted tensor ran at ~2.4 GB/s on the H100 host (26 ms per 540p clip)
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    host.copy_(out)
    return host.numpy()
