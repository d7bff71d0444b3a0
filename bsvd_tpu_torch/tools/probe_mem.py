"""Peak device memory of the BSVD-c64 whole-clip forward (counterpart of
the JAX repo's tools/probe_mem.py).

    python -m bsvd_tpu_torch.tools.probe_mem [--frames 10] [--height 540]
        [--width 960] [--device cpu]

One (1, 10, 540, 960, 4) bf16 forward through the kernels, then through
the plain route: ``torch.cuda.max_memory_allocated`` above what was
allocated before each (the JAX tool's ``peak_bytes_in_use``), the bytes
allocated after (the output), and the forward's ms (CUDA events, median
of 3). The reference's number is 2.26 GB on an RTX 3090 (bench.py:19,
BASELINE.md). The fp32 forward through the kernels is held against the
plain route's on a 2-frame clip (1e-4 x max |ref|). On the CPU the
memory fields are null.

Prints one JSON line: ``kernels`` and ``plain`` (``peak_gb``,
``peak_above_start_gb``, ``output_gb``, ``ms``), ``params_gb``,
``check``.
"""

import sys

import torch

from bsvd_tpu_torch.archs.wnet_arch import wnet_apply
from bsvd_tpu_torch.tools import _common as c


def peak(fn, device, reps):
    """(peak GB, peak above the start GB, GB allocated after, ms)."""
    cuda = device.type == 'cuda'
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
    y = fn()
    c.sync(device)
    out = None
    if cuda:
        out = (torch.cuda.max_memory_allocated() / 1e9,
               (torch.cuda.max_memory_allocated() - start) / 1e9,
               (torch.cuda.memory_allocated() - start) / 1e9)
    del y
    ms = c.median_ms(fn, device, reps, warmup=0)
    keys = ('peak_gb', 'peak_above_start_gb', 'output_gb')
    return dict(zip(keys, out or (None,) * 3), ms=ms)


def main(argv=None):
    ap = c.parser(__doc__)
    ap.add_argument('--reps', type=int, default=3)
    args = ap.parse_args(argv)
    device, dtype = c.setup(args)
    cfg, raw, params = c.net(args, device, dtype)
    gen = torch.Generator(device=device).manual_seed(c.SEED)
    x32 = torch.rand((1, args.frames, args.height, args.width,
                      cfg.effective_in_ch), generator=gen, device=device)
    x = x32.to(dtype)
    del x32
    with torch.no_grad():
        kernels = peak(lambda: wnet_apply(params, x, cfg), device, args.reps)
        with c.plain_route():
            plain = peak(lambda: wnet_apply(params, x, cfg), device,
                         args.reps)
        small = x[:, :2].float()
        with c.plain_route():
            ref = wnet_apply(raw, small, cfg)
        err, tol = c.held('forward fp32', wnet_apply(raw, small, cfg), ref,
                          c.FP32_TOL)
    return c.emit('probe_mem', device, {
        'shape': list(x.shape), 'dtype': 'bf16', 'kernels': kernels,
        'plain': plain, 'params_gb': c.nbytes(*_leaves(params)) / 1e9,
        'reference_gb': 2.26,
        'check': {'frames': 2, 'max_abs_err_fp32': err, 'tol_fp32': tol}})


def _leaves(tree):
    if isinstance(tree, dict):
        return [v for t in tree.values() for v in _leaves(t)]
    return [tree]


if __name__ == '__main__':
    main(sys.argv[1:])
