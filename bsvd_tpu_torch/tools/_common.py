"""What the timing tools (``python -m bsvd_tpu_torch.tools.<name>``) share:
the command line's device and net options, the BSVD net at a width, CUDA
event timing (``perf_counter`` on the CPU), the switch to the plain route,
each kernel's launch count, the check of a kernel's output against its
plain version, the bound of a site, and the one JSON line a tool prints.

The plain route: on a CUDA tensor every op wrapper launches its kernel;
``plain_route()`` makes the wrappers of ``ops`` take their plain PyTorch
version instead for the calls inside it (the route they take on CPU
tensors), so that a tool times the same network both ways on the card.
"""

import argparse
import contextlib
import json
import math
import statistics
import subprocess
import time

import torch

from bsvd_tpu_torch.archs.wnet_arch import (WNetConfig, prepare_params,
                                            wnet_init)
from bsvd_tpu_torch.ops import bibuffer_conv, conv3x3, conv_chain, conv_s2
from bsvd_tpu_torch.ops._pack import ConvWeights

# the least time of a site: its operations at the H100 SXM's dense bf16
# tensor-core peak, or its bytes at the HBM3 rate, whichever is longer
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12
# a kernel in fp32 against its plain version in fp32: 1e-4 x max |ref|;
# in bf16 against the plain fp32 version on the same bf16 values: 2^-6 x
# max(1, max |ref|) (chip_smoke.py phase 2's rule)
FP32_TOL, BF16_TOL = 1e-4, 2 ** -6
# the weights' and inputs' seed
SEED = 0
# each kernel's wrapper, by the name its launch count is reported under
WRAPPERS = {'conv3x3': conv3x3.conv3x3, 'conv_chain': conv_chain.conv_chain,
            'conv_s2': conv_s2.conv_s2, 'conv_ps': conv3x3.conv_ps,
            'bibuffer_conv': bibuffer_conv.bibuffer_conv,
            'bibuffer_multi': bibuffer_conv.bibuffer_multi,
            'bibuffer_chain': bibuffer_conv.bibuffer_chain,
            'conv3x3_dw': conv3x3.conv3x3_dw}
_ROUTED = (conv3x3, conv_chain, conv_s2, bibuffer_conv)
DTYPES = {'bf16': torch.bfloat16, 'fp32': torch.float32}


def parser(doc, frames=10, height=540, width=960):
    """The options every tool takes: the device (the card unless ``--device
    cpu``), the net's widths (BSVD-c64 by default) and the clip size."""
    ap = argparse.ArgumentParser(description=doc.split('\n\n')[0])
    ap.add_argument('--device', default='cuda', choices=['cuda', 'cpu'])
    ap.add_argument('--chns', default='64,128,256',
                    help='the WNet widths, comma-separated')
    ap.add_argument('--interm_ch', type=int, default=64)
    ap.add_argument('--mid_ch', type=int, default=64)
    ap.add_argument('--frames', type=int, default=frames)
    ap.add_argument('--height', type=int, default=height)
    ap.add_argument('--width', type=int, default=width)
    return ap


def setup(args):
    """(device, the timed dtype: bf16) of the parsed options; TF32 off, so
    that fp32 on the card is fp32. Raises SystemExit where the card is
    asked for and there is none."""
    device = torch.device(args.device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise SystemExit('no CUDA device: pass --device cpu')
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return device, torch.bfloat16


def config(args, shift_mode='TSM'):
    """The WNetConfig of the options (options/test/bsvd_c64.yml's net at
    the default widths)."""
    return WNetConfig(chns=tuple(int(c) for c in args.chns.split(',')),
                      mid_ch=args.mid_ch, interm_ch=args.interm_ch,
                      norm='none', act='relu6', shift_mode=shift_mode)


def net(args, device, dtype, shift_mode='TSM'):
    """(cfg, raw fp32 parameters on the device, parameters prepared in
    ``dtype``) from ``SEED``."""
    cfg = config(args, shift_mode)
    raw = prepare_params(wnet_init(cfg, seed=SEED), device,
                         torch.float32)
    return cfg, raw, prepare_params(raw, device, dtype)


def sync(device):
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize()


def median_ms(fn, device, reps=10, warmup=2):
    """Median ms of ``fn()``: CUDA events on the card, the host clock on
    the CPU."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if torch.device(device).type == 'cuda':
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def best_ms_per(fn, n, device, reps=3):
    """Best of ``reps`` host-clock ms per unit over ``fn()`` doing ``n``
    units, synchronised at both ends (bench.py's protocol)."""
    best = float('inf')
    for _ in range(reps):
        sync(device)
        t0 = time.perf_counter()
        fn()
        sync(device)
        best = min(best, (time.perf_counter() - t0) / n)
    return best * 1e3


@contextlib.contextmanager
def plain_route():
    """Inside: every op wrapper runs its plain PyTorch version, on any
    device (no kernel launches, nothing counted)."""
    saved = [m.is_cpu for m in _ROUTED]
    for m in _ROUTED:
        m.is_cpu = lambda x: True
    try:
        yield
    finally:
        for m, f in zip(_ROUTED, saved):
            m.is_cpu = f


def launches():
    """Each kernel's launch count so far."""
    return {k: f.launches for k, f in WRAPPERS.items()}


def launches_since(before):
    """The launches since ``before`` (``launches()``), kernels with none
    left out."""
    return {k: v - before[k] for k, v in launches().items()
            if v != before[k]}


def held(name, got, ref, rel):
    """Max |got - ref| against ``rel`` x max |ref| (fp32's 1e-4) or ``rel``
    x max(1, max |ref|) (bf16's 2^-6); raises AssertionError outside it.
    Returns (err, tol)."""
    got, ref = got.float(), ref.float()
    if got.shape != ref.shape:
        raise AssertionError(f'{name}: shape {tuple(got.shape)} != '
                             f'{tuple(ref.shape)}')
    scale = ref.abs().max().item()
    tol = rel * (scale if rel == FP32_TOL else max(1.0, scale))
    err = (got - ref).abs().max().item()
    if not err <= tol:
        raise AssertionError(f'{name}: max |diff| {err} > {tol}')
    return err, tol


def bound(flops, n_bytes):
    """(ms, 'operations' or 'bytes'): the least time of the work at the
    card's peaks."""
    ops_ms, bytes_ms = flops / PEAK_FLOPS * 1e3, n_bytes / PEAK_BYTES * 1e3
    return max(ops_ms, bytes_ms), ('operations' if ops_ms >= bytes_ms
                                   else 'bytes')


def nbytes(*ts):
    """Bytes of tensors (and ConvWeights' weights and biases)."""
    total = 0
    for t in ts:
        if isinstance(t, ConvWeights):
            total += nbytes(t.w, t.b)
        elif t is not None:
            total += t.numel() * t.element_size()
    return total


def conv_flops(n, h, w, cin, cout, stride=1):
    """FLOPs of a 3x3 conv (MACs x 2, padded taps) at output h x w."""
    return 2 * 9 * cin * cout * n * math.ceil(h / stride) * \
        math.ceil(w / stride)


def site(name, run, plain, library, flops, inputs, device, reps=10):
    """One site: ``run(dtype)`` the kernel's call and ``plain(dtype)`` its
    plain version on the same values cast to ``dtype``; ``library`` one
    PyTorch call of the same function (or None). Times kernel, plain and
    library in bf16 and holds the kernel against the plain fp32 version in
    fp32 (1e-4 x max |ref|) and in bf16 (2^-6 x max(1, max |ref|)).
    Returns the site's record, its launches and the outputs' bytes."""
    ref = plain(torch.float32)
    before = launches()
    got32 = run(torch.float32)
    err32, tol32 = held(f'{name} fp32', got32, ref, FP32_TOL)
    got16 = run(torch.bfloat16)
    err16, tol16 = held(f'{name} bf16', got16, ref, BF16_TOL)
    n = launches_since(before)
    del got32, ref
    ms = median_ms(lambda: run(torch.bfloat16), device, reps)
    plain_ms = median_ms(lambda: plain(torch.bfloat16), device, reps)
    lib_ms = None if library is None else median_ms(library, device, reps)
    b_ms, by = bound(flops, inputs + nbytes(got16))
    return {'site': name, 'ms': ms, 'plain_ms': plain_ms,
            'library_ms': lib_ms, 'bound_ms': b_ms, 'bound_by': by,
            'flops': flops, 'max_abs_err_fp32': err32, 'tol_fp32': tol32,
            'max_abs_err_bf16': err16, 'tol_bf16': tol16,
            'launches_per_call': {k: v // 2 for k, v in n.items()}}


def smi():
    """``nvidia-smi``'s name and power limit of card 0, or None."""
    try:
        return subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader', '-i', '0'], capture_output=True,
            text=True, timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def emit(tool, device, record):
    """Print the tool's one JSON line (its name, the device's name and,
    on the card, nvidia-smi's name and power limit, then ``record``) and
    return it."""
    device = torch.device(device)
    head = {'tool': tool, 'device': device.type,
            'device_name': (torch.cuda.get_device_name(device)
                            if device.type == 'cuda' else 'cpu'),
            'nvidia_smi': smi() if device.type == 'cuda' else None}
    out = dict(head, **record)
    print(json.dumps(out), flush=True)
    return out
