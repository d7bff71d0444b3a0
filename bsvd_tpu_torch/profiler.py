"""Profiling and FLOPs harness of the port (counterpart of
bsvd_tpu/profiler.py, with its call signatures), on torch.profiler.

- ``Timeit('time')``: best-of-``repeat`` wall time over ``number`` calls,
  synchronised with the card at both ends (``perf_counter`` on the CPU).
- ``Timeit('trace')``: one call under ``torch.profiler`` (CPU and, with a
  card, CUDA activity), written as a Chrome trace in JAX's
  ``<trace_dir>/plugins/profile/<timestamp>/`` layout as
  ``<host>.pt.trace.json``; ``tools/parse_trace`` reads it.
- ``flops_and_memory``: FLOPs counted while the function runs (XLA's rule:
  a convolution's taps on the zero padding do no work), argument and
  output bytes, and on a card the peak allocated above the start.
- ``device_profile``: device busy time, idle share, kernels and
  ``record_function`` ranges of a run, in one call.

Named ``profiler``, not ``profile``: the repository root's ``profile.py``
shadows the standard library module of that name.
"""

import contextlib
import math
import os
import socket
import tempfile
import time

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from bsvd_tpu_torch.ops import _flops
from bsvd_tpu_torch.ops._pack import ConvWeights


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Timeit:
    """Harness timing a callable: ``Timeit('time')(fn)(*args)`` returns
    ``(result, seconds_per_call)``; ``Timeit('trace', trace_dir=d)`` traces
    one call (after one outside the trace) and returns ``(result,
    seconds)``."""

    def __init__(self, mode='time', number=5, repeat=3, trace_dir=None):
        self.mode = mode
        self.number = number
        self.repeat = repeat
        self.trace_dir = trace_dir or os.path.join(tempfile.gettempdir(),
                                                   'bsvd_tpu_torch_trace')

    def __call__(self, fn):
        if self.mode == 'time':
            def wrapped(*args, **kwargs):
                out = fn(*args, **kwargs)
                _sync()
                best = float('inf')
                for _ in range(self.repeat):
                    t0 = time.perf_counter()
                    for _ in range(self.number):
                        out = fn(*args, **kwargs)
                    _sync()
                    best = min(best, (time.perf_counter() - t0) / self.number)
                return out, best
            return wrapped
        if self.mode == 'trace':
            def wrapped(*args, **kwargs):
                out = fn(*args, **kwargs)   # warm outside the trace
                _sync()
                with _profile() as prof:
                    t0 = time.perf_counter()
                    out = fn(*args, **kwargs)
                    _sync()
                    dt = time.perf_counter() - t0
                path = _export_trace(prof, self.trace_dir)
                print(f'trace written to {path}')
                return out, dt
            return wrapped
        raise ValueError(f'unknown Timeit mode {self.mode!r}')


def _profile():
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def _export_trace(prof, trace_dir):
    """Write a finished torch.profiler run as
    ``<trace_dir>/plugins/profile/<timestamp>/<host>.pt.trace.json``;
    returns the file's path."""
    base = os.path.join(trace_dir, 'plugins', 'profile',
                        time.strftime('%Y_%m_%d_%H_%M_%S'))
    run_dir, k = base, 0
    while os.path.exists(run_dir):
        k += 1
        run_dir = f'{base}_{k}'
    os.makedirs(run_dir)
    path = os.path.join(run_dir, f'{socket.gethostname()}.pt.trace.json')
    prof.export_chrome_trace(path)
    return path


def annotate(name):
    """Named profiler region (a ``record_function`` range in the trace)."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def step_annotation(step):
    """The range of train step ``step``, named ``train#<step>``."""
    with torch.profiler.record_function(f'train#{step}'):
        yield


# ---------------------------------------------------------------------------
# FLOPs and memory
# ---------------------------------------------------------------------------

def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _conv2d_flops(input, weight, bias=None, stride=1, padding=0,
                  dilation=1, groups=1):
    """F.conv2d's FLOPs by the valid-tap rule."""
    del bias, groups
    cout, cin_g, kh, kw = weight.shape
    n = input.shape[0] if input.dim() == 4 else 1
    taps = 1
    for n_in, k, s, d, p in zip(input.shape[-2:], (kh, kw), _pair(stride),
                                _pair(dilation), (padding,) * 2
                                if isinstance(padding, (int, str))
                                else tuple(padding)):
        if p == 'same':
            n_out, p = n_in, d * (k - 1) // 2
        else:
            p = 0 if p == 'valid' else p
            n_out = (n_in + 2 * p - d * (k - 1) - 1) // s + 1
        taps *= _flops.valid_taps(n_in, n_out, k, s, p, d)
    return 2 * n * cout * cin_g * taps


def _matmul_flops(a, b, *args, **kwargs):
    m = 1 if a.dim() == 1 else a.shape[-2]
    n = 1 if b.dim() == 1 else b.shape[-1]
    batch = math.prod(torch.broadcast_shapes(a.shape[:-2], b.shape[:-2]))
    return 2 * batch * m * a.shape[-1] * n


def _linear_flops(input, weight, bias=None):
    return 2 * math.prod(input.shape[:-1]) * weight.numel()


_RULES = {F.conv2d: _conv2d_flops, torch.matmul: _matmul_flops,
          torch.Tensor.matmul: _matmul_flops,
          torch.Tensor.__matmul__: _matmul_flops, torch.mm: _matmul_flops,
          torch.Tensor.mm: _matmul_flops, torch.bmm: _matmul_flops,
          torch.Tensor.bmm: _matmul_flops, F.linear: _linear_flops}


class _LibraryFlops(TorchFunctionMode):
    """Counts the F.conv2d / matmul / F.linear calls made outside the op
    wrappers (whose plain routes are counted by the wrappers)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        rule = _RULES.get(func)
        if rule is not None and not _flops.is_hidden():
            _flops.add(rule(*args, **kwargs))
        return func(*args, **kwargs)


def _tensors(tree, seen=None):
    """The distinct tensors of a nested tree (dicts, lists, tuples,
    ConvWeights, modules)."""
    seen = {} if seen is None else seen
    if isinstance(tree, torch.Tensor):
        seen.setdefault(id(tree), tree)
    elif isinstance(tree, ConvWeights):
        _tensors((tree.w, tree.b), seen)
    elif isinstance(tree, torch.nn.Module):
        _tensors(list(tree.parameters()) + list(tree.buffers()), seen)
    elif isinstance(tree, dict):
        _tensors(list(tree.values()), seen)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _tensors(v, seen)
    return list(seen.values())


def _nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def flops_and_memory(fn, *example_args):
    """Run ``fn(*example_args)`` once and report JAX's keys where the port
    has them: ``flops`` (every convolution and product, XLA's valid-tap
    rule), on a card ``temp_size_in_bytes`` (the peak allocated during the
    call above what was allocated at its start; it resets the card's peak
    statistics), ``argument_size_in_bytes`` and ``output_size_in_bytes``.
    Keys the port cannot give (``bytes_accessed``,
    ``generated_code_size_in_bytes``) are left out, as JAX leaves out what
    its backend lacks."""
    args = _tensors(example_args)
    card = next((t.device for t in args if t.is_cuda), None)
    if card is not None:
        torch.cuda.synchronize(card)
        torch.cuda.reset_peak_memory_stats(card)
        base = torch.cuda.memory_allocated(card)
    with _flops.counting() as count, _LibraryFlops():
        out = fn(*example_args)
    rep = {'flops': float(count.flops)}
    if card is not None:
        torch.cuda.synchronize(card)
        rep['temp_size_in_bytes'] = torch.cuda.max_memory_allocated(card) \
            - base
    rep['argument_size_in_bytes'] = _nbytes(args)
    rep['output_size_in_bytes'] = _nbytes(_tensors(out))
    return rep


def count_params(params):
    """Elements of a parameter tree (dicts / lists of tensors or
    ConvWeights) or of a module's parameters and buffers (the BN running
    statistics, which JAX's tree holds as leaves)."""
    return sum(t.numel() for t in _tensors(params))


def device_memory_stats():
    """``{str(device): torch.cuda.memory_stats}`` per card, with JAX's
    ``peak_bytes_in_use`` (``allocated_bytes.all.peak``); ``{'cpu':
    None}`` without a card."""
    if not torch.cuda.is_available():
        return {'cpu': None}
    stats = {}
    for i in range(torch.cuda.device_count()):
        d = torch.device('cuda', i)
        s = dict(torch.cuda.memory_stats(d))
        s['peak_bytes_in_use'] = s.get('allocated_bytes.all.peak', 0)
        stats[str(d)] = s
    return stats


# ---------------------------------------------------------------------------
# device time of a run
# ---------------------------------------------------------------------------

def device_profile(run, n, label):
    """Device busy time (union of all device activity) and idle share of
    ``run()`` (n units of work, ending in a synchronize) under
    torch.profiler; the kernels and the ``record_function`` ranges inside
    by device time, per unit."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(label):
            run()
    events = prof.events()
    win = next(e for e in events if e.name == label)
    ws, we = win.time_range.start, win.time_range.end
    # device activity: kernels, copies and sets; a record_function range
    # also shows on the device timeline (an annotation spanning its
    # kernels), which is no activity of its own
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not e.is_user_annotation]
    spans = sorted((max(e.time_range.start, ws), min(e.time_range.end, we))
                   for e in device)
    busy, cur = 0.0, None
    for a, b in spans:
        if b <= a:
            continue
        if cur is None or a > cur[1]:
            busy += 0 if cur is None else cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    busy += 0 if cur is None else cur[1] - cur[0]
    # device time by kernel name (a CPU op's row in key_averages() carries
    # its kernels' time as well), and the device span of each range
    totals, ranges = {}, {}
    for e in events:
        if e.device_type != DeviceType.CUDA:
            continue
        into = ranges if e.is_user_annotation else totals
        into[e.name] = into.get(e.name, 0) + (e.time_range.end -
                                              e.time_range.start)
    by_name = sorted(totals.items(), key=lambda kv: -kv[1])
    ranges = {k: v / 1e3 / n for k, v in ranges.items() if k != label}
    return {'units': n, 'window_ms_per_unit': (we - ws) / 1e3 / n,
            'device_busy_ms_per_unit': busy / 1e3 / n,
            'idle_share': (1 - busy / (we - ws)) if spans else None,
            'top_device_ms_per_unit': [[k, v / 1e3 / n]
                                       for k, v in by_name[:12]],
            'by_kernel': [[k, v / 1e3 / n] for k, v in by_name],
            'ranges_device_ms_per_unit': ranges}
