"""Read a torch.profiler Chrome trace and print where the device time goes
(counterpart of the repository's tools/parse_trace.py, which reads
jax.profiler's xplane files).

    python -m bsvd_tpu_torch.tools.parse_trace <trace_dir or .json> \\
        [--top 40] [--group] [--json]

It reads the newest ``*.pt.trace.json`` under ``<trace_dir>/plugins/
profile/`` (what ``profiler.Timeit('trace')`` and ``python -m
bsvd_tpu_torch.profile_net --trace`` write). Device time is summed per
kernel name over the device events (``cat`` kernel, gpu_memcpy,
gpu_memset; the ``gpu_user_annotation`` copies of host ranges are no
activity of their own). ``--group`` folds the names into the port's
kernels K1-K7, library convolutions, torch's elementwise kernels, copies
and sets, and other. The longest idle gaps of the device are listed with
the host op (``cpu_op``, or a CUDA runtime call such as a synchronize)
and the ``record_function`` range that were running at the time.
``--json`` prints all of it as one JSON line. A trace taken on the CPU
has no device events: the host ops are listed instead.
"""

import argparse
import collections
import glob
import json
import os
import re
import sys

DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
# host work a device gap is attributed to
HOST_OP_CATS = ('cpu_op', 'cuda_runtime', 'cuda_driver')
# first match wins: K7 before K1, K6 before K5
GROUP_PATTERNS = (
    ('K7 conv3x3_dw', r'conv3x3_dw'),
    ('K1 conv3x3', r'conv3x3_(bf16|fma)_kernel'),
    ('K2 conv_chain', r'conv_chain'),
    ('K3 conv_s2', r'conv_s2'),
    ('K4 conv_ps', r'conv_ps'),
    ('K6 bibuf_chain', r'bibuf_chain'),
    ('K5 bibuf', r'bibuf_(bf16|fma)_kernel'),
    ('library convolution', r'cudnn|cutlass|xmma|implicit_gemm'),
    ('copies and sets', r'^Memcpy|^Memset|copy'),
    ('torch elementwise', r'elementwise|vectorized|unrolled|reduce_kernel'),
)
GAPS_SHOWN = 10


def group_name(name, cat='kernel'):
    """The group of a device event."""
    if cat in ('gpu_memcpy', 'gpu_memset'):
        return 'copies and sets'
    for g, pat in GROUP_PATTERNS:
        if re.search(pat, name, re.IGNORECASE):
            return g
    return 'other'


def find_trace(path):
    """The trace file: ``path`` itself, or the newest ``*.pt.trace.json``
    under its ``plugins/profile/`` (or anywhere below it)."""
    if os.path.isfile(path):
        return path
    paths = glob.glob(os.path.join(path, 'plugins', 'profile', '*',
                                   '*.pt.trace.json')) or glob.glob(
        os.path.join(path, '**', '*.pt.trace.json'), recursive=True)
    if not paths:
        raise FileNotFoundError(f'no *.pt.trace.json under {path}')
    return max(paths, key=os.path.getmtime)


def _union(spans):
    """Merged [start, end) intervals of the spans, in order."""
    merged = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _innermost(events, t):
    """The name of the shortest event that spans time t, or None."""
    best = None
    for e in events:
        if e['ts'] <= t <= e['ts'] + e['dur'] and (
                best is None or e['dur'] < best['dur']):
            best = e
    return None if best is None else best['name']


def summarize(trace_path, top=40):
    """Device and host time of one Chrome trace, in ms."""
    with open(trace_path) as f:
        events = [e for e in json.load(f)['traceEvents']
                  if e.get('ph') == 'X' and 'dur' in e]
    device = [e for e in events if e.get('cat') in DEVICE_CATS]
    host_ops = [e for e in events if e.get('cat') in HOST_OP_CATS]
    ops = [e for e in host_ops if e['cat'] == 'cpu_op']
    ranges = [e for e in events if e.get('cat') == 'user_annotation']
    rep = {'trace': trace_path}
    per, count, groups = (collections.Counter(), collections.Counter(),
                          collections.defaultdict(lambda: [0.0, 0]))
    for e in device:
        per[e['name']] += e['dur']
        count[e['name']] += 1
        g = groups[group_name(e['name'], e['cat'])]
        g[0] += e['dur'] / 1e3
        g[1] += 1
    busy = _union((e['ts'], e['ts'] + e['dur']) for e in device)
    gaps = sorted(((b[0] - a[1], a[1], b[0])
                   for a, b in zip(busy, busy[1:])), reverse=True)
    span = busy[-1][1] - busy[0][0] if busy else 0.0
    busy_us = sum(b - a for a, b in busy)
    start = busy[0][0] if busy else 0.0
    rep['device'] = {
        'events': len(device), 'total_ms': sum(per.values()) / 1e3,
        'busy_ms': busy_us / 1e3, 'span_ms': span / 1e3,
        'idle_share': 1 - busy_us / span if span else None,
        'kernels': [[k, v / 1e3, count[k]] for k, v in per.most_common(top)],
        'groups': {g: {'ms': ms, 'launches': n} for g, (ms, n) in sorted(
            groups.items(), key=lambda kv: -kv[1][0])},
        'gaps': [{'at_ms': (a - start) / 1e3, 'ms': d / 1e3,
                  'host_op': _innermost(host_ops, (a + b) / 2),
                  'range': _innermost(ranges, (a + b) / 2)}
                 for d, a, b in gaps[:GAPS_SHOWN]]}
    host = collections.Counter()
    host_n = collections.Counter()
    for e in ops:
        host[e['name']] += e['dur']
        host_n[e['name']] += 1
    rep['host'] = {'events': len(ops) + len(ranges),
                   'ops': [[k, v / 1e3, host_n[k]]
                           for k, v in host.most_common(top)],
                   'ranges': sorted({e['name'] for e in ranges})}
    return rep


def _print(rep, group):
    dev = rep['device']
    print(f'== {rep["trace"]}')
    if not dev['events']:
        print('   no device events (a trace taken on the CPU); host ops by '
              'inclusive time:')
        for name, ms, n in rep['host']['ops']:
            print(f'   {ms:10.3f} ms  x{n:<5d} {name[:110]}')
        return
    print(f'   device time {dev["total_ms"]:.3f} ms, busy {dev["busy_ms"]:.3f}'
          f' ms of a {dev["span_ms"]:.3f} ms span (idle '
          f'{100 * dev["idle_share"]:.1f}%)')
    total = dev['total_ms'] or 1.0
    if group:
        for g, v in dev['groups'].items():
            print(f'   {v["ms"]:10.3f} ms  {v["ms"] / total * 100:5.1f}%  '
                  f'x{v["launches"]:<5d} {g}')
    for name, ms, n in dev['kernels']:
        print(f'   {ms:10.3f} ms  {ms / total * 100:5.1f}%  x{n:<5d} '
              f'{name[:110]}')
    print('   longest idle gaps (host op / range running):')
    for gap in dev['gaps'][:3]:
        print(f'   {gap["ms"]:10.3f} ms at {gap["at_ms"]:.3f} ms: '
              f'{gap["host_op"]} / {gap["range"]}')


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog='python -m bsvd_tpu_torch.tools.parse_trace',
        description=__doc__.split('\n\n')[0])
    ap.add_argument('trace_dir', help='a trace directory or .json file')
    ap.add_argument('--top', type=int, default=40)
    ap.add_argument('--group', action='store_true',
                    help='aggregate kernels into the port\'s groups')
    ap.add_argument('--json', action='store_true',
                    help='print one JSON line')
    args = ap.parse_args(argv)
    try:
        rep = summarize(find_trace(args.trace_dir), args.top)
    except FileNotFoundError as e:
        sys.exit(str(e))
    if args.json:
        print(json.dumps(rep))
    else:
        _print(rep, args.group)
    return rep


if __name__ == '__main__':
    main()
