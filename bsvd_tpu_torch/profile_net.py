"""The reference's profile protocol on the port (counterpart of the
repository root's profile.py): build the test config's network, half
precision, time a (1, T, C, H, W) forward best of N, and report the
latency, parameters, FLOPs and device memory; ``--trace`` also writes a
torch.profiler trace of one forward (read it with
``python -m bsvd_tpu_torch.tools.parse_trace <trace_dir>``).

    python -m bsvd_tpu_torch.profile_net [-opt options/test/bsvd_c64.yml]
        [--height 540] [--width 960] [--frames 10] [--trace]
        [--trace_dir DIR] [--device cuda|cpu]

Runs on the card unless ``--device cpu`` is given (the plain PyTorch
versions of the kernels). Half precision is bf16 (the reference's
``net_g.half()``). It prints the root profile.py's lines in its order,
then one JSON object of the same numbers as the last line, with the
kernel launches of the flops run (``launches_per_forward``) and of the
whole command (``launches``).
"""

import argparse
import json
import os.path as osp

import numpy as np
import torch

from bsvd_tpu_torch.archs import build_network
from bsvd_tpu_torch.archs.wnet_arch import wnet_apply
from bsvd_tpu_torch.ops import conv3x3, conv_chain, conv_s2
from bsvd_tpu_torch.profiler import (Timeit, count_params,
                                     device_memory_stats, flops_and_memory)
from bsvd_tpu_torch.utils.options import yaml_load

# the kernels of a whole-clip forward, by their launch counters
FORWARD_KERNELS = {'conv3x3': conv3x3.conv3x3,
                   'conv_chain': conv_chain.conv_chain,
                   'conv_s2': conv_s2.conv_s2, 'conv_ps': conv3x3.conv_ps}
NO_FUSED = ('--no-fused: the port never times a library route in place of '
            'its kernels. The plain PyTorch versions run on CPU tensors '
            '(tests/test_torch_ops.py, tests/test_torch_wnet.py; here: '
            '--device cpu) and are held against the kernels on the card by '
            'tests/test_torch_cuda.py and chip_smoke.py phase 2.')


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog='python -m bsvd_tpu_torch.profile_net',
        description=__doc__.split('\n\n')[0])
    ap.add_argument('-opt', default='options/test/bsvd_c64.yml')
    ap.add_argument('--height', type=int, default=540)
    ap.add_argument('--width', type=int, default=960)
    ap.add_argument('--frames', type=int, default=10)
    ap.add_argument('--trace', action='store_true',
                    help='also write a torch.profiler trace')
    ap.add_argument('--trace_dir', default=None,
                    help='where --trace writes (Timeit\'s default: '
                         '<tmp>/bsvd_tpu_torch_trace)')
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default) or 'cpu' (the plain path)")
    ap.add_argument('--no-fused', action='store_true',
                    help='refused (the JAX entry\'s XLA-conv route)')
    args = ap.parse_args(argv)
    if args.no_fused:
        ap.error(NO_FUSED)
    return args


def _launches():
    return {k: fn.launches for k, fn in FORWARD_KERNELS.items()}


def main(argv=None):
    args = parse_args(argv)
    start = _launches()
    device = torch.device(args.device)
    opt = yaml_load(args.opt)
    net_opt = dict(opt['network_g'])
    ckpt = net_opt.get('pretrain_ckpt')
    if ckpt and not osp.isfile(ckpt):
        net_opt['pretrain_ckpt'] = None
    net = build_network(net_opt, device=device)
    cfg = net.cfg
    dtype = torch.bfloat16                       # reference: net_g.half()
    params = net.prepared(device, dtype)

    n, t, h, w = 1, args.frames, args.height, args.width
    cin = cfg.effective_in_ch
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 1, (n, t, h, w, cin))).to(device=device, dtype=dtype)

    def fwd():
        with torch.no_grad():
            return wnet_apply(params, x, cfg)

    _, sec = Timeit('time', number=5, repeat=3)(fwd)()
    print(f'input shape: {(n, t, cin, h, w)} (reference layout NFCHW)')
    print(f'time per {t}-frame forward: {sec:.6f} s '
          f'({t / sec:.1f} frames/s, {sec / t * 1e3:.2f} ms/frame)')
    n_params = count_params(net)
    print(f'params: {n_params:,d}')
    before = _launches()
    with torch.no_grad():
        fm = flops_and_memory(lambda p, x: wnet_apply(p, x, cfg), params, x)
    launches = {k: v - before[k] for k, v in _launches().items()}
    for k, v in fm.items():
        if isinstance(v, float) and v > 1e9:
            print(f'{k}: {v:.3e}')
        else:
            print(f'{k}: {v}')
    peaks = {}
    for d, s in device_memory_stats().items():
        if s and 'peak_bytes_in_use' in s:
            peaks[d] = s['peak_bytes_in_use']
            print(f'{d} peak memory: {s["peak_bytes_in_use"] / 2**30:.2f} GB')
    rec = {'input_shape': [n, t, cin, h, w], 'device': str(device),
           'kind': (torch.cuda.get_device_name(device)
                    if device.type == 'cuda' else 'cpu'),
           'dtype': 'bfloat16', 'sec_per_forward': sec,
           'frames_per_s': t / sec, 'ms_per_frame': sec / t * 1e3,
           'params': n_params, **fm, 'peak_bytes_in_use': peaks,
           'launches_per_forward': launches}
    if args.trace:
        timeit = Timeit('trace', trace_dir=args.trace_dir)
        _, dt = timeit(fwd)()
        print(f'traced forward: {dt:.4f} s')
        rec['traced_forward_s'] = dt
        rec['trace_dir'] = timeit.trace_dir
    rec['launches'] = {k: v - start[k] for k, v in _launches().items()}
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == '__main__':
    main()
