"""The port's profiler (``bsvd_tpu_torch.profiler``), its profile entry
(``python -m bsvd_tpu_torch.profile_net``) and its trace parser
(``bsvd_tpu_torch.tools.parse_trace``) on CPU: the counterparts of
tests/test_profiler.py, the FLOPs of a WNet against the JAX package's
XLA cost analysis, each op wrapper's count against the valid-tap formula
on both routes, and the parser on a trace written here and on a
hand-written card trace.

Tolerances: the port's FLOPs are exact integers (the valid-tap count);
JAX's count adds XLA's elementwise work, so it must lie in [port, 1.01 x
port]. Parameter and byte counts are exact.
"""

import json
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from bsvd_tpu.archs import build_network as jax_build_network
from bsvd_tpu.archs import wnet_arch as jax_wnet
from bsvd_tpu.profiler import count_params as jax_count_params
from bsvd_tpu.profiler import flops_and_memory as jax_flops_and_memory
from bsvd_tpu_torch import profile_net, profiler
from bsvd_tpu_torch.archs.wnet_arch import WNetConfig, wnet_apply
from bsvd_tpu_torch.convert.torch_ckpt import from_jax_params
from bsvd_tpu_torch.ops.bibuffer_conv import (bibuffer_chain, bibuffer_conv,
                                              bibuffer_multi)
from bsvd_tpu_torch.ops.conv3x3 import (conv3x3, conv3x3_dw,
                                        conv3x3_reference, conv_ps)
from bsvd_tpu_torch.ops.conv_chain import conv_chain_add2_res
from bsvd_tpu_torch.ops.conv_s2 import conv_s2
from bsvd_tpu_torch.tools import parse_trace
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C64_YML = os.path.join(ROOT, 'options', 'test', 'bsvd_c64.yml')
# the probe net: its valid-tap count, which JAX's count must bracket
PROBE_FLOPS = 623_488_960


def test_timeit_time_mode_returns_positive_seconds():
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(64, 64))
                         .astype(np.float32))
    out, secs = profiler.Timeit('time', number=2, repeat=2)(
        lambda v: torch.tanh(v) @ v.T)(x)
    assert out.shape == (64, 64)
    assert 0 < secs < 60


def test_timeit_trace_mode_writes_trace(tmp_path, capsys):
    """JAX's plugins/profile/<timestamp>/ layout, the ranges of annotate and
    step_annotation in it, and parse_trace reading it (a CPU trace: host
    ops only)."""
    def f(v):
        with profiler.step_annotation(3), profiler.annotate('sin_range'):
            return torch.sin(v) * 2
    x = torch.ones((32, 32))
    out, dt = profiler.Timeit('trace', trace_dir=str(tmp_path))(f)(x)
    assert np.allclose(out.numpy(), np.sin(1.0) * 2) and dt > 0
    found = list(tmp_path.glob('plugins/profile/*/*.pt.trace.json'))
    assert len(found) == 1 and str(found[0]) in capsys.readouterr().out
    rep = parse_trace.main([str(tmp_path), '--json'])
    assert rep['trace'] == str(found[0])
    assert rep['device']['events'] == 0 and rep['device']['kernels'] == []
    assert {'train#3', 'sin_range'} <= set(rep['host']['ranges'])
    assert 'aten::sin' in [name for name, _, _ in rep['host']['ops']]
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line)['host']['ranges'] == rep['host']['ranges']


def test_flops_and_memory_reports_matmul_flops():
    a, b = torch.ones((128, 256)), torch.ones((256, 64))
    for fn in (lambda a, b: a @ b, torch.matmul,
               lambda a, b: F.linear(a, b.T)):
        rep = profiler.flops_and_memory(fn, a, b)
        assert rep['flops'] == 2 * 128 * 256 * 64
        assert rep['output_size_in_bytes'] == 128 * 64 * 4
        assert rep['argument_size_in_bytes'] == (128 + 64) * 256 * 4
    # a conv counts its taps inside the unpadded input, as XLA does:
    # 2 * 16 * 32 * 94^2, not the padded 2 * 16 * 32 * 9 * 32^2
    rep = profiler.flops_and_memory(
        lambda x, w: F.conv2d(x, w, padding=1), torch.ones((1, 16, 32, 32)),
        torch.ones((32, 16, 3, 3)))
    assert rep['flops'] == 9_048_064
    assert 'temp_size_in_bytes' not in rep       # no card


def test_count_params_and_memory_stats():
    tree = {'a': torch.ones((3, 4)), 'b': {'c': torch.ones((5,))}}
    assert profiler.count_params(tree) == 17
    mod = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.BatchNorm1d(4))
    # parameters and buffers (BN's running statistics are leaves in JAX)
    assert profiler.count_params(mod) == 16 + 8 + 8 + 1
    assert profiler.device_memory_stats() == {'cpu': None}


def _probe():
    jcfg = jax_wnet.WNetConfig(chns=(16, 32, 64), interm_ch=8, norm='none',
                               act='relu')
    cfg = WNetConfig(chns=(16, 32, 64), interm_ch=8, norm='none', act='relu')
    jp = jax_wnet.wnet_init(jax.random.PRNGKey(0), jcfg)
    x = np.random.default_rng(0).random((1, 5, 32, 32, 4)).astype(np.float32)
    return jcfg, cfg, jp, from_jax_params(jax.tree.map(np.asarray, jp), cfg), x


def test_wnet_flops_and_params_against_jax():
    jcfg, cfg, jp, p, x = _probe()
    rep = profiler.flops_and_memory(lambda p, x: wnet_apply(p, x, cfg), p,
                                    torch.from_numpy(x))
    jrep = jax_flops_and_memory(lambda p, x: jax_wnet.wnet_apply(p, x, jcfg),
                                jp, jnp.asarray(x))
    assert rep['flops'] == PROBE_FLOPS
    assert rep['flops'] <= jrep['flops'] <= 1.01 * rep['flops']
    for key in ('argument_size_in_bytes', 'output_size_in_bytes'):
        assert rep[key] == jrep[key]
    assert profiler.count_params(p) == jax_count_params(jp)
    # the autograd route counts each forward conv once, and the backward's
    # dx / dw convs as well
    leaves = [t.requires_grad_() for t in profiler._tensors(p)]
    with torch.enable_grad():
        rep_grad = profiler.flops_and_memory(
            lambda p, x: wnet_apply(p, x, cfg).sum().backward(), p,
            torch.from_numpy(x))
    assert all(t.grad is not None for t in leaves)
    assert rep_grad['flops'] > 2 * PROBE_FLOPS


def _taps(n, s):
    return sum(1 for o in range((n - 1) // s + 1) for k in range(3)
               if 0 <= s * o + k - 1 < n)


def _conv(n, h, w, ci, co, s=1):
    """The valid-tap count of one 3x3 conv, counted tap by tap."""
    return 2 * n * ci * co * _taps(h, s) * _taps(w, s)


def _t(*shape):
    return torch.from_numpy(np.random.default_rng(sum(shape)).random(
        shape).astype(np.float32))


# op -> (call, its FLOPs by the formula)
OPS = {
    'K1 conv3x3 tsm add2': (
        lambda: conv3x3(_t(6, 7, 9, 16), _t(24, 16, 3, 3), _t(24),
                        x2=_t(6, 7, 9, 16), t_len=3, shift='tsm'),
        _conv(6, 7, 9, 16, 24)),
    'K2 conv_chain add2 res': (
        lambda: conv_chain_add2_res(_t(2, 8, 5, 8), _t(2, 8, 5, 8),
                                    _t(2, 8, 5, 4), _t(16, 8, 3, 3), _t(16),
                                    _t(3, 16, 3, 3), _t(3)),
        _conv(2, 8, 5, 8, 16) + _conv(2, 8, 5, 16, 3)),
    'K3 conv_s2 odd': (
        lambda: conv_s2(_t(3, 9, 11, 8), _t(16, 8, 3, 3), _t(16)),
        _conv(3, 9, 11, 8, 16, 2)),
    'K4 conv_ps': (
        lambda: conv_ps(_t(2, 5, 6, 8), _t(16, 8, 3, 3), _t(16)),
        _conv(2, 5, 6, 8, 16)),
    'K5 bibuffer_conv': (
        lambda: bibuffer_conv(_t(2, 6, 7, 16), _t(2, 6, 7, 16),
                              _t(16, 16, 3, 3), _t(16)),
        _conv(2, 6, 7, 16, 16)),
    'K5 bibuffer_multi': (
        lambda: bibuffer_multi(_t(3, 6, 7, 16), _t(1, 6, 7, 16),
                               _t(16, 16, 3, 3), _t(16)),
        _conv(3, 6, 7, 16, 16)),
    'K6 bibuffer_chain': (
        lambda: bibuffer_chain(_t(1, 6, 7, 16), _t(1, 6, 7, 16),
                               _t(1, 6, 7, 8), _t(8, 16, 3, 3), _t(8),
                               _t(8, 8, 3, 3), _t(8)),
        _conv(1, 6, 7, 16, 8) + _conv(1, 6, 7, 8, 8)),
    'K7 conv3x3_dw': (
        lambda: conv3x3_dw(_t(6, 7, 9, 16), _t(6, 7, 9, 24), t_len=3,
                           shift='causal'),
        _conv(6, 7, 9, 16, 24)),
}


@pytest.mark.parametrize('op', sorted(OPS))
def test_op_wrapper_flops_equal_the_formula(op):
    """Each wrapper counts its convs once on the plain route (CPU tensors):
    the plain version's own F.conv2d is not counted again."""
    call, want = OPS[op]
    assert profiler.flops_and_memory(call)['flops'] == want


def test_plain_version_alone_counts_the_same():
    """The TorchFunctionMode counts a plain version called outside the
    wrappers by the same rule as the wrapper; under grad the wrapper's
    autograd route counts the forward once."""
    x, w, b = _t(6, 7, 9, 16), _t(24, 16, 3, 3), _t(24)
    want = _conv(6, 7, 9, 16, 24)
    kw = dict(t_len=3, shift='tsm')
    assert profiler.flops_and_memory(
        lambda: conv3x3_reference(x, w, b, **kw))['flops'] == want
    x.requires_grad_()
    with torch.enable_grad():
        assert profiler.flops_and_memory(
            lambda: conv3x3(x, w, b, **kw))['flops'] == want


def test_profile_net_prints_the_reference_lines_on_cpu(capsys):
    rec = profile_net.main(['-opt', C64_YML, '--device', 'cpu', '--height',
                            '32', '--width', '32', '--frames', '3'])
    lines = capsys.readouterr().out.strip().splitlines()
    heads = ['input shape: (1, 3, 4, 32, 32)', 'time per 3-frame forward:',
             'params:', 'flops:', 'argument_size_in_bytes:',
             'output_size_in_bytes:']
    at = [next(i for i, ln in enumerate(lines) if ln.startswith(h))
          for h in heads]
    assert at == sorted(at)
    assert json.loads(lines[-1]) == json.loads(json.dumps(rec))
    net_opt = dict(profile_net.yaml_load(C64_YML)['network_g'],
                   pretrain_ckpt=None)
    assert rec['params'] == jax_count_params(
        jax_build_network(net_opt).params)
    assert f"params: {rec['params']:,d}" in lines
    assert rec['device'] == 'cpu' and rec['kind'] == 'cpu'
    assert set(rec['launches'].values()) == {0}       # no kernel on the CPU


def test_profile_net_refuses_no_fused(capsys):
    with pytest.raises(SystemExit) as err:
        profile_net.main(['--no-fused', '--device', 'cpu'])
    assert err.value.code == 2
    assert 'tests/test_torch_cuda.py' in capsys.readouterr().err


def _ev(cat, name, ts, dur, **kw):
    return dict(ph='X', cat=cat, name=name, ts=ts, dur=dur, pid=0, tid=0,
                **kw)


def test_parse_trace_reads_a_card_trace(tmp_path, capsys):
    """Device kernels named as the card names them: the groups, the idle
    gaps with the host op and range then running, the --json line."""
    k1 = 'void bsvd::conv3x3_bf16_kernel<bsvd::PipeCfg<1, 16, 128, 1, 4> >' \
         '(bsvd::ConvArgs)'
    events = [
        _ev('user_annotation', 'forward', 0, 1000),
        _ev('cpu_op', 'aten::copy_', 10, 90),
        _ev('cpu_op', 'aten::empty', 150, 20),
        _ev('kernel', k1, 100, 200),
        _ev('kernel', k1, 300, 100),
        _ev('gpu_memcpy', 'Memcpy HtoD (Pageable -> Device)', 420, 30),
        _ev('kernel', 'void bsvd::conv_chain_bf16_kernel<bsvd::ChainCfg<1, '
                      '64, 8, 2>, false>(bsvd::ChainArgs)', 600, 100),
        _ev('gpu_user_annotation', 'forward', 100, 800),
        _ev('kernel', 'void at::native::vectorized_elementwise_kernel<4>()',
            700, 50),
        _ev('kernel', 'void bsvd::conv3x3_dw_wgmma_kernel(bsvd::DwArgs)',
            750, 50),
        _ev('user_annotation', 'stage1', 460, 200),
        _ev('cpu_op', 'aten::conv2d', 470, 100),
        _ev('kernel', 'sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32',
            850, 50),
    ]
    run = tmp_path / 'plugins' / 'profile' / '2026_01_01_00_00_00'
    run.mkdir(parents=True)
    (run / 'host.pt.trace.json').write_text(json.dumps(
        {'traceEvents': events + [{'ph': 'M', 'name': 'process_name'}]}))
    rep = parse_trace.main([str(tmp_path), '--group', '--json'])
    dev = rep['device']
    assert dev['events'] == 7
    # busy 100-400, 420-450, 600-800, 850-900
    assert dev['busy_ms'] == pytest.approx(0.58)
    assert dev['span_ms'] == pytest.approx(0.8)
    assert dev['idle_share'] == pytest.approx(1 - 0.58 / 0.8)
    assert {g: v['launches'] for g, v in dev['groups'].items()} == {
        'K1 conv3x3': 2, 'K2 conv_chain': 1, 'K7 conv3x3_dw': 1,
        'copies and sets': 1, 'torch elementwise': 1,
        'library convolution': 1}
    assert dev['groups']['K1 conv3x3']['ms'] == pytest.approx(0.3)
    assert dev['kernels'][0] == [k1, pytest.approx(0.3), 2]
    # the longest gap, 450-600, while aten::conv2d ran inside stage1; the
    # others while no host op ran
    assert dev['gaps'] == [
        {'at_ms': pytest.approx(0.35), 'ms': pytest.approx(0.15),
         'host_op': 'aten::conv2d', 'range': 'stage1'},
        {'at_ms': pytest.approx(0.7), 'ms': pytest.approx(0.05),
         'host_op': None, 'range': 'forward'},
        {'at_ms': pytest.approx(0.3), 'ms': pytest.approx(0.02),
         'host_op': None, 'range': 'forward'}]
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and json.loads(out[0])['device']['gaps'][0][
        'host_op'] == 'aten::conv2d'
    parse_trace.main([str(run / 'host.pt.trace.json'), '--group'])
    text = capsys.readouterr().out
    assert 'library convolution' in text and 'aten::conv2d / stage1' in text
    with pytest.raises(SystemExit, match='no \\*.pt.trace.json'):
        parse_trace.main([str(tmp_path / 'plugins' / 'none')])


def test_parse_trace_groups():
    names = {
        'void bsvd::conv3x3_fma_kernel<bsvd::FmaCfg>(bsvd::ConvArgs)':
            'K1 conv3x3',
        'void bsvd::conv3x3_dw_reduce(float const*, float*, int)':
            'K7 conv3x3_dw',
        'void bsvd::conv_s2_bf16_kernel<bsvd::S2Cfg>(bsvd::ConvArgs)':
            'K3 conv_s2',
        'void bsvd::conv_ps_bf16_kernel<bsvd::PipeCfg<1,16,128,1,4> >()':
            'K4 conv_ps',
        'void bsvd::bibuf_bf16_kernel<bsvd::PipeCfg<1,8,128,1,2> >()':
            'K5 bibuf',
        'void bsvd::bibuf_chain_bf16_kernel<bsvd::BiChainCfg<6,2>,2>()':
            'K6 bibuf_chain',
        'void bsvd::conv_chain_kernel(bsvd::ChainArgs)': 'K2 conv_chain',
        'cudnn::engines_precompiled::nchwToNhwcKernel': 'library convolution',
        'cutlass3x_sm90_tensorop_s64x64x16gemm': 'library convolution',
        'void at::native::reduce_kernel<512, 1>()': 'torch elementwise',
        'void at::native::elementwise_kernel<128, 2>()': 'torch elementwise',
        'void at::native::copy_kernel()': 'copies and sets',
        'some_other_kernel': 'other',
    }
    for name, group in names.items():
        assert parse_trace.group_name(name) == group, name
    assert parse_trace.group_name('x', 'gpu_memset') == 'copies and sets'
