"""The port's WNet (bsvd_tpu_torch.archs.wnet_arch) on CPU against the JAX
package's wnet_apply and against the reference torch net's pinned outputs
(tests/fixtures/tsn_forward_*.npz, see test_arch_parity.py).

Same weights on both sides: a JAX ``wnet_init`` tree goes through
``from_jax_params`` (or its TSN state dict through ``load_tsn_state_dict``).
fp32 throughout; tolerance 1e-4 absolute and relative (summation order).
"""

import numpy as np
import pytest
import torch

from bsvd_tpu_torch.archs import build_network
from bsvd_tpu_torch.archs.wnet_arch import BSVD, TSN, WNetConfig, wnet_apply
from bsvd_tpu_torch.convert.torch_ckpt import (from_jax_params,
                                               load_tsn_state_dict)

from golden_util import golden
from reference_util import SMALL_NET2D_OPT
from torch_threads import one_torch_thread  # noqa: F401

jax = pytest.importorskip('jax')
jnp = pytest.importorskip('jax.numpy')

TOL = dict(rtol=1e-4, atol=1e-4)


def _configs(opt, **over):
    from bsvd_tpu.archs.wnet_arch import WNetConfig as JaxConfig
    kw = dict(chns=tuple(opt['chns']), mid_ch=opt['mid_ch'],
              interm_ch=opt['interm_ch'], norm=opt['norm'], act=opt['act'],
              stage_num=opt.get('stage_num', 2), blind=opt.get('blind', False))
    kw.update(over)
    return JaxConfig(**kw), WNetConfig(**kw)


def _jax_vs_port(jcfg, pcfg, n, t, h, w, seed):
    from bsvd_tpu.archs.wnet_arch import wnet_apply as jax_apply, wnet_init
    jparams = wnet_init(jax.random.PRNGKey(seed), jcfg)
    params = from_jax_params(jax.tree.map(np.asarray, jparams), pcfg)
    cin = 3 if pcfg.blind else pcfg.in_ch
    x = np.random.default_rng(seed).uniform(
        0, 1, (n, t, h, w, cin)).astype(np.float32)
    ref = np.asarray(jax_apply(jparams, jnp.asarray(x), jcfg))
    got = wnet_apply(params, torch.from_numpy(x), pcfg).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize('variant', ['bidir', 'causal', 'blind', 'stage1',
                                     'no_shift', 'relu'])
def test_wnet_apply_matches_jax_small(variant):
    opt = dict(SMALL_NET2D_OPT)
    over = {'causal': dict(shift_mode='TSM_toFutureOnly'),
            'blind': dict(blind=True), 'stage1': dict(stage_num=1),
            'no_shift': dict(shift_mode='none'),
            'relu': dict(act='relu')}.get(variant, {})
    jcfg, pcfg = _configs(opt, **over)
    _jax_vs_port(jcfg, pcfg, 2, 5, 16, 16, seed=3)


@pytest.mark.parametrize('shift_mode', ['TSM', 'TSM_toFutureOnly'])
def test_wnet_apply_matches_jax_c64_widths(shift_mode):
    """BSVD-c64 at its full widths (chns 64/128/256, mid/interm 64) on a
    tiny clip."""
    opt = dict(chns=[64, 128, 256], mid_ch=64, interm_ch=64, norm='none',
               act='relu6')
    jcfg, pcfg = _configs(opt, shift_mode=shift_mode)
    _jax_vs_port(jcfg, pcfg, 1, 3, 16, 24, seed=4)


@pytest.mark.parametrize('variant', ['bidir', 'causal', 'blind', 'stage1',
                                     'shift_input'])
def test_tsn_forward_fixture(variant):
    """The reference torch TSN's pinned output for the state dict of
    wnet_init(PRNGKey(10)) (test_arch_parity.test_tsn_forward_parity)."""
    from bsvd_tpu.archs.wnet_arch import wnet_init
    from bsvd_tpu.convert.torch_ckpt import params_to_tsn_state_dict
    opt = dict(SMALL_NET2D_OPT)
    over = {'causal': dict(shift_mode='TSM_toFutureOnly'),
            'blind': dict(blind=True), 'stage1': dict(stage_num=1),
            'shift_input': dict(shift_input=True)}
    jcfg, pcfg = _configs(opt, **over.get(variant, {}))
    state = params_to_tsn_state_dict(wnet_init(jax.random.PRNGKey(10), jcfg),
                                     jcfg)
    cin = 3 if pcfg.blind else 4
    x = np.random.default_rng(3).standard_normal(
        (2, 5, cin, 16, 16)).astype(np.float32)
    ref = golden(f'tsn_forward_{variant}', lambda: pytest.skip(
        'fixture missing'))['ref_out']
    params = load_tsn_state_dict(state, pcfg)
    got = wnet_apply(params, torch.from_numpy(x).permute(0, 1, 3, 4, 2),
                     pcfg).permute(0, 1, 4, 2, 3).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


def test_bsvd_module_forward_and_registry():
    """build_network -> BSVD module; (N, F, C, H, W) IO with a noise map
    equals wnet_apply on the channels-last input."""
    opt = dict(SMALL_NET2D_OPT, type='BSVD', seed=5)
    net = build_network(opt, device='cpu')
    assert isinstance(net, BSVD)
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.uniform(0, 1, (1, 4, 3, 16, 16))
                         .astype(np.float32))
    nm = torch.full((1, 4, 1, 16, 16), 0.1)
    y = net(x, nm)
    ref = wnet_apply(net.param_tree(),
                     torch.cat([x, nm], 2).permute(0, 1, 3, 4, 2), net.cfg)
    np.testing.assert_allclose(y.numpy(),
                               ref.permute(0, 1, 4, 2, 3).numpy(), **TOL)
    assert build_network(dict(opt, type='BufferConv'),
                         device='cpu').cfg == net.cfg


def test_tsn_module_options():
    net = build_network({'type': 'TSN', 'num_segments': 5,
                         'shift_type': 'TSM_toFutureOnly',
                         'net2d_opt': dict(SMALL_NET2D_OPT)}, device='cpu')
    assert isinstance(net, TSN)
    assert net.cfg.shift_mode == 'TSM_toFutureOnly'
    assert net.cfg.chns == (16, 32, 64) and net.shift_num == 16


def test_build_network_defaults_to_the_card(monkeypatch):
    """The inference entry builds on 'cuda' unless asked for the CPU, and
    raises without a card instead of returning a CPU module."""
    import inspect
    assert inspect.signature(build_network).parameters['device'].default \
        == 'cuda'
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        build_network(dict(SMALL_NET2D_OPT, type='BSVD'))
    net = build_network(dict(SMALL_NET2D_OPT, type='BSVD'), device='cpu')
    assert next(net.parameters()).device.type == 'cpu'


def test_seeded_init_is_deterministic():
    a = build_network(dict(SMALL_NET2D_OPT, type='BSVD', seed=7), 'cpu')
    b = build_network(dict(SMALL_NET2D_OPT, type='BSVD', seed=7), 'cpu')
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
