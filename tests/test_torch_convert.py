"""Weights into the port: from_jax_params and .pth TSN state dicts against
bsvd_tpu.convert.params_to_tsn_state_dict (exact: conversions only move
and transpose values)."""

import numpy as np
import pytest
import torch

from bsvd_tpu_torch.archs import build_network
from bsvd_tpu_torch.archs.wnet_arch import WNetConfig
from bsvd_tpu_torch.convert.torch_ckpt import (from_jax_params,
                                               load_tsn_state_dict,
                                               to_tsn_state_dict, tsn_key_map)

jax = pytest.importorskip('jax')

_KW = dict(chns=(16, 32, 64), mid_ch=16, interm_ch=16, norm='none',
           act='relu6')


def _jax_state(seed, **over):
    from bsvd_tpu.archs.wnet_arch import WNetConfig as JaxConfig, wnet_init
    from bsvd_tpu.convert.torch_ckpt import params_to_tsn_state_dict
    jcfg = JaxConfig(**_KW, **over)
    jparams = wnet_init(jax.random.PRNGKey(seed), jcfg)
    return jparams, params_to_tsn_state_dict(jparams, jcfg)


def _assert_state_equal(got, ref):
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]),
                                      err_msg=k)


@pytest.mark.parametrize('over', [{}, dict(shift_mode='none'),
                                  dict(stage_num=1), dict(blind=True)])
def test_from_jax_params_matches_jax_state_dict(over):
    jparams, ref = _jax_state(30, **over)
    cfg = WNetConfig(**_KW, **over)
    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg)
    _assert_state_equal(to_tsn_state_dict(params, cfg), ref)


@pytest.mark.parametrize('prefix', ['base_model.nets_list.',
                                    'module.base_model.nets_list.'])
def test_pth_file_loads(tmp_path, prefix):
    """A torch-saved {'params': sd} checkpoint (module./DDP prefix too)
    loads into the port's tree and module."""
    _, ref = _jax_state(31)
    cfg = WNetConfig(**_KW)
    sd = {prefix + k[len('base_model.nets_list.'):]:
          torch.from_numpy(np.asarray(v).copy()) for k, v in ref.items()}
    path = tmp_path / 'net_g.pth'
    torch.save({'params': sd, 'params_ema': sd}, path)
    _assert_state_equal(to_tsn_state_dict(load_tsn_state_dict(path, cfg), cfg),
                        ref)
    net = build_network(dict(_KW, type='BSVD', pretrain_ckpt=str(path)),
                        device='cpu')
    _assert_state_equal(to_tsn_state_dict(net.param_tree(), cfg), ref)


def test_missing_key_raises():
    _, ref = _jax_state(32)
    ref.pop('base_model.nets_list.1.outc.convblock.3.weight')
    with pytest.raises(KeyError):
        load_tsn_state_dict(ref, WNetConfig(**_KW))


def test_key_map_matches_jax():
    from bsvd_tpu.archs.wnet_arch import WNetConfig as JaxConfig
    from bsvd_tpu.convert.torch_ckpt import tsn_key_map as jax_key_map
    for over in ({}, dict(shift_mode='none'), dict(stage_num=3)):
        assert list(tsn_key_map(WNetConfig(**_KW, **over))) == list(
            jax_key_map(JaxConfig(**_KW, **over)))


def test_module_prepared_cache_follows_loads():
    """Packed/cast weights are cached per (device, dtype) and rebuilt when
    the parameters change."""
    net = build_network(dict(_KW, type='BSVD', seed=1), device='cpu')
    a = net.prepared('cpu', torch.float32)
    assert net.prepared('cpu', torch.float32) is a
    _, ref = _jax_state(33)
    net.load_params(load_tsn_state_dict(ref, net.cfg))
    b = net.prepared('cpu', torch.float32)
    assert b is not a
    np.testing.assert_array_equal(
        b['stage0']['inc']['c1'].w.numpy(),
        ref['base_model.nets_list.0.inc.convblock.0.weight'])
