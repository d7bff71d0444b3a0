"""K2's width gate (``ops.conv_chain.fits``) and the route it picks in
the arch: a chain whose intermediate is too wide for K2's shared memory
runs as two K1 launches (then ``_residual`` at outc), on the CPU as on the
card, and equals the JAX package's WNet there, which sends such a chain
to its XLA composite (``bsvd_tpu/ops/conv_chain.py`` conv_chain_supported).

Tolerance: 1e-4 absolute and relative, fp32 (summation order), as
test_torch_wnet.
"""

import glob
import os

import numpy as np
import pytest
import torch

from bsvd_tpu_torch.archs import wnet_arch
from bsvd_tpu_torch.archs.wnet_arch import WNetConfig, wnet_apply, wnet_init
from bsvd_tpu_torch.convert.torch_ckpt import to_jax_params
from bsvd_tpu_torch.ops import conv_chain
from bsvd_tpu_torch.utils.options import yaml_load
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16, FP32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize('dtype,x2,widest', [
    (BF16, False, 256), (BF16, True, 192), (FP32, False, 192),
    (FP32, True, 192)])
def test_fits_states_k2_shared_memory(dtype, x2, widest):
    """The widest intermediate K2 launches, by csrc/conv_chain.cu's shared
    memory (a ring of conv1 slices and the intermediate at 64-channel
    steps, 232,448 bytes a block at most): the 64-wide chains' 104 KB and
    181 KB of the source's notes, and one 64-channel step past each limit
    refused."""
    assert conv_chain.fits(widest, dtype, x2)
    assert conv_chain.fits(widest - 63, dtype, x2)
    assert not conv_chain.fits(widest + 1, dtype, x2)
    assert not conv_chain.fits(widest + 64, dtype, x2)
    assert conv_chain.smem_bytes(widest, dtype, x2) <= conv_chain.SMEM_MAX \
        < conv_chain.smem_bytes(widest + 64, dtype, x2)
    assert conv_chain.smem_bytes(64, BF16, False) == 103936
    assert conv_chain.smem_bytes(64, BF16, True) == 180736


def _shipped_wnets():
    for path in sorted(glob.glob(os.path.join(ROOT, 'options', '*',
                                              '*.yml'))):
        net = yaml_load(path).get('network_g') or {}
        net = net.get('net2d_opt', net)
        if 'interm_ch' in net:
            yield os.path.relpath(path, ROOT), net


def test_every_shipped_config_stays_on_k2():
    """Every shipped WNet's inc (interm_ch) and outc (chns[0], with x2)
    chains fit K2 in bf16 and fp32: no shipped config changes route."""
    nets = list(_shipped_wnets())
    assert len(nets) == 8
    for name, net in nets:
        for dtype in (BF16, FP32):
            assert net.get('shift_input') or conv_chain.fits(
                net['interm_ch'], dtype, False), name
            assert conv_chain.fits(net['chns'][0], dtype, True), name


def _spy(monkeypatch):
    """Counts of the arch's K2 and K1 entry calls."""
    calls = {'chain': 0, 'k1': 0}

    def count(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped
    monkeypatch.setattr(wnet_arch, 'conv_chain',
                        count('chain', wnet_arch.conv_chain))
    monkeypatch.setattr(wnet_arch, 'conv_chain_add2_res',
                        count('chain', wnet_arch.conv_chain_add2_res))
    monkeypatch.setattr(wnet_arch, 'conv3x3',
                        count('k1', wnet_arch.conv3x3))
    return calls


@pytest.mark.parametrize('chns,interm,dtype,chains', [
    ((16, 32, 64), 64, FP32, 4), ((16, 32, 64), 320, FP32, 2),
    ((16, 32, 64), 256, BF16, 4), ((16, 32, 64), 320, BF16, 2),
    ((256, 32, 64), 16, FP32, 2), ((192, 32, 64), 16, FP32, 4),
    ((256, 32, 64), 16, BF16, 2), ((256, 32, 64), 320, FP32, 0)])
def test_wide_chains_take_two_k1(monkeypatch, chns, interm, dtype, chains):
    """A 2-stage forward calls K2 at each chain site that fits and two K1
    (the stem's, or outc's then the residual) at each that does not."""
    cfg = WNetConfig(chns=chns, mid_ch=16, interm_ch=interm, norm='none',
                     act='relu6')
    params = wnet_arch.prepare_params(wnet_init(cfg, seed=1), 'cpu', dtype)
    x = torch.rand((1, 2, 8, 8, 4)).to(dtype)
    calls = _spy(monkeypatch)
    y = wnet_apply(params, x, cfg)
    assert y.shape == (1, 2, 8, 8, 3) and torch.isfinite(y.float()).all()
    assert calls['chain'] == chains
    assert calls['k1'] == 2 * (4 - chains)


def test_wide_wnet_matches_jax():
    """A WNet with interm_ch 320 and chns[0] 256 (both chains of each
    stage past K2 in fp32) equals the JAX package's on the CPU."""
    jax = pytest.importorskip('jax')
    from bsvd_tpu.archs.wnet_arch import WNetConfig as JaxConfig
    from bsvd_tpu.archs.wnet_arch import wnet_apply as jax_apply
    kw = dict(chns=(256, 32, 64), mid_ch=16, interm_ch=320, norm='none',
              act='relu6')
    jcfg, cfg = JaxConfig(**kw), WNetConfig(**kw)
    params = wnet_init(cfg, seed=4)
    jparams = jax.tree.map(jax.numpy.asarray, to_jax_params(params, cfg))
    x = np.random.default_rng(4).uniform(0, 1, (1, 3, 12, 12, 4)).astype(
        np.float32)
    ref = np.asarray(jax.jit(lambda p, v: jax_apply(p, v, jcfg))(
        jparams, jax.numpy.asarray(x)))
    got = wnet_apply(params, torch.from_numpy(x), cfg).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
