"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device (and ``nvcc`` for the first build); it
skips elsewhere. Shapes are small and ragged (sizes that are not multiples
of the 8 x 16 tile, Cin = 3 / 4, Cout = 3) so every masking path runs.

Tolerances: fp32 kernels against the fp32 plain version (cuDNN with TF32
off) differ only in summation order: 1e-4 relative to max|ref|. bf16
kernels are compared with the plain version run in fp32 on the same bf16
values: output rounding (2^-8 relative) plus bf16 rounding of summed inputs
and of the chain's intermediate: 2^-6 relative to max(1, max|ref|).

Run on a card with ``python -m pytest -o addopts= --noconftest
tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from bsvd_tpu_torch.ops.conv3x3 import (conv3x3, conv3x3_reference, conv_ps,
                                        conv_ps_reference)
from bsvd_tpu_torch.ops.conv_chain import (conv_chain, conv_chain_add2_res,
                                           conv_chain_reference)
from bsvd_tpu_torch.ops.conv_s2 import conv_s2, conv_s2_reference

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


def _t(rng, shape, scale, dev):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            * scale).to(dev)


def _close(got, ref, dtype):
    ref = ref.float()
    err = (got.float() - ref).abs().max().item()
    scale = ref.abs().max().item()
    tol = 1e-4 * max(1.0, scale) if dtype == torch.float32 \
        else 2 ** -6 * max(1.0, scale)
    assert got.shape == ref.shape
    assert err <= tol, (err, tol)


DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('case', ['plain', 'tsm', 'tsm_x2', 'causal',
                                  'ragged', 'odd_c'])
def test_conv3x3_kernel(dev, dtype, case):
    rng = np.random.default_rng(1)
    t_len, n = 3, 2
    h, w, c, co = {'ragged': (13, 37, 32, 72), 'odd_c': (9, 17, 20, 3)}.get(
        case, (16, 32, 64, 64))
    shift = {'tsm': 'tsm', 'tsm_x2': 'tsm', 'causal': 'causal'}.get(case,
                                                                    'none')
    x = _t(rng, (n * t_len, h, w, c), 1.0, dev).to(dtype)
    x2 = _t(rng, x.shape, 1.0, dev).to(dtype) if case == 'tsm_x2' else None
    wt = _t(rng, (co, c, 3, 3), (2 / (9 * c)) ** 0.5, dev)
    b = _t(rng, (co,), 0.1, dev)
    before = conv3x3.launches
    got = conv3x3(x, wt, b, x2, t_len=t_len, shift=shift, act='relu6')
    assert conv3x3.launches == before + 1
    torch.cuda.synchronize()
    ref = conv3x3_reference(x.float(), wt, b,
                            None if x2 is None else x2.float(), t_len=t_len,
                            shift=shift, act='relu6')
    assert got.dtype == dtype
    _close(got, ref, dtype)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('shape', [(2, 8, 16, 64, 512), (3, 11, 21, 32, 64)])
def test_conv_ps_kernel(dev, dtype, shape):
    n, h, w, c, co = shape
    rng = np.random.default_rng(2)
    x = _t(rng, (n, h, w, c), 1.0, dev).to(dtype)
    wt = _t(rng, (co, c, 3, 3), (2 / (9 * c)) ** 0.5, dev)
    b = _t(rng, (co,), 0.1, dev)
    got = conv_ps(x, wt, b)
    torch.cuda.synchronize()
    _close(got, conv_ps_reference(x.float(), wt, b), dtype)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('shape', [(2, 16, 32, 64, 128), (3, 13, 35, 4, 64),
                                   (1, 10, 18, 128, 256)])
def test_conv_s2_kernel(dev, dtype, shape):
    n, h, w, c, co = shape
    rng = np.random.default_rng(3)
    x = _t(rng, (n, h, w, c), 1.0, dev).to(dtype)
    wt = _t(rng, (co, c, 3, 3), (2 / (9 * c)) ** 0.5, dev)
    b = _t(rng, (co,), 0.1, dev)
    got = conv_s2(x, wt, b, act='relu6')
    torch.cuda.synchronize()
    _close(got, conv_s2_reference(x.float(), wt, b, act='relu6'), dtype)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('case', ['inc4', 'inc64', 'outc64', 'tail3',
                                  'ragged'])
def test_conv_chain_kernel(dev, dtype, case):
    rng = np.random.default_rng(4)
    n, h, w = 2, 16, 32
    c, c1, co, cres, rc = {'inc4': (4, 64, 64, 0, 0),
                           'inc64': (64, 64, 64, 0, 0),
                           'outc64': (64, 64, 64, 4, 3),
                           'tail3': (64, 64, 3, 64, 3),
                           'ragged': (20, 16, 24, 5, 3)}[case]
    if case == 'ragged':
        h, w = 11, 27
    x = _t(rng, (n, h, w, c), 1.0, dev).to(dtype)
    x2 = _t(rng, x.shape, 1.0, dev).to(dtype) if rc else None
    xr = _t(rng, (n, h, w, cres), 1.0, dev).to(dtype) if rc else None
    w1 = _t(rng, (c1, c, 3, 3), (2 / (9 * c)) ** 0.5, dev)
    b1 = _t(rng, (c1,), 0.1, dev)
    w2 = _t(rng, (co, c1, 3, 3), (2 / (9 * c1)) ** 0.5, dev)
    b2 = _t(rng, (co,), 0.1, dev)
    act2 = 'none' if rc else 'relu6'
    if rc:
        got = conv_chain_add2_res(x, x2, xr, w1, b1, w2, b2, 'relu6', act2,
                                  rc)
    else:
        got = conv_chain(x, w1, b1, w2, b2, 'relu6', act2)
    torch.cuda.synchronize()
    ref = conv_chain_reference(
        x.float(), w1, b1, w2, b2, 'relu6', act2,
        x2=None if x2 is None else x2.float(),
        x_res=None if xr is None else xr.float(), res_ch=rc)
    _close(got, ref, dtype)


def test_kernels_reject_other_dtypes(dev):
    x = torch.zeros((1, 8, 16, 16), dtype=torch.float16, device=dev)
    wt = torch.zeros((16, 16, 3, 3), device=dev)
    with pytest.raises(TypeError):
        conv3x3(x, wt)
    with pytest.raises(TypeError):
        conv_s2(x, wt)


def test_refused_launch_raises_and_clears(dev):
    """A chain whose intermediate cannot fit in shared memory is refused at
    launch: the wrapper raises with CUDA's message, and the next launch is
    not charged with the stale error."""
    x = torch.zeros((1, 8, 16, 16), device=dev)
    w1 = torch.zeros((1024, 16, 3, 3), device=dev)
    w2 = torch.zeros((16, 1024, 3, 3), device=dev)
    before = conv_chain.launches
    with pytest.raises(RuntimeError, match='CUDA error'):
        conv_chain(x, w1, None, w2, None)
    assert conv_chain.launches == before
    y = conv3x3(x, torch.zeros((16, 16, 3, 3), device=dev))
    torch.cuda.synchronize()
    assert y.abs().sum().item() == 0


def test_cpu_weights_are_packed_onto_the_card(dev):
    """Weights living on the CPU are packed onto the activations' device."""
    rng = np.random.default_rng(6)
    x = _t(rng, (2, 8, 16, 16), 1.0, dev)
    wt = _t(rng, (16, 16, 3, 3), 0.1, 'cpu')
    got = conv3x3(x, wt)
    torch.cuda.synchronize()
    _close(got, conv3x3_reference(x, wt.to(dev)), torch.float32)


@pytest.mark.parametrize('shift_mode', ['TSM', 'TSM_toFutureOnly'])
def test_wnet_kernels_match_plain_path(dev, shift_mode):
    """The whole net, fp32 kernels on the card vs the plain path on CPU."""
    from bsvd_tpu_torch.archs.wnet_arch import (WNetConfig, prepare_params,
                                                wnet_apply, wnet_init)
    cfg = WNetConfig(chns=(64, 128, 256), mid_ch=64, interm_ch=64,
                     norm='none', act='relu6', shift_mode=shift_mode)
    params = wnet_init(cfg, seed=0)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.uniform(0, 1, (1, 4, 32, 48, 4))
                         .astype(np.float32))
    ref = wnet_apply(params, x, cfg)
    got = wnet_apply(prepare_params(params, dev, torch.float32), x.to(dev),
                     cfg)
    torch.cuda.synchronize()
    _close(got.cpu(), ref, torch.float32)
