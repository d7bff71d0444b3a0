"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device (and ``nvcc`` for the first build); it
skips elsewhere. Shapes are small and ragged (sizes that are not multiples
of the 8 x 16 or 16 x 16 tiles, nor of K2's 8 x 30 or 14 x 30, Cin = 3 /
4, Cout = 3) so every masking path runs.

Tolerances: fp32 kernels against the fp32 plain version (cuDNN with TF32
off) differ only in summation order: 1e-4 relative to max|ref|. bf16
kernels are compared with the plain version run in fp32 on the same bf16
values: output rounding (2^-8 relative) plus bf16 rounding of summed inputs
and of the chain's intermediate: 2^-6 relative to max(1, max|ref|).

Run on a card with ``python -m pytest -o addopts= --noconftest
tests/test_torch_cuda.py``.
"""

import contextlib
import copy

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


# (clips, t_len, H, W, C, Cout, shift, x2): C = 64 / Cout 64 runs the
# 64-channel block, Cout 72 / 128 / 256 the 128-channel one
_C3_CASES = {'plain': (2, 3, 16, 32, 64, 64, 'none', False),
             'tsm': (2, 3, 16, 32, 64, 64, 'tsm', False),
             'tsm_x2': (2, 3, 16, 32, 64, 64, 'tsm', True),
             'causal': (2, 3, 16, 32, 64, 64, 'causal', False),
             'ragged': (2, 3, 13, 37, 32, 72, 'none', False),
             'odd_c': (2, 3, 9, 17, 20, 3, 'none', False),
             # fold 5: 16-byte chunks straddle the shift regions
             'tsm_fold5': (2, 3, 12, 20, 40, 64, 'tsm', False),
             'tsm_fold5_x2': (2, 3, 12, 20, 40, 128, 'tsm', True),
             'causal_x2': (2, 3, 16, 32, 64, 64, 'causal', True),
             'tsm_x2_c128': (2, 3, 17, 20, 128, 128, 'tsm', True),
             'cout256': (2, 3, 12, 20, 128, 256, 'tsm', False),
             # one frame (the drain conv), sizes not multiples of 16 x 16
             'one_frame': (1, 1, 19, 37, 128, 128, 'none', False),
             'one_frame_c256': (1, 1, 9, 20, 256, 256, 'none', False),
             # the train step's chain recompute: Cin 4 with the addend
             'cin4_x2': (2, 3, 13, 21, 4, 64, 'none', True),
             'c64_x2': (2, 3, 18, 20, 64, 64, 'none', True)}


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('case', sorted(_C3_CASES))
def test_conv3x3_kernel(dev, dtype, case):
    rng = np.random.default_rng(1)
    n, t_len, h, w, c, co, shift, add2 = _C3_CASES[case]
    x = _t(rng, (n * t_len, h, w, c), 1.0, dev).to(dtype)
    x2 = _t(rng, x.shape, 1.0, dev).to(dtype) if add2 else None
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
@pytest.mark.parametrize('shape', [
    (2, 8, 16, 64, 512), (3, 11, 21, 32, 64),
    # one frame (a streaming push); c4 = 128 / 64 / 16; sizes that are not
    # multiples of the 16 x 16 tile
    (1, 17, 35, 128, 512), (1, 9, 20, 64, 256), (1, 16, 32, 32, 64),
    # c4 % 8 != 0 (scalar epilogue); Cin % 8 != 0 (scalar loader)
    (2, 5, 7, 16, 12), (1, 6, 9, 4, 32)])
def test_conv_ps_kernel(dev, dtype, shape):
    n, h, w, c, co = shape
    rng = np.random.default_rng(2)
    x = _t(rng, (n, h, w, c), 1.0, dev).to(dtype)
    wt = _t(rng, (co, c, 3, 3), (2 / (9 * c)) ** 0.5, dev)
    b = _t(rng, (co,), 0.1, dev)
    before = conv_ps.launches
    got = conv_ps(x, wt, b)
    assert conv_ps.launches == before + 1
    torch.cuda.synchronize()
    assert got.dtype == dtype
    _close(got, conv_ps_reference(x.float(), wt, b), dtype)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('shape', [
    (2, 16, 32, 64, 128), (3, 13, 35, 4, 64), (1, 10, 18, 128, 256),
    # one frame over several 16 x 16 output tiles, odd H and W
    (1, 33, 47, 64, 128),
    # odd H and W, Cout 256 (two channel blocks a tile)
    (2, 35, 67, 128, 256),
    # Cout % 8 != 0 (scalar epilogue), Cin % 8 != 0 (scalar loader)
    (2, 11, 21, 16, 20), (1, 9, 7, 12, 40)])
def test_conv_s2_kernel(dev, dtype, shape):
    n, h, w, c, co = shape
    rng = np.random.default_rng(3)
    x = _t(rng, (n, h, w, c), 1.0, dev).to(dtype)
    wt = _t(rng, (co, c, 3, 3), (2 / (9 * c)) ** 0.5, dev)
    b = _t(rng, (co,), 0.1, dev)
    before = conv_s2.launches
    got = conv_s2(x, wt, b, act='relu6')
    assert conv_s2.launches == before + 1
    torch.cuda.synchronize()
    assert got.dtype == dtype
    _close(got, conv_s2_reference(x.float(), wt, b, act='relu6'), dtype)


# (frames, H, W, C, C1, Cout, Cres, rc): the bf16 kernel's output tile is
# 8 x 30 (a 10 x 32 intermediate) without x2, 14 x 30 (16 x 32) with x2 and
# a 64-channel intermediate; Cout <= 16 takes the 16-channel head; C1 128 /
# 192 runs conv1 in two / three 64-channel blocks and conv2's 64-channel
# blocks in turn (x2 on 8 x 30 tiles)
_CHAIN_CASES = {'inc4': (2, 16, 32, 4, 64, 64, 0, 0),
                'inc64': (2, 16, 32, 64, 64, 64, 0, 0),
                'outc64': (2, 16, 32, 64, 64, 64, 4, 3),
                'tail3': (2, 16, 32, 64, 64, 3, 64, 3),
                'ragged': (2, 11, 27, 20, 16, 24, 5, 3),
                # several tiles down and across, H and W not multiples
                'tiles_inc4': (3, 37, 67, 4, 64, 64, 0, 0),
                'tiles_outc64': (3, 37, 67, 64, 64, 64, 4, 3),
                'one_frame_inc64': (1, 50, 95, 64, 64, 64, 0, 0),
                'one_frame_tail3': (1, 35, 61, 64, 64, 3, 4, 3),
                'head16': (2, 21, 33, 64, 64, 16, 0, 0),
                'wide128': (2, 21, 33, 128, 128, 128, 0, 0),
                'wide128_res': (2, 21, 33, 128, 128, 128, 128, 3),
                'wide192_cout200_res': (1, 19, 40, 64, 192, 200, 64, 3),
                'wide128_tail3': (1, 17, 31, 128, 128, 3, 4, 3)}


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('case', sorted(_CHAIN_CASES))
def test_conv_chain_kernel(dev, dtype, case):
    rng = np.random.default_rng(4)
    n, h, w, c, c1, co, cres, rc = _CHAIN_CASES[case]
    x = _t(rng, (n, h, w, c), 1.0, dev).to(dtype)
    x2 = _t(rng, x.shape, 1.0, dev).to(dtype) if rc else None
    xr = _t(rng, (n, h, w, cres), 1.0, dev).to(dtype) if rc else None
    w1 = _t(rng, (c1, c, 3, 3), (2 / (9 * c)) ** 0.5, dev)
    b1 = _t(rng, (c1,), 0.1, dev)
    w2 = _t(rng, (co, c1, 3, 3), (2 / (9 * c1)) ** 0.5, dev)
    b2 = _t(rng, (co,), 0.1, dev)
    act2 = 'none' if rc else 'relu6'
    before = conv_chain.launches
    if rc:
        got = conv_chain_add2_res(x, x2, xr, w1, b1, w2, b2, 'relu6', act2,
                                  rc)
    else:
        got = conv_chain(x, w1, b1, w2, b2, 'relu6', act2)
    assert conv_chain.launches == before + 1
    torch.cuda.synchronize()
    assert got.dtype == dtype
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


def test_chain_bf16_refuses_wide_intermediate(dev):
    """The bf16 chain kernel keeps the whole intermediate in shared memory:
    one wider than fits (320 channels) is refused at launch with CUDA's
    error and not counted; 256 runs."""
    x = torch.zeros((1, 8, 16, 16), dtype=torch.bfloat16, device=dev)
    before = conv_chain.launches
    with pytest.raises(RuntimeError, match='CUDA error'):
        conv_chain(x, torch.zeros((320, 16, 3, 3), device=dev), None,
                   torch.zeros((16, 320, 3, 3), device=dev), None)
    assert conv_chain.launches == before
    y = conv_chain(x, torch.zeros((256, 16, 3, 3), device=dev), None,
                   torch.zeros((16, 256, 3, 3), device=dev), None)
    torch.cuda.synchronize()
    assert conv_chain.launches == before + 1 and y.shape == (1, 8, 16, 16)


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


# ---- K5 bibuffer_conv / bibuffer_multi, K6 bibuffer_chain -------------------

_BI_CASES = {'c16_ragged': (13, 37, 16, 24, 16),     # scalar loader path
             'c128': (10, 20, 128, 128, 128)}         # 16-byte loader path
# K5 alone: Cout 256 (two channel blocks) at a size that is no multiple of
# the 16 x 16 or 8 x 16 tile, where 8 frames x 2 streams take the 16 x 16
# tile and one frame the 8 x 16; fold 5 (chunks straddle the regions)
_K5_CASES = dict(_BI_CASES, c256=(100, 120, 256, 256, 256),
                 fold5=(12, 20, 40, 40, 40))


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('case', sorted(_K5_CASES))
@pytest.mark.parametrize('causal', [False, True])
@pytest.mark.parametrize('streams', [1, 2])
@pytest.mark.parametrize('nf', [1, 2, 5, 8])
def test_bibuffer_multi_kernel(dev, nf, streams, causal, case, dtype):
    from bsvd_tpu_torch.ops.bibuffer_conv import (bibuffer_multi,
                                                  bibuffer_multi_reference)
    h, w, c, co, _ = _K5_CASES[case]
    rng = np.random.default_rng(7)
    shape = (nf, h, w, c) if streams == 1 else (nf, streams, h, w, c)
    x = _t(rng, shape, 1.0, dev).to(dtype)
    st = _t(rng, (streams, h, w, c), 1.0, dev).to(dtype)
    wt = _t(rng, (co, c, 3, 3), (2 / (9 * c)) ** 0.5, dev)
    b = _t(rng, (co,), 0.1, dev)
    before = bibuffer_multi.launches
    y, ns = bibuffer_multi(x, st, wt, b, causal=causal)
    assert bibuffer_multi.launches == before + 1
    torch.cuda.synchronize()
    ry, rs = bibuffer_multi_reference(x.float(), st.float(), wt, b,
                                      causal=causal)
    assert y.dtype == dtype and ns.dtype == dtype
    _close(y, ry, dtype)
    assert torch.equal(ns.float(), rs)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('causal', [False, True])
@pytest.mark.parametrize('shape', [(3, 12, 24, 64), (2, 100, 120, 256),
                                   (2, 12, 20, 40)])
def test_bibuffer_conv_kernel_streams(dev, shape, causal, dtype):
    """F = 1 over N = 3 or 2 streams (the per-push form): 64 channels,
    256 (two channel blocks, several tiles), fold 5."""
    from bsvd_tpu_torch.ops.bibuffer_conv import (bibuffer_conv,
                                                  bibuffer_conv_reference)
    rng = np.random.default_rng(8)
    c = shape[-1]
    x = _t(rng, shape, 1.0, dev).to(dtype)
    st = _t(rng, x.shape, 1.0, dev).to(dtype)
    wt = _t(rng, (c, c, 3, 3), (2 / (9 * c)) ** 0.5, dev)
    b = _t(rng, (c,), 0.1, dev)
    before = bibuffer_conv.launches
    y, ns = bibuffer_conv(x, st, wt, b, act='relu', causal=causal)
    assert bibuffer_conv.launches == before + 1
    torch.cuda.synchronize()
    assert y.dtype == dtype and ns.dtype == dtype
    ry, rs = bibuffer_conv_reference(x.float(), st.float(), wt, b,
                                     act='relu', causal=causal)
    _close(y, ry, dtype)
    assert torch.equal(ns.float(), rs)


# K6 alone: 256 channels (four 64-channel blocks of y1, the 4 x 30 tile),
# fold 5 (conv2's K slices straddle y1 and s2 lanes, elements and 16-byte
# chunks), Cout != C1 (two channel blocks of y), and a grid large enough
# for the 8 x 30 tile (2 x 18 x 16 blocks); sizes no multiple of the tiles
_K6_CASES = dict(_BI_CASES, c256=(100, 120, 256, 256, 256),
                 fold5=(12, 20, 40, 40, 40), cout96=(19, 33, 64, 64, 96),
                 c128_8row=(138, 478, 128, 128, 128))


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('case', sorted(_K6_CASES))
@pytest.mark.parametrize('causal', [False, True])
def test_bibuffer_chain_kernel(dev, causal, case, dtype):
    """K6 on N = 2 streams against the plain version in fp32: s1' and s2''s
    lanes copied from s2 exactly, y and s2''s y1 lanes within tolerance."""
    from bsvd_tpu_torch.ops.bibuffer_conv import (bibuffer_chain,
                                                  bibuffer_chain_reference)
    h, w, c, c1, co = _K6_CASES[case]
    rng = np.random.default_rng(9)
    x = _t(rng, (2, h, w, c), 1.0, dev).to(dtype)
    s1 = _t(rng, x.shape, 1.0, dev).to(dtype)
    s2 = _t(rng, (2, h, w, c1), 1.0, dev).to(dtype)
    w1 = _t(rng, (c1, c, 3, 3), (2 / (9 * c)) ** 0.5, dev)
    b1 = _t(rng, (c1,), 0.1, dev)
    w2 = _t(rng, (co, c1, 3, 3), (2 / (9 * c1)) ** 0.5, dev)
    b2 = _t(rng, (co,), 0.1, dev)
    before = bibuffer_chain.launches
    y, n1, n2 = bibuffer_chain(x, s1, s2, w1, b1, w2, b2, causal=causal)
    assert bibuffer_chain.launches == before + 1
    torch.cuda.synchronize()
    ry, r1, r2 = bibuffer_chain_reference(x.float(), s1.float(), s2.float(),
                                          w1, b1, w2, b2, causal=causal)
    assert y.dtype == n1.dtype == n2.dtype == dtype
    _close(y, ry, dtype)
    assert torch.equal(n1.float(), r1)
    f2 = 0 if causal else c1 // 8           # s2' lanes copied from s2
    assert torch.equal(n2[..., :f2].float(), r2[..., :f2])
    _close(n2[..., f2:], r2[..., f2:], dtype)


@pytest.mark.parametrize('case', sorted(_K6_CASES))
@pytest.mark.parametrize('causal', [False, True])
def test_bibuffer_chain_kernel_equals_two_k5_steps(dev, causal, case):
    """bf16 K6 sums y1 and y in K5's slice and tap order and rounds them
    where K5 does: (y, s1', s2') are two K5 steps' bits."""
    from bsvd_tpu_torch.ops.bibuffer_conv import (bibuffer_chain,
                                                  bibuffer_conv)
    h, w, c, c1, co = _K6_CASES[case]
    rng = np.random.default_rng(11)
    bf = torch.bfloat16
    x = _t(rng, (2, h, w, c), 1.0, dev).to(bf)
    s1 = _t(rng, x.shape, 1.0, dev).to(bf)
    s2 = _t(rng, (2, h, w, c1), 1.0, dev).to(bf)
    w1 = _t(rng, (c1, c, 3, 3), (2 / (9 * c)) ** 0.5, dev)
    b1 = _t(rng, (c1,), 0.1, dev)
    w2 = _t(rng, (co, c1, 3, 3), (2 / (9 * c1)) ** 0.5, dev)
    b2 = _t(rng, (co,), 0.1, dev)
    got = bibuffer_chain(x, s1, s2, w1, b1, w2, b2, causal=causal)
    y1, r1 = bibuffer_conv(x, s1, w1, b1, causal=causal)
    y, r2 = bibuffer_conv(y1, s2, w2, b2, causal=causal)
    torch.cuda.synchronize()
    for g, r in zip(got, (y, r1, r2)):
        assert torch.equal(g, r)


@pytest.mark.parametrize('chain_max_c', [None, 0, 128, 256])
@pytest.mark.parametrize('batch', [1, 2])
@pytest.mark.parametrize('shift_mode', ['TSM', 'TSM_toFutureOnly'])
def test_stream_denoiser_kernels_match_plain_path(dev, shift_mode, batch,
                                                  chain_max_c, monkeypatch):
    """A small net streamed on the card (push, push_block, flush) in fp32
    against the plain streaming path on the CPU, for 1 and 2 streams, by
    the port's MemCvBlock route (None) and by each route forced: every
    MemCvBlock by two K5 steps (``CHAIN_MAX_C`` 0), the 32-channel ones by
    K6 and the 160-channel ones by K5 (128), or every one by K6 (256)."""
    from bsvd_tpu_torch.archs import streaming
    from bsvd_tpu_torch.archs.streaming import StreamDenoiser
    from bsvd_tpu_torch.archs.wnet_arch import (WNetConfig, prepare_params,
                                                wnet_init)
    if chain_max_c is not None:
        monkeypatch.setattr(streaming, 'CHAIN_MAX_C', chain_max_c)
    cfg = WNetConfig(chns=(16, 32, 160), mid_ch=16, interm_ch=16,
                     norm='none', act='relu6', shift_mode=shift_mode)
    params = wnet_init(cfg, seed=1)
    rng = np.random.default_rng(10)
    t, h, w = 22, 16, 32
    x = torch.from_numpy(rng.uniform(0, 1, (t, batch, h, w, 4))
                         .astype(np.float32))
    outs = {}
    for where in ('cpu', 'cuda'):
        p = params if where == 'cpu' else prepare_params(params, dev,
                                                         torch.float32)
        sd = StreamDenoiser(p, cfg, batch=batch, height=h, width=w)
        got = [sd.push(x[i]) for i in range(18)]
        got += sd.push_block(x[18:])
        got += sd.flush()
        outs[where] = torch.stack([o.cpu() for o in got if o is not None])
    assert outs['cuda'].shape == (t, batch, h, w, 3)
    _close(outs['cuda'], outs['cpu'], torch.float32)


# ---- K7 conv3x3_dw and the autograd Functions (training) --------------------

@contextlib.contextmanager
def _masks(tape, replay=False):
    """Record the activation masks of a backward pass in call order
    (``replay`` False), or hand them to a later backward pass in the same
    order. A pre-activation within rounding of 0 or 6 may fall on the other
    side of the clip on the other device (or in bf16), and its mask then
    moves a gradient by a whole pixel's contribution: comparisons of
    backward passes share the masks."""
    from bsvd_tpu_torch.ops import conv3x3 as c3, conv_chain as cc, \
        conv_s2 as s2
    from bsvd_tpu_torch.ops._pack import act_mask
    mods = (c3, cc, s2)
    saved = [m.masked for m in mods]

    def record(g, y, act):
        m = act_mask(y, act)
        tape.append(m)
        return g if m is None else g * m

    def play(g, y, act):
        m = tape.pop(0)
        return g if m is None else g * m.to(g.device, g.dtype)
    for m in mods:
        m.masked = play if replay else record
    try:
        yield
    finally:
        for m, fn in zip(mods, saved):
            m.masked = fn


def _rel(got, ref, tol):
    """max|got - ref| within tol x max|ref| (a weight gradient sums over
    every pixel, so its scale is not 1)."""
    ref = ref.float()
    err = (got.float() - ref).abs().max().item()
    assert got.shape == ref.shape
    assert err <= tol * ref.abs().max().item(), (err, ref.abs().max().item())


_DW_CASES = {'c64': (6, 16, 32, 64, 64, 'none', False),
             'tsm': (6, 16, 32, 64, 64, 'tsm', False),
             'tsm_x2': (6, 16, 32, 64, 64, 'tsm', True),
             'causal': (6, 16, 32, 128, 64, 'causal', False),
             'ragged': (3, 13, 37, 20, 72, 'none', True),
             'cin4': (2, 12, 20, 4, 64, 'none', False),
             'cout3': (2, 12, 20, 64, 3, 'none', False),
             # H, W not multiples of the 8 x 8 tile
             'ragged_hw': (3, 11, 13, 64, 64, 'none', False),
             'cin4_ragged': (3, 11, 13, 4, 64, 'none', True),
             'cout3_tsm': (6, 9, 17, 64, 3, 'tsm', False),
             # clip edges with the addend: causal, and TSM with fold 4
             # (8-channel groups straddle the shift regions)
             'causal_x2': (6, 10, 12, 64, 64, 'causal', True),
             'tsm_fold4_x2': (6, 9, 17, 32, 64, 'tsm', True),
             # several channel blocks and pixel splits
             'wide': (6, 12, 20, 128, 256, 'tsm', False)}


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('case', sorted(_DW_CASES))
def test_conv3x3_dw_kernel(dev, dtype, case):
    """K7 against the plain fp32 weight gradient on the same values (the
    bf16 case too: both sum exact products in fp32), and bit-identical on
    a second run (the partial sums are combined in a fixed order)."""
    from bsvd_tpu_torch.ops.conv3x3 import conv3x3_dw, conv3x3_dw_reference
    nt, h, w, c, co, shift, add2 = _DW_CASES[case]
    rng = np.random.default_rng(11)
    x = _t(rng, (nt, h, w, c), 1.0, dev).to(dtype)
    x2 = _t(rng, x.shape, 1.0, dev).to(dtype) if add2 else None
    dz = _t(rng, (nt, h, w, co), 1.0, dev).to(dtype)
    kw = dict(t_len=3, shift=shift)
    before = conv3x3_dw.launches
    got = conv3x3_dw(x, dz, x2, **kw)
    again = conv3x3_dw(x, dz, x2, **kw)
    assert conv3x3_dw.launches == before + 2
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (co, c, 3, 3)
    assert torch.equal(got, again)
    _rel(got, conv3x3_dw_reference(x, dz, x2, **kw), 1e-4)


def _fn_case(name, dev, dtype, rng):
    """(call(*tensors), input tensors, cotangent shape) of one Function."""
    from bsvd_tpu_torch.ops.shift_conv import shift_conv, shift_conv_add2
    n, h, w = 6, 12, 20

    def a(*shape):
        return _t(rng, shape, 1.0, dev)

    def wt(ci, co):
        return [_t(rng, (co, ci, 3, 3), (2 / (9 * ci)) ** 0.5, dev),
                _t(rng, (co,), 0.1, dev)]
    if name == 'conv3x3':
        return (lambda x, w_, b: conv3x3(x, w_, b, act='relu6'),
                [a(n, h, w, 32)] + wt(32, 32), (n, h, w, 32))
    if name == 'shift_conv':
        return (lambda x, w_, b: shift_conv(x, w_, b, 3),
                [a(n, h, w, 32)] + wt(32, 32), (n, h, w, 32))
    if name == 'shift_conv_add2':
        return (lambda x, x2, w_, b: shift_conv_add2(x, x2, w_, b, 3,
                                                     causal=True),
                [a(n, h, w, 32), a(n, h, w, 32)] + wt(32, 32),
                (n, h, w, 32))
    if name == 'conv_ps':
        return (conv_ps, [a(n, h, w, 32)] + wt(32, 64), (n, 2 * h, 2 * w, 16))
    if name == 'conv_s2':
        return (lambda x, w_, b: conv_s2(x, w_, b, act='relu6'),
                [a(n, h, w, 16)] + wt(16, 32), (n, h // 2, w // 2, 32))
    if name == 'chain_inc':
        return (lambda x, w1, b1, w2, b2: conv_chain(x, w1, b1, w2, b2,
                                                     'relu6', 'relu6'),
                [a(n, h, w, 4)] + wt(4, 16) + wt(16, 16), (n, h, w, 16))
    return (lambda x, x2, xr, w1, b1, w2, b2: conv_chain_add2_res(
                x, x2, xr, w1, b1, w2, b2, 'relu6', 'none', 3),
            [a(n, h, w, 16), a(n, h, w, 16), a(n, h, w, 4)] + wt(16, 16)
            + wt(16, 4), (n, h, w, 4))


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('name', ['conv3x3', 'shift_conv', 'shift_conv_add2',
                                  'conv_ps', 'conv_s2', 'chain_inc',
                                  'chain_res'])
def test_autograd_functions_match_plain(dev, name, dtype):
    """Each op's output and every input's gradient through its kernels (K7
    for the weight gradients, K1 for a chain's intermediate) against the
    plain ops' autograd on the CPU in fp32 on the same values, the
    activation masks shared (``_masks``). bf16 tolerance: the saved
    output, the recomputed intermediate and each cotangent round to bf16
    (2^-8 relative each), so 2^-5 of max|ref|."""
    from bsvd_tpu_torch.ops.conv3x3 import conv3x3_dw
    rng = np.random.default_rng(12)
    fn, ins, gshape = _fn_case(name, dev, dtype, rng)
    g = _t(rng, gshape, 1.0, dev)
    ins = [t.to(dtype) for t in ins]
    dw_before = conv3x3_dw.launches
    kern = [t.detach().requires_grad_(True) for t in ins]
    tape = []
    with _masks(tape):
        y = fn(*kern)
        y.backward(g.to(y.dtype))
    torch.cuda.synchronize()
    plain = [t.detach().float().cpu().requires_grad_(True) for t in ins]
    with _masks(tape, replay=True):
        ry = fn(*plain)
        ry.backward(g.cpu())
    assert not tape
    tol = 1e-4 if dtype == torch.float32 else 2 ** -5
    _rel(y.cpu(), ry.detach(), tol)
    for t, r in zip(kern, plain):
        assert t.grad.dtype == dtype
        _rel(t.grad.cpu(), r.grad, tol)
    if name != 'conv_s2':                   # stride-2 dw is aten's
        assert conv3x3_dw.launches > dw_before


@pytest.mark.parametrize('amp', [False, True])
def test_train_step_kernels_match_plain(dev, amp):
    """A DenoisingModel step of a small net on the card against the same
    step on the CPU (the activation masks shared): fp32 to 1e-4 x max|ref|
    in the loss and every gradient; bf16 AMP finite with its loss within
    2^-5."""
    from bsvd_tpu_torch.models.denoising_model import DenoisingModel
    net = {'type': 'TSN', 'num_segments': 5, 'base_model': 'WNet_multistage',
           'shift_type': 'TSM', 'shift_div': 8,
           'net2d_opt': {'chns': [16, 32, 64], 'mid_ch': 16, 'interm_ch': 16,
                         'norm': 'none', 'act': 'relu6'}}
    opt = {'model_type': 'DenoisingModel', 'is_train': True, 'network_g': net,
           'path': {}, 'train': {
               'optim_g': {'type': 'Adam', 'lr': 1e-3, 'betas': [0.9, 0.99]},
               'scheduler': {'type': 'MultiStepLR', 'milestones': [10],
                             'gamma': 0.7},
               'pixel_opt': {'type': 'MSELoss', 'loss_weight': 1.0},
               'ema_decay': 0.999, 'fp16': amp}}
    rng = np.random.default_rng(13)
    gt = rng.uniform(0, 1, (2, 5, 3, 24, 32)).astype(np.float32)
    batch = {'gt': gt, 'lq': gt + rng.normal(0, 0.1, gt.shape).astype(
        np.float32), 'noise_map': np.full((2, 5, 1, 24, 32), 0.1, np.float32)}
    models, tape = {}, []
    for where in ('cuda', 'cpu'):
        m = DenoisingModel(copy.deepcopy(opt), device=where)
        m.feed_data(batch)
        with _masks(tape, replay=where == 'cpu'):
            m.optimize_parameters(1)
        models[where] = m
    cpu, card = models['cpu'], models['cuda']
    loss, ref = card.get_current_log()['l_pix'], cpu.get_current_log()['l_pix']
    assert np.isfinite(loss)
    if amp:
        assert abs(loss - ref) <= 2 ** -5 * abs(ref)
        return
    assert abs(loss - ref) <= 1e-4 * abs(ref)
    ref_grads = dict(cpu.net.named_parameters())
    for name, p in card.net.named_parameters():
        _rel(p.grad.cpu(), ref_grads[name].grad, 1e-4)


# ---- the chunked protocol and the eval path ---------------------------------

def _c64(shift_mode, seed=0):
    from bsvd_tpu_torch.archs import build_network
    return build_network({'type': 'BSVD', 'chns': [64, 128, 256],
                          'mid_ch': 64, 'interm_ch': 64, 'norm': 'none',
                          'act': 'relu6', 'shift_mode': shift_mode,
                          'seed': seed})


@contextlib.contextmanager
def _no_conv2d():
    import torch.nn.functional as F
    orig = F.conv2d

    def refuse(*a, **k):
        raise AssertionError('F.conv2d called on the kernel path')
    F.conv2d = refuse
    try:
        yield
    finally:
        F.conv2d = orig


@pytest.mark.parametrize('shift_mode', ['TSM', 'TSM_toFutureOnly'])
def test_chunk_path_launches_per_chunk(dev, shift_mode):
    """Each chunk: K1 32 (16 zero-boundary shift convs, 14 of them through
    the generation-1 entry, and 16 one-frame recomputes of frame 0), K2 /
    K3 / K4 4 each; F.conv2d never runs."""
    from bsvd_tpu_torch.models.seq_inference import denoise_seq
    from bsvd_tpu_torch.ops.shift_conv import shift_conv_fused_v1
    net = _c64(shift_mode)
    seq = np.random.default_rng(8).uniform(0, 1, (13, 3, 32, 48)).astype(
        np.float32)
    fns = (conv3x3, shift_conv_fused_v1, conv_chain, conv_s2, conv_ps)
    for f in fns:
        f.launches = 0
    with _no_conv2d():
        out = denoise_seq(net, None, seq, noise_sigma=0.1, temp_psz=4,
                          future_buffer_len=2, compute_dtype=torch.bfloat16)
    chunks = 4                          # 3 of 4 frames and the tail
    assert [f.launches for f in fns] == [32 * chunks, 14 * chunks,
                                         4 * chunks, 4 * chunks, 4 * chunks]
    assert out.shape == seq.shape and np.isfinite(out).all()


@pytest.mark.parametrize('shift_mode', ['TSM', 'TSM_toFutureOnly'])
def test_chunked_fp32_kernels_match_plain_path(dev, shift_mode):
    from bsvd_tpu_torch.models.seq_inference import denoise_seq
    from bsvd_tpu_torch.ops.shift_conv import shift_conv_fused_v1
    net = _c64(shift_mode, seed=1)
    seq = np.random.default_rng(9).uniform(0, 1, (13, 3, 32, 48)).astype(
        np.float32)
    kw = dict(noise_sigma=0.1, temp_psz=4, future_buffer_len=2)
    fns = (conv3x3, shift_conv_fused_v1, conv_chain, conv_s2, conv_ps)
    for f in fns:
        f.launches = 0
    # the plain path: the weights copied to the CPU, where no kernel runs
    ref = denoise_seq(net.prepared('cpu', torch.float32), net.cfg, seq, **kw)
    assert [f.launches for f in fns] == [0] * len(fns)
    got = denoise_seq(net, None, seq, compute_dtype=torch.float32, **kw)
    _close(torch.from_numpy(got), torch.from_numpy(ref), torch.float32)


@pytest.mark.parametrize('future', [0, 2])
def test_block_stream_equals_denoise_seq_bf16(dev, future):
    """push / flush and denoise_seq run the same chunks through the same
    kernels: equal bit for bit in bf16."""
    from bsvd_tpu_torch.models.seq_inference import (BlockStreamDenoiser,
                                                     denoise_seq)
    net = _c64('TSM', seed=2)
    seq = np.random.default_rng(10).uniform(0, 1, (14, 3, 32, 48)).astype(
        np.float32)
    want = denoise_seq(net, None, seq, noise_sigma=0.1, temp_psz=4,
                       future_buffer_len=future,
                       compute_dtype=torch.bfloat16)
    x = np.concatenate([seq, np.full_like(seq[:, :1], 0.1)], axis=1)
    bsd = BlockStreamDenoiser(net, None, psz=4, future_buffer_len=future,
                              dtype=torch.bfloat16)
    outs = []
    for f in np.transpose(x, (0, 2, 3, 1)):
        outs += bsd.push(f[None])
    outs += bsd.flush()
    got = torch.stack(outs, dim=1)[0].permute(0, 3, 1, 2).float().cpu()
    assert torch.equal(got, torch.from_numpy(want))


def test_native_decoder_builds_or_raises_with_gxx_output(dev, tmp_path):
    """On the card's machine (no cv2, no libjpeg) every frame type the port
    reads builds and reads there: PNG through the zlib reader, JPEG
    through the standard-C++ decoder (frames written by the port's JPEG
    writer), each by its file type, the JPEG windows equal to the crop of
    the whole decode."""
    from bsvd_tpu_torch.data import jpeg_decode, utils_common
    from bsvd_tpu_torch.utils.img_util import imwrite
    rng = np.random.default_rng(11)
    frames = rng.integers(0, 256, (3, 20, 36, 3), dtype=np.uint8)
    paths = [str(tmp_path / f'{i}.png') for i in range(3)]
    for f, p in zip(frames, paths):
        imwrite(f[..., ::-1], p)                      # BGR, as cv2's
    np.testing.assert_array_equal(utils_common.load_seq(paths), frames)
    jpgs = [str(tmp_path / f'{i}.jpg') for i in range(3)]
    for f, p in zip(frames, jpgs):
        imwrite(f[..., ::-1], p, [1, 95])
    before = utils_common.ROUTES['jpeg_decode']
    seq = utils_common.load_seq(jpgs)
    assert utils_common.ROUTES['jpeg_decode'] == before + 3
    assert seq.shape == frames.shape
    for s, p in zip(seq, jpgs):
        np.testing.assert_array_equal(s, jpeg_decode.load(p))
    np.testing.assert_array_equal(
        utils_common.load_crop_seq(jpgs, 3, 5, 11, 17), seq[:, 3:14, 5:22])
    with pytest.raises(IOError):                      # no such JPEG file
        utils_common.load_seq([str(tmp_path / 'missing.jpg')])


def test_jpeg_decoder_matches_the_fixtures_on_the_card(dev):
    """The card's machine has no cv2: there the JPEG decoder is held to
    libjpeg-turbo's decode of the committed fixtures
    (tests/fixtures/jpeg/decoded.npz), bit for bit."""
    import os
    from bsvd_tpu_torch.data import jpeg_decode
    folder = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          'fixtures', 'jpeg')
    ref = np.load(os.path.join(folder, 'decoded.npz'))
    assert len(ref.files) == 8
    for name in ref.files:
        np.testing.assert_array_equal(
            jpeg_decode.load(os.path.join(folder, f'{name}.jpg')), ref[name])


def test_train_and_test_cli_on_png_folders(dev, tmp_path):
    """The two command-line runs on the card from the shipped option files,
    narrowed by --force_yml: train_pipeline 2 iterations on PNG frame
    folders with validation and a checkpoint, an --auto_resume to 3, then
    test_pipeline on a written test yml over one PNG clip."""
    import os
    from bsvd_tpu_torch.data.video_train_loader import synthetic_clips
    from bsvd_tpu_torch.test import test_pipeline
    from bsvd_tpu_torch.train import train_pipeline
    from bsvd_tpu_torch.utils.img_util import imwrite
    root = str(tmp_path)
    clips = synthetic_clips(np.random.default_rng(12), 2, 8, 40, 56)
    for split in ('train', 'val'):
        for i, c in enumerate(clips[:2 if split == 'train' else 1]):
            for k, f in enumerate(c):
                imwrite(f.transpose(1, 2, 0)[..., ::-1],
                        f'{root}/{split}/clip{i}/{k:03d}.png')
    yml = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), 'options', 'train', 'bsvd_c64_unblind.yml')
    force = [f'datasets:train:trainset_dir={root}/train',
             f'datasets:val:valsetdir={root}/val',
             'datasets:val:num_validation_frames=8',
             'datasets:train:batch_size_per_gpu=2',
             'datasets:train:temp_patch_size=5',
             'datasets:train:patch_size=[32,32]',
             'datasets:train:num_workers=2', 'network_g:num_segments=5',
             'network_g:net2d_opt:chns=[16,32,64]',
             'network_g:net2d_opt:mid_ch=16',
             'network_g:net2d_opt:interm_ch=16', 'val:temp_psz=4',
             'logger:print_freq=1', 'logger:save_checkpoint_freq=2',
             'val:val_freq=2', 'train:fp16=true']
    model = train_pipeline(root, cmd=['-opt', yml, '--force_yml', *force,
                                      'train:total_iter=2'])
    assert model.device.type == 'cuda' and model.optimizer.count == 2
    exp = f'{root}/experiments/bsvd_c64_unblind'
    for f in ('models/net_g_2.npz', 'training_states/2.state',
              'bsvd_c64_unblind.yml'):
        assert os.path.isfile(f'{exp}/{f}'), f
    model = train_pipeline(root, cmd=['-opt', yml, '--auto_resume',
                                      '--force_yml', *force,
                                      'train:total_iter=3'])
    assert model.optimizer.count == 3
    test_yml = f'{root}/test.yml'
    with open(test_yml, 'w') as f:
        f.write(f"""name: card_cli
model_type: DenoisingModel
num_gpu: 1
manual_seed: 10
datasets:
  val_1:
    name: synth
    type: ValFolderDataset
    valsetdir: {root}/val
    num_validation_frames: 8
    valnoisestd: 20
network_g:
  type: BSVD
  chns: [16, 32, 64]
  mid_ch: 16
  interm_ch: 16
  norm: 'none'
  act: 'relu6'
path:
  pretrain_network_g: {exp}/models/net_g_2.npz
  strict_load_g: true
val:
  save_img: false
  temp_psz: -1
  fp16: true
  metrics:
    psnr: {{type: calculate_psnr, crop_border: 2, test_y_channel: false}}
""")
    res = test_pipeline(root, cmd=['-opt', test_yml])['synth']
    assert np.isfinite(res['psnr'])


# ---- the WNet options: fold 0, and every path per option --------------------

@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('shift', ['tsm', 'causal'])
@pytest.mark.parametrize('c', [3, 4, 5])
def test_fold0_conv3x3_and_dw_kernels(dev, c, shift, dtype):
    """shift_input's stage-0 stems: 3-5 channels at fold_div 8, fold 0 (the
    shift moves no lane). K1 forward and K7's weight gradient against their
    plain versions."""
    rng = np.random.default_rng(20 + c)
    t_len = 3
    x = _t(rng, (2 * t_len, 13, 21, c), 1.0, dev).to(dtype)
    wt = _t(rng, (64, c, 3, 3), (2 / (9 * c)) ** 0.5, dev)
    b = _t(rng, (64,), 0.1, dev)
    before = conv3x3.launches
    got = conv3x3(x, wt, b, t_len=t_len, shift=shift, fold_div=8,
                  act='none')
    assert conv3x3.launches == before + 1
    torch.cuda.synchronize()
    ref = conv3x3_reference(x.float(), wt, b, t_len=t_len, shift=shift,
                            fold_div=8, act='none')
    _close(got, ref, dtype)
    from bsvd_tpu_torch.ops.conv3x3 import conv3x3_dw, conv3x3_dw_reference
    dz = _t(rng, (2 * t_len, 13, 21, 64), 1.0, dev).to(dtype)
    dw = conv3x3_dw(x, dz, t_len=t_len, shift=shift, fold_div=8)
    torch.cuda.synchronize()
    _rel(dw, conv3x3_dw_reference(x.float(), dz.float(), t_len=t_len,
                                  shift=shift, fold_div=8),
         1e-4 if dtype == torch.float32 else 2 ** -6)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('causal', [False, True])
@pytest.mark.parametrize('c', [3, 4, 5])
def test_fold0_bibuffer_kernels(dev, c, causal, dtype):
    """K5 at fold 0 (shift_input's first buffered inc conv): one frame and
    8 frames, against the plain version; the next state is the last frame,
    exactly."""
    from bsvd_tpu_torch.ops.bibuffer_conv import (bibuffer_conv,
                                                  bibuffer_conv_reference,
                                                  bibuffer_multi,
                                                  bibuffer_multi_reference)
    rng = np.random.default_rng(30 + c)
    x = _t(rng, (8, 1, 19, 37, c), 1.0, dev).to(dtype)
    st = _t(rng, (1, 19, 37, c), 1.0, dev).to(dtype)
    wt = _t(rng, (64, c, 3, 3), (2 / (9 * c)) ** 0.5, dev)
    b = _t(rng, (64,), 0.1, dev)
    y, ns = bibuffer_conv(x[0], st, wt, b, fold_div=8, act='relu6',
                          causal=causal)
    ym, nsm = bibuffer_multi(x, st, wt, b, fold_div=8, act='relu6',
                             causal=causal)
    torch.cuda.synchronize()
    ry, rs = bibuffer_conv_reference(x[0].float(), st.float(), wt, b, 8,
                                     'relu6', causal)
    rym, rsm = bibuffer_multi_reference(x.float(), st.float(), wt, b, 8,
                                        'relu6', causal)
    _close(y, ry, dtype)
    _close(ym, rym, dtype)
    assert torch.equal(ns.float(), rs) and torch.equal(nsm.float(), rsm)
    assert torch.equal(nsm, x[-1])


_OPTION_NETS = {
    'shift_input': dict(shift_input=True),
    'shift_input_causal': dict(shift_input=True,
                               shift_mode='TSM_toFutureOnly'),
    'bn': dict(norm='bn'),
    'in': dict(norm='in'),
    'in_causal': dict(norm='in', shift_mode='TSM_toFutureOnly'),
    'raw': dict(in_ch=5, out_ch=4, residual_ch=4),
    'c32_blind': dict(chns=(32, 64, 128), mid_ch=32, interm_ch=32,
                      blind=True),
}


def _option_net(variant, seed=3):
    """A small net of the option (c32 at its widths); BN leaves given
    seeded running statistics."""
    from bsvd_tpu_torch.archs.wnet_arch import WNetConfig, wnet_init
    kw = dict(chns=(16, 32, 64), mid_ch=16, interm_ch=16, norm='none',
              act='relu6')
    kw.update(_OPTION_NETS[variant])
    cfg = WNetConfig(**kw)
    params = wnet_init(cfg, seed=seed)
    g = torch.Generator().manual_seed(seed)

    def stats(tree):
        for v in tree.values():
            if isinstance(v, dict) and 'mean' in v:
                ch = v['mean'].shape[0]
                v['mean'] = torch.rand(ch, generator=g) * 0.6 - 0.3
                v['var'] = torch.rand(ch, generator=g) * 1.5 + 0.5
                v['scale'] = torch.rand(ch, generator=g) + 0.5
            elif isinstance(v, dict):
                stats(v)
    stats(params)
    return cfg, params


def _launch_counts():
    from bsvd_tpu_torch.ops.bibuffer_conv import (bibuffer_chain,
                                                  bibuffer_conv,
                                                  bibuffer_multi)
    fns = {'conv3x3': conv3x3, 'conv_chain': conv_chain, 'conv_s2': conv_s2,
           'conv_ps': conv_ps, 'bibuffer_conv': bibuffer_conv,
           'bibuffer_multi': bibuffer_multi, 'bibuffer_chain': bibuffer_chain}
    return {k: f.launches for k, f in fns.items()}


def _delta(before):
    now = _launch_counts()
    return {k: now[k] - before[k] for k in now}


@pytest.mark.parametrize('variant', sorted(_OPTION_NETS))
def test_option_paths_match_plain_path(dev, variant):
    """Each option in fp32 on the card, whole clip, stream (push, steady
    push_block, flush) and chunk (denoise_seq temp_psz 4, look-ahead 2),
    against the plain path on the CPU with the CPU weights (which launches
    no kernel); the launches per forward, chunk, push and push_block follow
    the routes; F.conv2d never runs on the card."""
    from bsvd_tpu_torch.archs.streaming import StreamDenoiser, pipeline_latency
    from bsvd_tpu_torch.archs.wnet_arch import (prepare_params, wnet_apply,
                                                wnet_apply_chunk)
    from bsvd_tpu_torch.models.seq_inference import denoise_seq
    from chip_smoke import option_launches
    cfg, params = _option_net(variant)
    lat = pipeline_latency(cfg)
    rng = np.random.default_rng(11)
    t, h, w = lat + 6, 16, 32
    cin = cfg.effective_in_ch
    x = torch.from_numpy(rng.uniform(0, 1, (1, t, h, w, cin))
                         .astype(np.float32))
    seq = rng.uniform(0, 1, (13, cfg.out_ch, h, w)).astype(np.float32)
    chunk_kw = dict(noise_sigma=None if cfg.blind else 0.1, temp_psz=4,
                    future_buffer_len=2)

    def run(p, xin):
        out = {'clip': wnet_apply(p, xin, cfg)}
        sd = StreamDenoiser(p, cfg, batch=1, height=h, width=w)
        got = [sd.push(xin[:, i]) for i in range(lat + 2)]
        before = _launch_counts()
        got.append(sd.push(xin[:, lat + 2]))
        out['push'] = _delta(before)
        before = _launch_counts()
        got += sd.push_block(list(xin[:, lat + 3:].unbind(1)))
        out['block'] = _delta(before)
        got += sd.flush()
        out['stream'] = torch.stack([o for o in got if o is not None], 1)
        out['chunked'] = denoise_seq(p, cfg, seq, **chunk_kw)
        return out

    before = _launch_counts()
    ref = run(prepare_params(params, 'cpu', torch.float32), x)
    assert _delta(before) == dict.fromkeys(before, 0)
    p = prepare_params(params, dev, torch.float32)
    with _no_conv2d():
        before = _launch_counts()
        wnet_apply(p, x.to(dev), cfg)
        fwd = _delta(before)
        got = run(p, x.to(dev))
        torch.cuda.synchronize()
        before = _launch_counts()
        with torch.no_grad():
            wnet_apply_chunk(p, x[:, :6].to(dev), cfg, None, 2)
        chunk = _delta(before)
    for name in ('clip', 'stream'):
        _close(got[name].cpu(), ref[name], torch.float32)
    _close(torch.from_numpy(got['chunked']), torch.from_numpy(ref['chunked']),
           torch.float32)
    for unit, seen in (('forward', fwd), ('chunk', chunk),
                       ('push', got['push']), ('block', got['block'])):
        want = {k: n for k, n in option_launches(cfg, unit).items()
                if k in seen}
        assert seen == want, (unit, seen, want)


def test_two_gloo_ranks_on_one_card_match_unsharded(dev):
    """Two gloo ranks on cuda:0 (``parallel.dryrun``): the BSVD-c64 whole
    clip with its rows over both ranks, and one train step with its rows
    over both, each held against the same call unsharded on the card
    (fp32: 1e-4 x max|ref|; the step's gradients 1e-4 of each tensor's
    max, the parameters the same bits on both ranks), the kernels
    launched on every rank and K2 not under the row mask."""
    import json
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run(
        [sys.executable, '-m', 'bsvd_tpu_torch.parallel.dryrun', '--nproc',
         '2', '--data', '1', '--spatial', '2', '--backend', 'gloo',
         '--device', 'cuda', '--checks', 'eval,train', '--timeout', '500'],
        cwd=root, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out['dryrun'] == 'ok' and len(out['ranks']) == 2
    for rank in out['ranks']:
        ev = rank['eval']['float32']
        assert ev['launches']['conv_chain'] == 0
        assert all(ev['launches'][k] > 0 for k in ('conv3x3', 'conv_s2',
                                                   'conv_ps'))
        (tr,) = rank['train']
        assert tr['ranks_identical'] and tr['launches']['conv3x3_dw'] > 0


def test_bn_step_on_two_gloo_ranks_matches_unsharded(dev):
    """Two gloo ranks on cuda:0 (``parallel.dryrun --train_layouts
    bn:2x1 --size full``): two fp32 steps of the c64 net with norm 'bn' at
    8 x 11 x 96 x 96 a rank, its statistics the global batch's, held by the
    dryrun against the unsharded step on the card (losses, first-step
    gradients, parameters and running statistics, the same bits on both
    ranks; rank 0 runs the unsharded steps); K1, K3, K4 and K7 launched on
    each rank, K2 never, the norms' all-reduces run."""
    import json
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run(
        [sys.executable, '-m', 'bsvd_tpu_torch.parallel.dryrun', '--nproc',
         '2', '--data', '2', '--spatial', '1', '--backend', 'gloo',
         '--device', 'cuda', '--checks', 'train', '--train_layouts',
         'bn:2x1', '--size', 'full', '--timeout', '500'],
        cwd=root, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out['dryrun'] == 'ok' and len(out['ranks']) == 2
    assert 'running_stats_dev' in out['ranks'][0]['train'][0]
    for rank in out['ranks']:
        (tr,) = rank['train']
        got = tr['launches']
        assert tr['norm'] == 'bn' and tr['ranks_identical']
        assert min(tr['all_reduces_per_step']) > 0
        assert got['conv_chain'] == 0
        assert all(got[k] > 0 for k in ('conv_s2', 'conv_ps', 'conv3x3_dw'))
        assert got['conv3x3'] + got['shift_conv_fused_v1'] > 0


def test_over_budget_whole_clip_streams_on_the_card(dev, monkeypatch):
    """``denoise_seq`` of a whole clip over a lowered device budget runs
    the streaming route on the card (K5 launched) and gives the whole-clip
    MIMO output (fp32: 1e-4 x max(1, max|ref|))."""
    from bsvd_tpu_torch.archs.wnet_arch import WNetConfig, _map_tree, wnet_init
    from bsvd_tpu_torch.models import seq_inference
    from bsvd_tpu_torch.ops.bibuffer_conv import bibuffer_conv
    cfg = WNetConfig(chns=(16, 32, 64), mid_ch=16, interm_ch=16,
                     act='relu6')
    params = _map_tree(wnet_init(cfg, 3), lambda t: t.to(dev))
    seq = np.random.default_rng(4).uniform(0, 1, (6, 3, 24, 40)).astype(
        np.float32)
    ref = seq_inference.denoise_seq(params, cfg, seq, noise_sigma=0.1)
    monkeypatch.setattr(seq_inference, '_memory_budget',
                        lambda device, frac=0.8: 1.0)
    before = getattr(bibuffer_conv, 'launches', 0)
    got = seq_inference.denoise_seq(params, cfg, seq, noise_sigma=0.1)
    assert getattr(bibuffer_conv, 'launches', 0) > before
    _close(torch.from_numpy(got), torch.from_numpy(ref), torch.float32)


def test_kernel_routes_count_the_plain_routes_flops(dev):
    """profiler.flops_and_memory counts a wrapper's kernel launch as its
    plain route on the CPU counts it (one formula a wrapper, ops/_flops):
    K1-K5 and K7, bf16."""
    from bsvd_tpu_torch.ops.bibuffer_conv import bibuffer_conv
    from bsvd_tpu_torch.ops.conv3x3 import conv3x3_dw
    from bsvd_tpu_torch.profiler import flops_and_memory
    rng = np.random.default_rng(13)

    def t(*shape):
        return _t(rng, shape, 0.5, 'cpu')
    x, x2, dz = t(6, 13, 21, 64), t(6, 13, 21, 64), t(6, 13, 21, 64)
    w64, b64, w128 = t(64, 64, 3, 3), t(64), t(128, 64, 3, 3)
    w3, b3 = t(3, 64, 3, 3), t(3)
    ops = {
        'conv3x3': lambda d, v: conv3x3(v(x), v(w64), v(b64), x2=v(x2),
                                        t_len=3, shift='tsm'),
        'conv_chain': lambda d, v: conv_chain(v(x), v(w64), v(b64), v(w3),
                                              v(b3)),
        'conv_s2': lambda d, v: conv_s2(v(x), v(w128), v(t(128))),
        'conv_ps': lambda d, v: conv_ps(v(x), v(w128), v(t(128))),
        'bibuffer_conv': lambda d, v: bibuffer_conv(v(x[:2]), v(x2[:2]),
                                                    v(w64), v(b64)),
        'conv3x3_dw': lambda d, v: conv3x3_dw(v(x), v(dz), t_len=3,
                                              shift='causal'),
    }
    for name, op in ops.items():
        cpu = flops_and_memory(lambda: op('cpu', lambda a: a))['flops']
        # an argument on the card: the report's temp_size_in_bytes
        card = flops_and_memory(lambda _: op(dev, lambda a: a.to(
            dev, torch.bfloat16)), x.to(dev))
        assert cpu > 0 and card['flops'] == cpu, name
        assert card['temp_size_in_bytes'] >= 0


def _fixture_clips(tmp_path):
    """The CPU tests' three fixture kinds (tests/test_torch_video.py):
    name -> (path, NV12 of the writer's display planes)."""
    from tools import make_video_fixtures as mvf
    kinds = {'idr_p': (128, 96, dict(gop=8), {}),
             'cropped': (120, 96, dict(gop=5),
                         dict(chunk=5, co64=True, moov_first=True)),
             'bframes': (112, 90, dict(gop=6, bframes=True,
                                       profile=mvf.HIGH), dict(chunk=3))}
    out = {}
    for seed, (name, (w, h, kw, mux_kw)) in enumerate(kinds.items()):
        path = str(tmp_path / f'{name}.mp4')
        out[name] = (path, mvf.nv12(*mvf.write_clip(path, seed, w, h, 12,
                                                    **kw, **mux_kw)))
    return out


@pytest.fixture
def nvdec_dev(dev):
    """The card, where its NVDEC is exposed to this process. Skips only on
    NvdecNotExposed (cuvidGetDecoderCaps out of memory in a container
    whose NVIDIA_DRIVER_CAPABILITIES lacks 'video'); any other caps
    failure, 4:2:0 8-bit H.264 unsupported included, fails here."""
    from bsvd_tpu_torch.data import nvdec
    try:
        caps = nvdec.caps(dev)
    except nvdec.NvdecNotExposed as e:
        pytest.skip(str(e))
    assert caps['supported'] == 1, caps
    return dev


def test_nvdec_parser_gives_the_demuxers_display_order(dev, tmp_path):
    """libnvcuvid's parser (host code, no video engine) on the port's
    CUVID structs: from every start of each kind, its sequence matches
    the SPS (coded size, display area), it hands one picture a sample to
    decode and displays the samples' display indices in order."""
    from bsvd_tpu_torch.data import mp4_demux, nvdec
    for name, (path, _) in _fixture_clips(tmp_path).items():
        track = mp4_demux.open_track(path)
        for start in range(12):
            count = min(5, 12 - start)
            first, last = track.window_samples(start, count)
            fed = track.disp_index[first:last + 1]
            got = nvdec.parse(track, start, count)
            assert got['decoded'] == len(fed), (name, start)
            assert got['shown'] == sorted(fed.tolist()), (name, start)
            assert got['window'], (name, start)


def test_nvdec_planes_equal_the_writers_from_every_start(nvdec_dev,
                                                         tmp_path):
    """NVDEC's NV12 (data/nvdec.py, the port's CUVID binding) equals the
    fixture writer's planes bit for bit: every display frame of each
    kind, from every start (so every seek)."""
    from bsvd_tpu_torch.data import mp4_demux, nvdec
    dev = nvdec_dev
    for name, (path, want) in _fixture_clips(tmp_path).items():
        track = mp4_demux.open_track(path)
        want = torch.from_numpy(want).to(dev)
        dec = nvdec.Decoder(dev)
        try:
            for start in range(12):
                count = min(5, 12 - start)
                got = dec.decode(track, start, count)
                assert torch.equal(got, want[start:start + count]), \
                    (name, start)
        finally:
            dec.close()
        with pytest.raises(IOError, match='decode failed'):
            nvdec.Decoder(dev).decode(track, 10, 5)


@pytest.mark.parametrize('t,h,w', [(3, 90, 112), (11, 480, 854)])
def test_nv12_rgb_kernel_equals_plain(dev, t, h, w):
    """csrc/nv12_rgb.cu against data/yuv.py's plain version on the card,
    bit for bit, at odd and even window origins, and the launch count."""
    from bsvd_tpu_torch.data.yuv import nv12_to_rgb, nv12_to_rgb_plain
    rng = np.random.default_rng(t)
    nv12 = torch.from_numpy(rng.integers(
        0, 256, (t, h * 3 // 2, w), dtype=np.uint8)).to(dev)
    before = nv12_to_rgb.launches
    cases = [(0, 0, h, w), (1, 1, 33, 47), (0, 1, 32, 48), (1, 0, 31, 45),
             (h - 40, w - 50, 40, 50)]
    for y0, x0, ch, cw in cases:
        got = nv12_to_rgb(nv12, y0, x0, ch, cw)
        assert got.shape == (t, ch, cw, 3) and got.dtype == torch.uint8
        assert torch.equal(got, nv12_to_rgb_plain(nv12, y0, x0, ch, cw))
        assert torch.equal(got.cpu(), nv12_to_rgb_plain(nv12.cpu(), y0, x0,
                                                        ch, cw))
    assert nv12_to_rgb.launches == before + len(cases)


def test_mp4_refusals_name_their_cause(nvdec_dev):
    """No CPU decoder; cuvidGetDecoderCaps names an H.264 format NVDEC
    does not decode; 4:2:0 8-bit is decoded."""
    from bsvd_tpu_torch.data import nvdec
    dev = nvdec_dev
    with pytest.raises(NotImplementedError, match='NVDEC'):
        nvdec.require('cpu')
    assert nvdec.caps(dev)['supported'] == 1
    refused = []
    for chroma, depth in ((3, 8), (2, 8), (1, 10)):
        try:
            nvdec.caps(dev, chroma, depth)
        except nvdec.NvdecError as e:
            refused.append(str(e))
    assert any('cuvidGetDecoderCaps' in r for r in refused), refused


@pytest.mark.parametrize('dtype,chns,interm', [
    (torch.float32, (64, 32, 64), 320), (torch.float32, (256, 32, 64), 16),
    (torch.bfloat16, (64, 32, 64), 320), (torch.bfloat16, (256, 32, 64),
                                          16)],
    ids=['fp32_inc320', 'fp32_outc256', 'bf16_inc320', 'bf16_outc256'])
def test_wide_chains_run_as_two_k1_on_the_card(dev, dtype, chns, interm):
    """A chain too wide for K2 (``conv_chain.fits``) runs as two K1
    launches: K2 launches only at the sites that fit (2 of the 4), the
    rest through K1, and the forward equals the plain route on the CPU
    (fp32: 1e-4 x max|ref|; bf16: above 30 dB PSNR against the fp32 plain
    forward of the same bf16 input, chip_smoke phase 4's kind of rule for
    a whole bf16 net)."""
    from bsvd_tpu_torch.archs.wnet_arch import (WNetConfig, prepare_params,
                                                wnet_apply, wnet_init)
    cfg = WNetConfig(chns=chns, mid_ch=16, interm_ch=interm, norm='none',
                     act='relu6')
    raw = wnet_init(cfg, seed=5)
    x = torch.rand((1, 2, 24, 40, 4), generator=torch.Generator()
                   .manual_seed(5)).to(dtype)
    k2, k1 = conv_chain.launches, conv3x3.launches
    got = wnet_apply(prepare_params(raw, dev, dtype), x.to(dev), cfg)
    torch.cuda.synchronize()
    assert conv_chain.launches - k2 == 2
    assert conv3x3.launches - k1 == 16 + 2 * 2
    ref = wnet_apply(prepare_params(raw, 'cpu', torch.float32), x.float(),
                     cfg)
    if dtype == torch.float32:
        _close(got.cpu(), ref, dtype)
    else:
        mse = ((got.cpu().float().clamp(0, 1) - ref.clamp(0, 1)) ** 2).mean()
        assert 10 * np.log10(1 / max(mse.item(), 1e-20)) > 30


# ---------------------------------------------------------------------------
# the face GANs: one step on the card against the same step on the CPU
# ---------------------------------------------------------------------------

def _capture_grads(optim, into):
    step = optim.step

    def capture():
        into.update({n: (torch.zeros_like(p) if p.grad is None
                         else p.grad).detach().cpu().clone()
                     for n, p in zip(optim.names, optim.params)})
        step()
    optim.step = capture


def _grads_close(card, cpu, exact):
    """The card's fp32 gradients no further from the CPU's float64 ones
    than twice the CPU's fp32 gradients are, plus 1e-5 x the net's
    largest |g| (fp32's own distance from exact grows with depth and with
    instance norm over few pixels: 4.5e-3 x max|g| on the CPU for
    HiFaceGAN's LIP encoder at 64 x 64)."""
    scale = max(float(g.abs().max()) for g in exact.values())
    for name, g in exact.items():
        own = float((cpu[name].double() - g).abs().max())
        err = float((card[name].double() - g).abs().max())
        assert err <= 2 * own + 1e-5 * scale, (name, err, own, scale)


def _face_gan_models(opt, dev):
    """The model on the CPU in fp32, on the CPU in float64 (its nets
    converted after the build) and on the card, with the same weights;
    each optimizer keeps the gradients of its step."""
    from bsvd_tpu_torch.models.base_model import build_model
    models = [build_model(copy.deepcopy(opt), device=d)
              for d in ('cpu', 'cpu', dev)]
    models[1].net.double()
    models[1].net_d.double()
    grads = [({}, {}) for _ in models]
    for m, (g, d) in zip(models, grads):
        _capture_grads(m.optimizer, g)
        _capture_grads(m.optimizer_d, d)
    return models, grads


def _losses_close(card, exact, tol=1e-4):
    for k, v in exact.items():
        assert abs(card[k] - v) <= tol * abs(v), (k, card, exact)


def _face_gan_opt(tmp_path, model_type, net_g, net_d, train):
    return {'name': model_type, 'model_type': model_type, 'is_train': True,
            'num_gpu': 1, 'manual_seed': 0, 'scale': 1,
            'network_g': net_g, 'network_d': net_d, 'logger': {},
            'path': {'models': str(tmp_path / 'm'),
                     'training_states': str(tmp_path / 's')},
            'train': train}


def test_hifacegan_step_on_the_card_matches_cpu(dev, tmp_path):
    """One HiFaceGANModel step (num_feat 4, 64 x 64, batch 2; pixel, GAN,
    feature matching) in fp32 with TF32 off against the same step on the
    CPU in float64: the logged losses within 1e-4 x |ref|, G's and D's
    gradients by ``_grads_close``, D's stored u vectors within 1e-5."""
    opt = _face_gan_opt(
        tmp_path, 'HiFaceGANModel',
        {'type': 'HiFaceGAN', 'num_feat': 4, 'is_train': False},
        {'type': 'HiFaceGANDiscriminator', 'num_d': 2, 'n_layers_d': 3,
         'num_feat': 8},
        {'optim_g': {'type': 'Adam', 'lr': 1e-3},
         'optim_d': {'type': 'Adam', 'lr': 4e-3},
         'pixel_opt': {'type': 'L1Loss', 'loss_weight': 1.0},
         'gan_opt': {'type': 'MultiScaleGANLoss', 'gan_type': 'lsgan'},
         'feature_matching_opt': {'type': 'GANFeatLoss',
                                  'loss_weight': 10.0}})
    models, grads = _face_gan_models(opt, dev)
    rng = np.random.default_rng(5)
    batch = {k: rng.uniform(0, 1, (2, 3, 64, 64)).astype(np.float32)
             for k in ('lq', 'gt')}
    for i, m in enumerate(models):
        m.feed_data(batch)
        if i == 1:
            m.lq, m.gt = m.lq.double(), m.gt.double()
        m.optimize_parameters(1)
    cpu, exact, card = models
    assert list(card.get_current_log()) == list(exact.get_current_log())
    _losses_close(card.get_current_log(), exact.get_current_log())
    for net in (0, 1):
        _grads_close(grads[2][net], grads[0][net], grads[1][net])
    want = exact.net_d.state_dict()
    for k, v in card.net_d.state_dict().items():
        if k.endswith('weight_u'):
            assert (v.cpu().double() - want[k]).abs().max() <= 1e-5, k


def test_stylegan2_g_path_step_on_the_card_matches_cpu(dev, tmp_path):
    """One StyleGAN2Model iteration with both regularisers (d+r1, then
    g+path; out_size 32, narrow 0.25, batch 4) on the same draws (made on
    the CPU, fed to every model's ``draws_d`` / ``draws_g``) against the
    same iteration on the CPU in float64: the losses within 1e-4 x |ref|,
    both nets' gradients by ``_grads_close``, the mean path length within
    1e-4 x |ref|."""
    nets = {'type': 'StyleGAN2Generator', 'out_size': 32,
            'num_style_feat': 16, 'num_mlp': 2, 'narrow': 0.25}
    opt = _face_gan_opt(
        tmp_path, 'StyleGAN2Model', nets,
        {'type': 'StyleGAN2Discriminator', 'out_size': 32, 'narrow': 0.25},
        {'optim_g': {'type': 'Adam', 'lr': 2e-3},
         'optim_d': {'type': 'Adam', 'lr': 2e-3},
         'gan_opt': {'type': 'GANLoss', 'gan_type': 'wgan_softplus'},
         'r1_reg_weight': 10, 'path_reg_weight': 2, 'net_g_reg_every': 1,
         'net_d_reg_every': 1, 'mixing_prob': 0.9})
    models, grads = _face_gan_models(opt, dev)
    with torch.no_grad():
        for p in models[0].net.parameters():
            if p.ndim == 1:                    # noise strengths, biases
                p.add_(0.1)
        for m in models[1:]:
            m.net.load_state_dict(models[0].net.state_dict())
    draws = (models[0].draws_d(4), models[0].draws_g(4, True))
    rng = np.random.default_rng(6)
    real = rng.uniform(-1, 1, (4, 3, 32, 32)).astype(np.float32)

    def to(v, m, dtype):
        if isinstance(v, list):
            return [to(t, m, dtype) for t in v]
        return v.to(m.device, dtype)
    for i, m in enumerate(models):
        dtype = torch.float64 if i == 1 else torch.float32
        on_d = {k: to(v, m, dtype) for k, v in draws[0].items()}
        on_g = {k: to(v, m, dtype) for k, v in draws[1].items()}
        m.draws_d = lambda b, d=on_d: d
        m.draws_g = lambda b, p, g=on_g: g
        m.feed_data({'gt': real})
        m.real_img = m.real_img.to(dtype)
        m.optimize_parameters(1)
    cpu, exact, card = models
    ref = exact.get_current_log()
    assert ref['l_d_r1'] > 0 and ref['l_g_path'] > 0
    _losses_close(card.get_current_log(), ref)
    for net in (0, 1):
        _grads_close(grads[2][net], grads[0][net], grads[1][net])
    mpl = float(exact.mean_path_length)
    assert abs(float(card.mean_path_length) - mpl) <= 1e-4 * abs(mpl)


def test_modulated_deform_conv_on_the_card_matches_cpu(dev):
    """``ops/deform_conv.modulated_deform_conv`` at EDVR-M's level-1 shape
    in training (batch 4, 64 channels, 64 x 64, 8 deformable groups,
    offsets up to 4 px, past every border), forward and the gradients of
    x, offset, mask and weight: the card's fp32 (TF32 off) against the
    CPU's float64, within twice the CPU fp32's own distance plus 1e-5 x
    max|ref| (``grid_sample``'s CUDA backward adds with atomics, in no
    fixed order)."""
    from bsvd_tpu_torch.ops.deform_conv import modulated_deform_conv
    rng = np.random.default_rng(11)
    n, c, h, w, dg = 4, 64, 64, 64, 8
    ins = {'x': rng.uniform(-1, 1, (n, c, h, w)),
           'offset': rng.uniform(-4, 4, (n, dg * 18, h, w)),
           'mask': rng.uniform(0, 1, (n, dg * 9, h, w)),
           'weight': rng.standard_normal((c, c, 3, 3)) / 24}
    bias = torch.from_numpy(rng.standard_normal(c).astype(np.float32))
    cot = rng.standard_normal((n, c, h, w))
    runs = []
    for device, dtype in (('cpu', torch.float32), ('cpu', torch.float64),
                          (dev, torch.float32)):
        t = {k: torch.tensor(v, dtype=dtype, device=device,
                             requires_grad=True) for k, v in ins.items()}
        out = modulated_deform_conv(t['x'], t['offset'], t['mask'],
                                    t['weight'], bias.to(device, dtype),
                                    deformable_groups=dg)
        out.backward(torch.tensor(cot, dtype=dtype, device=device))
        runs.append({'out': out.detach()} | {k: v.grad
                                              for k, v in t.items()})
    cpu, exact, card = runs
    for k, ref in exact.items():
        own = float((cpu[k].double() - ref).abs().max())
        err = float((card[k].cpu().double() - ref).abs().max())
        assert err <= 2 * own + 1e-5 * float(ref.abs().max()), (k, err, own)


@pytest.mark.parametrize('pool', ['edvr_tsa', 'hifacegan_excl'])
@pytest.mark.parametrize('layout', ['contiguous', 'channels_last'])
def test_avg_pools_on_the_card_match_cpu_in_any_layout(dev, pool, layout):
    """The port's padded 3 x 3 stride-2 average pools (EDVR's TSA, the
    padding counted; HiFaceGAN's, not), forward and backward, on the
    card against the CPU within 1e-5 x max|ref|, on a contiguous and on
    a channels-last input. PyTorch 2.11's CUDA ``F.avg_pool2d`` backward
    of a channels-last tensor at these settings is 90-100% of max|ref|
    off, which reached EDVR-M's gradients through TSA (7-11% in L2 at
    batch 2); the port pools a contiguous copy."""
    from bsvd_tpu_torch.archs.edvr_arch import _avg_pool_3s2
    from bsvd_tpu_torch.archs.hifacegan_arch import avg_pool_excl
    fn = _avg_pool_3s2 if pool == 'edvr_tsa' else avg_pool_excl
    fmt = (torch.channels_last if layout == 'channels_last'
           else torch.contiguous_format)
    rng = np.random.default_rng(12)
    x0 = torch.from_numpy(rng.standard_normal((2, 64, 16, 16)).astype(
        np.float32))
    gy = torch.from_numpy(rng.standard_normal((2, 64, 8, 8)).astype(
        np.float32))
    runs = []
    for device in ('cpu', dev):
        x = x0.clone().to(device).to(memory_format=fmt).requires_grad_()
        y = fn(x)
        y.backward(gy.to(device))
        runs.append((y.detach().cpu(), x.grad.cpu()))
    for got, ref in zip(runs[1], runs[0]):
        err = float((got - ref).abs().max())
        assert err <= 1e-5 * float(ref.abs().max()), (pool, layout, err)


# ----------------------------------------------------- cv2_ops on the card
def _cv2_cases(rng):
    """(name, fn, input) at the callers' shapes: face_util's upscale,
    warps, erosion and feathering; prepare_hifacegan's resizes, blurs and
    motion filter; NIQE's gray."""
    from bsvd_tpu_torch.utils import cv2_ops as co
    from bsvd_tpu_torch.utils.face_util import umeyama_similarity
    u8 = torch.from_numpy(rng.integers(0, 256, (200, 232, 3),
                                       dtype=np.uint8))
    f32 = torch.from_numpy(rng.random((200, 232, 3)).astype(np.float32))
    tmpl = np.array([[686.77, 488.62], [586.77, 493.59], [337.91, 488.39],
                     [437.95, 493.51], [513.58, 678.50]]) / 8
    lm = tmpl * 1.4 + rng.uniform(10, 30, (1, 2))
    fwd, inv = umeyama_similarity(lm, tmpl), umeyama_similarity(tmpl, lm * 2)
    kern = np.zeros((13, 13), np.float32)
    kern[6] = 1.0
    kern = co.warp_affine(torch.from_numpy(kern),
                          co.get_rotation_matrix_2d((6, 6), 37.0, 1.0),
                          (13, 13))
    kern = kern / kern.sum()
    return [
        ('resize_linear_x2', lambda x: co.resize(x, (464, 400)), u8),
        ('resize_area_4', lambda x: co.resize(x, (58, 50), co.INTER_AREA),
         u8),
        ('resize_area_frac', lambda x: co.resize(x, (41, 37), co.INTER_AREA),
         u8),
        ('resize_cubic', lambda x: co.resize(x, (232, 200), co.INTER_CUBIC),
         u8[:50, :58].contiguous()),
        ('warp_u8', lambda x: co.warp_affine(x, fwd, (128, 128)), u8),
        ('warp_back_u8', lambda x: co.warp_affine(x, inv, (464, 400)), u8),
        ('warp_f32', lambda x: co.warp_affine(x, inv, (464, 400)), f32),
        ('erode_f32', lambda x: co.erode(x, np.ones((4, 4), np.uint8)), f32),
        ('gauss_u8', lambda x: co.gaussian_blur(x, (19, 19), 3.1), u8),
        ('gauss_f32', lambda x: co.gaussian_blur(x, (51, 51), 0), f32),
        ('filter2d_u8', lambda x: co.filter2d(x, -1, kern), u8),
        ('gray_f32', lambda x: co.cvt_color(x, co.COLOR_BGR2GRAY), f32),
    ]


def test_cv2_ops_on_the_card_equal_cpu(dev):
    """Every operation on a CUDA tensor equals the same call on the CPU:
    uint8 bit for bit, float32 within 1e-5 (the fused multiply-adds are
    computed in float64 on both)."""
    rng = np.random.default_rng(20)
    for name, fn, x in _cv2_cases(rng):
        ref = fn(x)
        got = fn(x.to(dev))
        assert got.device.type == 'cuda', name
        if ref.dtype == torch.uint8:
            assert torch.equal(got.cpu(), ref), name
        else:
            err = (got.cpu() - ref).abs().max().item()
            assert err <= 1e-5, (name, err)


def test_dfdnet_on_the_card_matches_cpu(dev):
    """DFDNet at full width on a 256 x 256 face: the same atoms as the
    CPU, the output within 1e-4 x max|ref| (last conv scaled down so the
    tanh does not saturate)."""
    from bsvd_tpu_torch.archs.dfdnet_arch import DFDNet
    rng = np.random.default_rng(21)
    sizes = {'256': (128, 8, 8), '128': (256, 6, 6), '64': (512, 4, 4),
             '32': (512, 3, 3)}
    face_dict = {s: {p: rng.standard_normal((3,) + v).astype(np.float32)
                     for p in ('left_eye', 'right_eye', 'nose', 'mouth')}
                 for s, v in sizes.items()}
    net = DFDNet(64, face_dict=face_dict, seed=3)
    with torch.no_grad():
        net.upsample4[4].weight.mul_(3e-5)
        net.upsample4[4].bias.mul_(3e-5)
    locs = [np.array([[64, 64, 128, 128]]), np.array([[160, 64, 224, 128]]),
            np.array([[96, 128, 160, 192]]), np.array([[96, 192, 160, 248]])]
    x = torch.from_numpy(rng.uniform(-1, 1, (1, 3, 256, 256)).astype(
        np.float32))
    card = copy.deepcopy(net).to(dev)
    with torch.no_grad():
        ref = net(x, locs)
        got = card(x.to(dev), locs).cpu()
    assert card.last_atoms == net.last_atoms
    _close(got, ref, torch.float32)


def test_hifacegan_templates_on_the_card_equal_cpu(dev):
    """Every prepare_hifacegan template on a card tensor equals the CPU's
    at the same seed, bit for bit."""
    from bsvd_tpu_torch.scripts.data_preparation import \
        prepare_hifacegan_dataset as prep
    rng = np.random.default_rng(22)
    gt = rng.integers(0, 256, (128, 128, 3), dtype=np.uint8)
    for deg in prep.DEG_TEMPLATES:
        a = prep.degrade(gt, deg, np.random.default_rng(5), device='cpu')
        b = prep.degrade(gt, deg, np.random.default_rng(5), device=dev)
        assert b.device.type == 'cuda'
        assert torch.equal(b.cpu(), a), deg


@pytest.mark.parametrize('family', ['p_partitions', 'weighted', 'slices'])
def test_mp4_loader_on_the_card_equals_the_cpu_loader(dev, tmp_path, family):
    """train_video_loader over a folder of host-decoded CAVLC clips
    (tools/make_h264_streams.py): on the card (the window's NV12 to the
    card, csrc/nv12_rgb.cu) its batches equal the CPU loader's (the plain
    conversion) bit for bit, one worker, the same seed, and the kernel
    launched once a window."""
    from bsvd_tpu_torch.data.video_train_loader import train_video_loader
    from bsvd_tpu_torch.data.yuv import nv12_to_rgb
    from tools import make_h264_streams as mhs
    folder = tmp_path / 'clips'
    folder.mkdir()
    for seed in (0, 1):
        mhs.write_stream(str(folder / f'{family}_{seed}.mp4'), family, seed)
    opt = {'trainset_dir': str(folder), 'batch_size_per_gpu': 2,
           'temp_patch_size': 5, 'patch_size': [24, 40],
           'max_number_patches': 6, 'noise_ival': [5, 55],
           'noise_shape': 'NF', 'num_workers': 1, 'manual_seed': 7}
    batches = {}
    for device in ('cpu', 'cuda'):
        before = nv12_to_rgb.launches
        loader = train_video_loader(dict(opt, device=device))
        try:
            batches[device] = list(loader)
        finally:
            loader.close()
        launched = nv12_to_rgb.launches - before
        assert (launched >= 6) if device == 'cuda' else launched == 0
    assert len(batches['cpu']) == len(batches['cuda']) == 3
    for a, b in zip(batches['cuda'], batches['cpu']):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])


def test_mp4_loader_converts_on_the_builders_card(dev, tmp_path,
                                                  monkeypatch):
    """Built after set_device(1) with device 'cuda' (a second rank under
    torchrun), the loader's worker threads send every window to card 1 and
    convert it there with csrc/nv12_rgb.cu; its batches equal the CPU
    loader's."""
    if torch.cuda.device_count() < 2:
        pytest.skip('needs two CUDA devices')
    from bsvd_tpu_torch.data import video_train_loader as vtl
    from bsvd_tpu_torch.data import yuv
    from tools import make_h264_streams as mhs
    folder = tmp_path / 'clips'
    folder.mkdir()
    mhs.write_stream(str(folder / 'clip.mp4'), 'p_partitions', 0)
    seen, convert = [], yuv.nv12_to_rgb

    def watched(nv12, *args):
        out = convert(nv12, *args)
        seen.append((nv12.device, out.device, torch.cuda.current_device()))
        return out
    watched.launches = 0      # the kernel counts its launches here now
    monkeypatch.setattr(yuv, 'nv12_to_rgb', watched)
    opt = {'trainset_dir': str(folder), 'batch_size_per_gpu': 2,
           'temp_patch_size': 5, 'patch_size': [24, 40],
           'max_number_patches': 6, 'noise_ival': [5, 55],
           'noise_shape': 'NF', 'num_workers': 1, 'manual_seed': 7}
    batches = {}
    for device in ('cpu', 'cuda'):
        seen.clear()
        previous = torch.cuda.current_device()
        torch.cuda.set_device(1)
        try:
            loader = vtl.train_video_loader(dict(opt, device=device))
        finally:
            torch.cuda.set_device(previous)
        try:
            batches[device] = list(loader)
        finally:
            loader.close()
    one = torch.device('cuda', 1)
    assert len(seen) >= 6 and all(s == (one, one, 1) for s in seen), seen
    assert watched.launches == len(seen)
    for a, b in zip(batches['cuda'], batches['cpu']):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
