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


# ---- K5 bibuffer_conv / bibuffer_multi, K6 bibuffer_chain -------------------

_BI_CASES = {'c16_ragged': (13, 37, 16, 24, 16),     # scalar loader path
             'c128': (10, 20, 128, 128, 128)}         # 16-byte loader path


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('case', sorted(_BI_CASES))
@pytest.mark.parametrize('causal', [False, True])
@pytest.mark.parametrize('nf', [1, 2, 5])
def test_bibuffer_multi_kernel(dev, nf, causal, case, dtype):
    from bsvd_tpu_torch.ops.bibuffer_conv import (bibuffer_multi,
                                                  bibuffer_multi_reference)
    h, w, c, co, _ = _BI_CASES[case]
    rng = np.random.default_rng(7)
    x = _t(rng, (nf, h, w, c), 1.0, dev).to(dtype)
    st = _t(rng, (1, h, w, c), 1.0, dev).to(dtype)
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
def test_bibuffer_conv_kernel_streams(dev, causal, dtype):
    """F = 1 over N = 3 streams (the per-push form)."""
    from bsvd_tpu_torch.ops.bibuffer_conv import (bibuffer_conv,
                                                  bibuffer_conv_reference)
    rng = np.random.default_rng(8)
    x = _t(rng, (3, 12, 24, 64), 1.0, dev).to(dtype)
    st = _t(rng, x.shape, 1.0, dev).to(dtype)
    wt = _t(rng, (64, 64, 3, 3), (2 / (9 * 64)) ** 0.5, dev)
    b = _t(rng, (64,), 0.1, dev)
    y, ns = bibuffer_conv(x, st, wt, b, act='relu', causal=causal)
    torch.cuda.synchronize()
    ry, rs = bibuffer_conv_reference(x.float(), st.float(), wt, b,
                                     act='relu', causal=causal)
    _close(y, ry, dtype)
    assert torch.equal(ns.float(), rs)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('case', sorted(_BI_CASES))
@pytest.mark.parametrize('causal', [False, True])
def test_bibuffer_chain_kernel(dev, causal, case, dtype):
    from bsvd_tpu_torch.ops.bibuffer_conv import (bibuffer_chain,
                                                  bibuffer_chain_reference)
    h, w, c, c1, co = _BI_CASES[case]
    rng = np.random.default_rng(9)
    x = _t(rng, (2, h, w, c), 1.0, dev).to(dtype)
    s1 = _t(rng, x.shape, 1.0, dev).to(dtype)
    s2 = _t(rng, (2, h, w, c1), 1.0, dev).to(dtype)
    w1 = _t(rng, (c1, c, 3, 3), (2 / (9 * c)) ** 0.5, dev)
    b1 = _t(rng, (c1,), 0.1, dev)
    w2 = _t(rng, (co, c1, 3, 3), (2 / (9 * c1)) ** 0.5, dev)
    b2 = _t(rng, (co,), 0.1, dev)
    y, n1, n2 = bibuffer_chain(x, s1, s2, w1, b1, w2, b2, causal=causal)
    torch.cuda.synchronize()
    ry, r1, r2 = bibuffer_chain_reference(x.float(), s1.float(), s2.float(),
                                          w1, b1, w2, b2, causal=causal)
    _close(y, ry, dtype)
    assert torch.equal(n1.float(), r1)
    _close(n2, r2, dtype)


@pytest.mark.parametrize('batch', [1, 2])
@pytest.mark.parametrize('shift_mode', ['TSM', 'TSM_toFutureOnly'])
def test_stream_denoiser_kernels_match_plain_path(dev, shift_mode, batch):
    """A small net streamed on the card (push, push_block, flush) in fp32
    against the plain streaming path on the CPU, for 1 and 2 streams."""
    from bsvd_tpu_torch.archs.streaming import StreamDenoiser
    from bsvd_tpu_torch.archs.wnet_arch import (WNetConfig, prepare_params,
                                                wnet_init)
    cfg = WNetConfig(chns=(16, 32, 64), mid_ch=16, interm_ch=16,
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
             'cout3': (2, 12, 20, 64, 3, 'none', False)}


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
