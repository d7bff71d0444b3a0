"""The rest of the zoo's video family of the port against the JAX package
on the CPU, on the same seeded numpy inputs:

- ``ops/deform_conv.modulated_deform_conv``: offsets of several pixels
  that send samples past every border, deformable groups 1 and 2, stride
  2, dilation 2, padding 2, an axis of one pixel, DCNv1 (no mask),
  whole-pixel offsets (zero among them, where the gradient in the
  offset takes the right slope, as JAX's);
  forward and the gradients of x, offset, mask and weight against
  ``jax.vjp``; ``dcn_v2_pack_apply`` with a random non-zero
  ``conv_offset`` (a fresh pack's is zero, where any offset layout
  passes);
- ``EDVR`` (num_feat 8, deformable groups 2, 1 extract and 2
  reconstruction blocks): TSA at 64 x 64, without TSA at 48 x 80, TSA
  with predeblur at 180 x 320, predeblur with ``hr_in`` at 64 x 64 HR;
  every DCN pack's ``conv_offset`` random;
- ``TOFlow`` and ``DUF`` (16 layers, scale 4, and 28 layers at scale 2
  with the official eps), BatchNorm running statistics random;
- the weight carry both ways, strict: the port's seeded weights to the
  JAX tree (its structure and shapes held to ``jax.eval_shape`` of the
  JAX init) and back with ``from_jax_tree``, and a BasicSR-layout state
  dict saved as ``.pth`` through each class's ``load``; the registry
  names of the JAX package's ported files against the port's.

IconVSR is in tests/test_torch_iconvsr.py, the engines in
tests/test_torch_video_family_models.py and _gan.py, the data and the
inference script in tests/test_torch_video_family_data.py.

The JAX functions run under ``jax.jit`` on the port's weights carried
with ``to_jax_tree``.

Tolerances: deformable conv forward 1e-5 x max|ref| (the same corners
and weights as JAX's; fp32 summation order in the product), its
gradients 1e-4 x max|ref| of each (the scatter-add of the samples'
gradients sums in another order than XLA's); the nets 1e-4 x max|ref|
(fp32 summation order through a dozen deformable convs, the attention's
sigmoid and the softmaxed DUF filters).
"""

import functools

import numpy as np
import pytest
import torch

from bsvd_tpu_torch.archs import build_network
from bsvd_tpu_torch.convert.torch_generic import from_jax_tree, to_jax_tree
from bsvd_tpu_torch.ops import deform_conv as pdc
from bsvd_tpu_torch.ops.deform_conv import DCNv2Pack
from torch_threads import one_torch_thread  # noqa: F401

jax = pytest.importorskip('jax')
jnp = pytest.importorskip('jax.numpy')

NET_REL = 1e-4


def _x(shape, seed, lo=0.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


def _close(got, ref, rel):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = float(np.abs(got - ref).max())
    assert err <= rel * float(np.abs(ref).max()), (
        err, float(np.abs(ref).max()))


def _nhwc(a):
    return jnp.asarray(np.moveaxis(a, 1, -1))


def _nchw(a):
    return np.moveaxis(np.asarray(a), -1, 1)


# ---------------------------------------------------------------------------
# deformable convolution
# ---------------------------------------------------------------------------

# (N, C, H, W, Cout, k, stride, padding, dilation, dg, mask)
DCN_CASES = {
    'dg1': (2, 4, 7, 9, 5, 3, 1, 1, 1, 1, True),
    'dg2_stride2': (1, 4, 9, 8, 3, 3, 2, 1, 1, 2, True),
    'dg2_dil2_pad2': (1, 6, 8, 7, 4, 3, 1, 2, 2, 2, True),
    'one_px_row': (1, 4, 1, 9, 3, 3, 1, 1, 1, 2, True),
    'one_px_col': (2, 2, 6, 1, 2, 3, 1, 1, 1, 1, True),
    'dcnv1_k5': (1, 3, 6, 6, 2, 5, 1, 2, 1, 1, False),
    # whole-pixel offsets, zero among them (a fresh pack's): the offset's
    # gradient takes the right slope there, as JAX's floor corners do
    'integer_offsets': (2, 4, 7, 9, 5, 3, 1, 1, 1, 2, True),
}


def _dcn_inputs(case, seed):
    n, c, h, w, cout, k, stride, pad, dil, dg, with_mask = case
    ho = (h + 2 * pad - dil * (k - 1) - 1) // stride + 1
    wo = (w + 2 * pad - dil * (k - 1) - 1) // stride + 1
    x = _x((n, c, h, w), seed, -2, 2)
    # offsets up to 4 px: samples past every border
    off = _x((n, dg * 2 * k * k, ho, wo), seed + 1, -4, 4)
    mask = _x((n, dg * k * k, ho, wo), seed + 2) if with_mask else None
    wt = _x((cout, c, k, k), seed + 3, -0.5, 0.5)
    b = _x((cout,), seed + 4, -0.5, 0.5)
    return x, off, mask, wt, b, (stride, pad, dil, dg)


@pytest.mark.parametrize('name', sorted(DCN_CASES))
def test_modulated_deform_conv_matches_jax(name):
    from bsvd_tpu.ops.deform_conv import modulated_deform_conv as jdcn
    x, off, mask, wt, b, (stride, pad, dil, dg) = _dcn_inputs(
        DCN_CASES[name], 10)
    if name == 'integer_offsets':
        off = np.round(off)
    tx, toff, twt = (torch.from_numpy(a).requires_grad_()
                     for a in (x, off, wt))
    tmask = None if mask is None else torch.from_numpy(
        mask).requires_grad_()
    got = pdc.modulated_deform_conv(tx, toff, tmask, twt,
                                    torch.from_numpy(b), stride, pad, dil,
                                    dg)
    cot = _x(tuple(got.shape), 20, -1, 1)
    got.backward(torch.from_numpy(cot))

    def f(x_, off_, mask_, w_):
        return jdcn(x_, off_, mask_, w_, jnp.asarray(b), stride, pad, dil,
                    dg)
    args = (_nhwc(x), _nhwc(off), None if mask is None else _nhwc(mask),
            jnp.asarray(np.transpose(wt, (2, 3, 1, 0))))
    ref, vjp = jax.vjp(jax.jit(f), *args)
    _close(got, _nchw(ref), 1e-5)
    gx, goff, gmask, gw = vjp(_nhwc(cot))
    _close(tx.grad, _nchw(gx), 1e-4)
    _close(toff.grad, _nchw(goff), 1e-4)
    if mask is not None:
        _close(tmask.grad, _nchw(gmask), 1e-4)
    _close(twt.grad, np.transpose(np.asarray(gw), (3, 2, 0, 1)), 1e-4)


def test_zero_offset_is_the_plain_conv():
    x, _, _, wt, b, _ = _dcn_inputs(DCN_CASES['dg1'], 11)
    n, _, h, w = x.shape
    got = pdc.modulated_deform_conv(
        torch.from_numpy(x), torch.zeros(n, 18, h, w), torch.ones(n, 9, h, w),
        torch.from_numpy(wt), torch.from_numpy(b))
    ref = torch.nn.functional.conv2d(torch.from_numpy(x), torch.from_numpy(wt),
                                     torch.from_numpy(b), 1, 1)
    _close(got, ref.numpy(), 1e-5)


def _random_offsets(module, seed, scale=3.0):
    """Every DCN pack's conv_offset random: offsets of a few pixels."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, DCNv2Pack):
                w = m.conv_offset.weight
                w.copy_(torch.randn(w.shape, generator=gen) * scale
                        / w[0].numel() ** 0.5)
                m.conv_offset.bias.copy_(torch.randn(
                    m.conv_offset.bias.shape, generator=gen))


@pytest.mark.parametrize('dg', [1, 2])
def test_dcn_v2_pack_matches_jax(dg):
    from bsvd_tpu.ops.deform_conv import dcn_v2_pack_apply as jpack
    pack = DCNv2Pack(4, 6, deformable_groups=dg)
    torch.nn.init.normal_(pack.weight, std=0.3)
    _random_offsets(pack, 3)
    x, feat = _x((2, 4, 8, 10), 30, -1, 1), _x((2, 4, 8, 10), 31, -1, 1)
    with torch.no_grad():
        got = pack(torch.from_numpy(x), torch.from_numpy(feat))
    tree = to_jax_tree(pack)
    assert set(tree) == {'w', 'b', 'conv_offset'}
    ref = jax.jit(functools.partial(jpack, deformable_groups=dg))(
        jax.tree.map(jnp.asarray, tree), _nhwc(x), _nhwc(feat))
    _close(got, _nchw(ref), 1e-5)


# ---------------------------------------------------------------------------
# nets: the carry and the forwards
# ---------------------------------------------------------------------------

def _shapes(tree):
    return jax.tree.map(lambda a: tuple(np.shape(a)), dict(tree))


def _carried(opt, init, prepare=None, seed=1):
    """A port net with seeded weights (``prepare`` edits them), its JAX
    tree (shapes held to ``init``'s), loaded back strictly into a second
    port net."""
    net = build_network(dict(opt, seed=seed), 'cpu').eval()
    if prepare is not None:
        prepare(net)
    tree = to_jax_tree(net)
    assert _shapes(tree) == _shapes(jax.eval_shape(init,
                                                   jax.random.PRNGKey(0)))
    again = build_network(dict(opt, seed=seed + 7), 'cpu').eval()
    again.load_state_dict(from_jax_tree(tree, again), strict=True)
    for k, v in net.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k
    return again, jax.tree.map(jnp.asarray, tree)


def _pth_round_trip(net, opt, tmp_path):
    """A BasicSR-layout state dict under 'params' in a .pth, through the
    class's ``load`` into a fresh net: the same state."""
    path = str(tmp_path / 'net.pth')
    torch.save({'params': net.state_dict()}, path)
    fresh = build_network(dict(opt, seed=99), 'cpu').load(path)
    for k, v in net.state_dict().items():
        assert torch.equal(fresh.state_dict()[k].to(v.dtype), v), k


EDVR_SMALL = {'type': 'EDVR', 'num_feat': 8, 'deformable_groups': 2,
              'num_extract_block': 1, 'num_reconstruct_block': 2}
# name: (options, T, LQ H, W)
EDVR_CASES = {
    'tsa_64': ({}, 5, 64, 64),
    'no_tsa_48x80': ({'with_tsa': False}, 3, 48, 80),
    'predeblur_tsa_180x320': ({'with_predeblur': True}, 3, 180, 320),
    'predeblur_hr_in_64': ({'with_predeblur': True, 'hr_in': True}, 3, 64,
                           64),
}


@pytest.mark.parametrize('name', sorted(EDVR_CASES))
def test_edvr_matches_jax(name, tmp_path):
    from bsvd_tpu.archs import edvr_arch as je
    over, t, h, w = EDVR_CASES[name]
    opt = dict(EDVR_SMALL, num_frame=t, **over)
    init = functools.partial(
        je.edvr_init, num_feat=8, num_frame=t, deformable_groups=2,
        num_extract_block=1, num_reconstruct_block=2,
        with_tsa=opt.get('with_tsa', True),
        with_predeblur=opt.get('with_predeblur', False),
        hr_in=opt.get('hr_in', False))
    net, tree = _carried(opt, init, functools.partial(_random_offsets,
                                                      seed=5))
    x = _x((1, t, 3, h, w), 40)
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    fn = jax.jit(functools.partial(
        je.edvr_apply, deformable_groups=2,
        with_tsa=opt.get('with_tsa', True), hr_in=opt.get('hr_in', False)))
    ref = fn(tree, jnp.asarray(np.moveaxis(x, 2, -1)))
    scale = 1 if opt.get('hr_in') else 4
    assert got.shape == (1, 3, h * scale, w * scale)
    _close(got, _nchw(ref), NET_REL)
    if name == 'tsa_64':
        _pth_round_trip(net, opt, tmp_path)


def _random_bn(net, seed=8):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(torch.randn(m.num_features,
                                                 generator=gen) * 0.1)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.copy_(torch.randn(m.num_features, generator=gen) * 0.1)


def test_toflow_matches_jax(tmp_path):
    from bsvd_tpu.archs import tof_arch as jt
    opt = {'type': 'TOFlow'}
    net, tree = _carried(opt, jt.toflow_init, _random_bn)
    x = _x((2, 7, 3, 32, 48), 42)
    net.train()                      # BN on running statistics all the same
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    ref = jax.jit(jt.toflow_apply)(tree, jnp.asarray(np.moveaxis(x, 2, -1)))
    _close(got, _nchw(ref), NET_REL)
    _pth_round_trip(net, opt, tmp_path)
    assert {'mean', 'std'} <= set(net.state_dict())


@pytest.mark.parametrize('layers,scale,official', [(16, 4, False),
                                                   (28, 2, True)])
def test_duf_matches_jax(layers, scale, official, tmp_path):
    from bsvd_tpu.archs import duf_arch as jd
    opt = {'type': 'DUF', 'scale': scale, 'num_layer': layers,
           'adapt_official_weights': official}
    init = functools.partial(jd.duf_init, scale=scale, num_layer=layers)
    net, tree = _carried(opt, init, _random_bn)
    x = _x((1, 7, 3, 12, 16), 43)
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    fn = jax.jit(functools.partial(jd.duf_apply, scale=scale,
                                   eps=1e-3 if official else 1e-5))
    ref = fn(tree, jnp.asarray(np.moveaxis(x, 2, -1)))
    assert got.shape == (1, 3, 12 * scale, 16 * scale)
    _close(got, _nchw(ref), NET_REL)
    if layers == 16:
        _pth_round_trip(net, opt, tmp_path)
        # the JAX package's own converter reads the port's state dict
        state = {k: v.numpy() for k, v in net.state_dict().items()}
        jtree = jd.convert_duf_state(state)
        assert _shapes(jtree) == _shapes(tree)


def test_dynamic_upsampling_filter_matches_jax():
    from bsvd_tpu.archs.duf_arch import dynamic_upsampling_filter as jduf
    from bsvd_tpu_torch.archs.duf_arch import dynamic_upsampling_filter
    x = _x((2, 3, 6, 7), 44)
    filt = _x((2, 25, 4, 6, 7), 45)
    got = dynamic_upsampling_filter(torch.from_numpy(x), torch.from_numpy(
        filt))
    ref = jduf(_nhwc(x), jnp.asarray(np.transpose(filt, (0, 3, 4, 1, 2))))
    _close(got, _nchw(ref), 1e-6)


def test_registry_names_match_jax():
    """Every class the JAX package registers in the files this family
    ports is registered in the port."""
    import importlib
    from bsvd_tpu.utils import registry as jreg

    import bsvd_tpu_torch.archs  # noqa: F401
    import bsvd_tpu_torch.data  # noqa: F401
    import bsvd_tpu_torch.models  # noqa: F401
    from bsvd_tpu_torch.utils import registry as preg
    files = {'ARCH_REGISTRY': ['archs.edvr_arch', 'archs.tof_arch',
                               'archs.duf_arch', 'archs.basicvsr_arch',
                               'archs.spynet_arch'],
             'MODEL_REGISTRY': ['models.video_base_model',
                                'models.video_gan_model',
                                'models.video_recurrent_model'],
             'DATASET_REGISTRY': ['data.vimeo90k_dataset',
                                  'data.video_test_dataset',
                                  'data.reds_dataset']}
    for reg, mods in files.items():
        names = set()
        for mod in mods:
            m = importlib.import_module(f'bsvd_tpu.{mod}')
            names |= {k for k, v in getattr(jreg, reg)._obj_map.items()
                      if getattr(v, '__module__', '') == m.__name__}
        assert names, reg
        port = getattr(preg, reg)
        for name in sorted(names):
            assert port.get(name).__name__ == name
