"""The zoo's recurrent video-SR modules of the port against the JAX
package's on the CPU, on the same seeded numpy inputs:

- ``nn/warp``: ``grid_sample`` in every padding mode ('zeros', 'border',
  'reflection') and interpolation ('bilinear', 'nearest'), on random
  points, on the pixel grid, on the image's edges and past them, on
  half-pixel points (where nearest rounds half to even) and on one-pixel
  axes; ``flow_warp``; ``interpolate_bilinear`` in both corner modes,
  up and down; ``resize_flow`` by ratio and shape;
- ``SpyNet`` at 64 x 64 and at 24 x 40, where the coarsest flow is clamped
  to 1 x 1 (the JAX package's departure from BasicSR under 64 px);
- ``BasicVSR`` (num_feat 16, num_block 2) on 5 frames of 64 x 64, the
  weights carried to the JAX package with ``to_jax_tree`` (its structure
  and shapes held to ``jax.eval_shape`` of the JAX init) and back with
  ``from_jax_tree``, strict, SpyNet's constant buffers included;
- ``utils/flow_util``: ``.flo`` and quantised-image round trips across
  the packages, quantisation, the colour wheel;
- ``data_util.generate_frame_indices`` in every padding mode;
- ``REDSRecurrentDataset``, ``REDSDataset``, ``VideoRecurrentTestDataset``
  and ``VideoTestDataset`` item by item on a small clip tree, one clip's
  frames EXIF-turned by 180 degrees, with the same seed.

Tolerances: warps and resizes 1e-5 absolute on values in [-3, 3] (the
bilinear coordinates pass through F.grid_sample's [-1, 1] scale, a few
ulps); nearest sampling, indices, flow files, quantised flows and dataset
items the same bits; SpyNet's flow and BasicVSR's output within 2e-5 x
max|ref| (fp32 summation order through 30-odd convs; the JAX package's
own parity test with BasicSR allows 1e-3); the colour wheel 1e-6.
"""

import os

import numpy as np
import pytest
import torch

from exif_util import png_with, tiff

from bsvd_tpu_torch.archs import build_network
from bsvd_tpu_torch.convert.torch_generic import from_jax_tree, to_jax_tree
from bsvd_tpu_torch.data import build_dataset
from bsvd_tpu_torch.data.data_util import generate_frame_indices
from bsvd_tpu_torch.nn import warp
from bsvd_tpu_torch.utils import flow_util, img_util
from torch_threads import one_torch_thread  # noqa: F401

jax = pytest.importorskip('jax')
jnp = pytest.importorskip('jax.numpy')
cv2 = pytest.importorskip('cv2')


def _x(shape, seed, lo=0.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


def _nhwc(a):
    return jnp.asarray(np.moveaxis(a, 1, -1))


def _nchw(a):
    return np.moveaxis(np.asarray(a), -1, 1)


def _close(got, ref, atol=0.0, rel=0.0):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = float(np.abs(got - ref).max())
    assert err <= atol + rel * float(np.abs(ref).max()), (
        err, float(np.abs(ref).max()))


# ---------------------------------------------------------------------------
# warp
# ---------------------------------------------------------------------------

def _points(h, w, ho, wo, seed):
    """(1, 1, n, 2) points: random ones in and around the image, the
    pixel grid, its edges, half-pixels and points past every side."""
    rng = np.random.default_rng(seed)
    rand = np.stack([rng.uniform(-3, w + 2, (ho, wo)),
                     rng.uniform(-3, h + 2, (ho, wo))], -1)
    special = np.array([0.0, w - 1, h - 1, -0.5, 0.5, 1.5, 2.5, w - 1.5,
                        w - 0.5, w, -1.0, -1e-7, h - 1 + 1e-7, 3.0])
    xs, ys = np.meshgrid(special, special[::-1])
    pts = np.concatenate([rand.reshape(-1, 2),
                          np.stack([xs, ys], -1).reshape(-1, 2)])
    return pts[None, None].astype(np.float32)


@pytest.mark.parametrize('padding', warp.PADDING_MODES)
@pytest.mark.parametrize('interp', ['bilinear', 'nearest'])
@pytest.mark.parametrize('hw', [(6, 9), (1, 7), (5, 1)],
                         ids=['6x9', '1x7', '5x1'])
def test_grid_sample_matches_jax(padding, interp, hw):
    from bsvd_tpu.nn.warp import grid_sample as jgrid
    h, w = hw
    img = _x((1, 3, h, w), 1, -3, 3)
    pts = _points(h, w, 8, 8, 2)
    got = warp.grid_sample(torch.from_numpy(img), torch.from_numpy(pts),
                           interp, padding)
    ref = _nchw(jax.jit(jgrid, static_argnums=(2, 3))(
        _nhwc(img), jnp.asarray(pts), interp, padding))
    if interp == 'nearest':
        assert np.array_equal(got.numpy(), ref)
    else:
        _close(got, ref, atol=1e-5)


@pytest.mark.parametrize('padding', warp.PADDING_MODES)
@pytest.mark.parametrize('interp', ['bilinear', 'nearest'])
def test_flow_warp_matches_jax(padding, interp):
    from bsvd_tpu.nn.warp import flow_warp as jwarp
    x = _x((2, 4, 10, 12), 3, -3, 3)
    flow = _x((2, 10, 12, 2), 4, -4, 4)
    flow[0, :3] = np.round(flow[0, :3] * 2) / 2       # half-pixel moves
    flow[1, 0, 0] = 0.0
    got = warp.flow_warp(torch.from_numpy(x), torch.from_numpy(flow),
                         interp, padding)
    ref = _nchw(jax.jit(jwarp, static_argnums=(2, 3))(
        _nhwc(x), jnp.asarray(flow), interp, padding))
    if interp == 'nearest':
        assert np.array_equal(got.numpy(), ref)
    else:
        _close(got, ref, atol=1e-5)
    # a zero flow on zeros (where the JAX branches start) is zeros
    zeros = warp.flow_warp(torch.zeros(1, 4, 10, 12),
                           torch.zeros(1, 10, 12, 2), interp, padding)
    assert not zeros.any()


@pytest.mark.parametrize('align', [False, True])
@pytest.mark.parametrize('size', [(8, 14), (3, 5), (7, 9), (1, 1)])
def test_interpolate_and_resize_flow_match_jax(align, size):
    from bsvd_tpu.nn.warp import interpolate_bilinear as jinterp
    from bsvd_tpu.nn.warp import resize_flow as jresize
    x = _x((1, 4, 7, 9), 5, -3, 3)
    got = warp.interpolate_bilinear(torch.from_numpy(x), *size, align)
    ref = jax.jit(jinterp, static_argnums=(1, 2, 3))(_nhwc(x), *size, align)
    _close(got, _nchw(ref), atol=1e-5)
    flow = _x((2, 2, 7, 9), 6, -3, 3)
    for size_type, sizes in (('shape', size), ('ratio', (2.0, 0.5))):
        got = warp.resize_flow(torch.from_numpy(flow), size_type, sizes,
                               align_corners=align)
        ref = jax.jit(jresize, static_argnums=(1, 2, 3, 4))(
            _nhwc(flow), size_type, sizes, 'bilinear', align)
        _close(got, _nchw(ref), atol=1e-5)
    with pytest.raises(ValueError, match='ratio or shape'):
        warp.resize_flow(torch.from_numpy(flow), 'scale', (2, 2))


# ---------------------------------------------------------------------------
# SpyNet, BasicVSR
# ---------------------------------------------------------------------------

def _carried(opt, init, seed=1):
    """A port net with seeded weights, and its JAX tree (shapes held to
    ``init``'s), loaded back strictly into a second port net."""
    net = build_network(dict(opt, seed=seed), 'cpu').eval()
    tree = to_jax_tree(net)
    want = jax.eval_shape(init, jax.random.PRNGKey(0))
    shapes = jax.tree.map(lambda a: tuple(np.shape(a)), dict(tree))
    assert shapes == jax.tree.map(lambda a: tuple(a.shape), dict(want))
    again = build_network(dict(opt, seed=seed + 7), 'cpu').eval()
    again.load_state_dict(from_jax_tree(tree, again), strict=True)
    return again, jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize('hw', [(64, 64), (24, 40)], ids=['64', 'clamp'])
def test_spynet_matches_jax(hw):
    from bsvd_tpu.archs.spynet_arch import spynet_apply, spynet_init
    net, tree = _carried({'type': 'SpyNet'}, spynet_init)
    ref_img = _x((2, 3) + hw, 7)
    supp = np.clip(ref_img + _x(ref_img.shape, 8, -0.05, 0.05), 0, 1)
    with torch.no_grad():
        got = net(torch.from_numpy(ref_img), torch.from_numpy(supp))
    ref = jax.jit(spynet_apply)(tree, _nhwc(ref_img), _nhwc(supp))
    _close(got, _nchw(ref), rel=2e-5)
    assert {'mean', 'std'} <= set(net.state_dict())


def test_basicvsr_matches_jax():
    import functools
    from bsvd_tpu.archs.basicvsr_arch import basicvsr_apply, basicvsr_init
    opt = {'type': 'BasicVSR', 'num_feat': 16, 'num_block': 2}
    net, tree = _carried(opt, functools.partial(basicvsr_init, num_feat=16,
                                                num_block=2))
    x = _x((1, 5, 3, 64, 64), 9)
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    fn = jax.jit(functools.partial(basicvsr_apply, num_feat=16))
    ref = fn(tree, jnp.asarray(np.moveaxis(x, 2, -1)))
    assert got.shape == (1, 5, 3, 256, 256)
    _close(got, np.moveaxis(np.asarray(ref), -1, 2), rel=2e-5)
    # a BasicSR-layout state dict (constant buffers included) loads
    # strictly; IconVSR (tests/test_torch_iconvsr.py) shares its SpyNet,
    # branches and upsampler
    state = {k: v.clone() for k, v in net.state_dict().items()}
    assert {'spynet.mean', 'spynet.std'} <= set(state)
    build_network(opt, 'cpu').load_state_dict(state, strict=True)
    icon = build_network({'type': 'IconVSR', 'num_feat': 16,
                          'num_block': 2}, 'cpu').state_dict()
    shared = [k for k in state if k.startswith(
        ('spynet.', 'backward_trunk.', 'upconv', 'conv_hr', 'conv_last'))]
    assert shared and all(icon[k].shape == state[k].shape for k in shared)


# ---------------------------------------------------------------------------
# flow_util, generate_frame_indices
# ---------------------------------------------------------------------------

def test_flow_files_round_trip_across_packages(tmp_path):
    from bsvd_tpu.utils import flow_util as jflow
    flow = _x((12, 10, 2), 10, -3, 3)
    flow_util.flowwrite(flow, str(tmp_path / 'p.flo'))
    jflow.flowwrite(flow, str(tmp_path / 'j.flo'))
    assert (tmp_path / 'p.flo').read_bytes() == \
        (tmp_path / 'j.flo').read_bytes()
    assert np.array_equal(jflow.flowread(str(tmp_path / 'p.flo')), flow)
    assert np.array_equal(flow_util.flowread(str(tmp_path / 'j.flo')), flow)
    for axis in (0, 1):
        kw = {'max_val': 0.3}
        flow_util.flowwrite(flow, str(tmp_path / f'p{axis}.png'), True,
                            axis, **kw)
        jflow.flowwrite(flow, str(tmp_path / f'j{axis}.png'), True, axis,
                        **kw)
        for a, b in ((f'p{axis}', f'j{axis}'), (f'j{axis}', f'p{axis}')):
            got = flow_util.flowread(str(tmp_path / f'{a}.png'), True, axis,
                                     **kw)
            ref = jflow.flowread(str(tmp_path / f'{b}.png'), True, axis,
                                 **kw)
            assert np.array_equal(got, ref)
    for norm in (True, False):
        q = flow_util.quantize_flow(flow, 0.5, norm)
        jq = jflow.quantize_flow(flow, 0.5, norm)
        assert all(np.array_equal(a, b) and a.dtype == b.dtype
                   for a, b in zip(q, jq))
        assert np.array_equal(flow_util.dequantize_flow(*q, 0.5, norm),
                              jflow.dequantize_flow(*jq, 0.5, norm))
    with pytest.raises(IOError, match='PIEH'):
        (tmp_path / 'bad.flo').write_bytes(b'XXXX')
        flow_util.flowread(str(tmp_path / 'bad.flo'))


def test_flow2rgb_matches_jax():
    from bsvd_tpu.utils import flow_util as jflow
    flow = _x((16, 20, 2), 11, -5, 5)
    for max_flow in (None, 3.0):
        _close(flow_util.flow2rgb(flow, max_flow),
               jflow.flow2rgb(flow, max_flow), atol=1e-6)
    assert np.array_equal(flow_util._make_color_wheel(),
                          jflow._make_color_wheel())


@pytest.mark.parametrize('padding', ['replicate', 'reflection',
                                     'reflection_circle', 'circle'])
def test_generate_frame_indices_matches_jax(padding):
    from bsvd_tpu.data.data_util import generate_frame_indices as jgen
    for total in (7, 12):
        for num in (3, 5, 7):
            for crt in range(total):
                assert generate_frame_indices(crt, total, num, padding) == \
                    jgen(crt, total, num, padding)


# ---------------------------------------------------------------------------
# the datasets
# ---------------------------------------------------------------------------

CLIP_FRAMES, GT_HW, SCALE = 7, (32, 40), 4


@pytest.fixture(scope='module')
def clip_tree(tmp_path_factory):
    """gt/<clip>/NNNNNNNN.png and their 4x-smaller lq, 3 clips of 7
    frames; clip 001's frames carry EXIF orientation 3 (both trees)."""
    root = tmp_path_factory.mktemp('reds')
    rng = np.random.default_rng(12)
    for c in range(3):
        for i in range(CLIP_FRAMES):
            gt = rng.integers(0, 256, GT_HW + (3,), np.uint8)
            lq = gt.reshape(GT_HW[0] // SCALE, SCALE, GT_HW[1] // SCALE,
                            SCALE, 3).mean((1, 3)).round().astype(np.uint8)
            for tree, img in (('gt', gt), ('lq', lq)):
                data = img_util.encode_png(img)
                if c == 1:
                    data = png_with(data, tiff(3))
                path = root / tree / f'{c:03d}' / f'{i:08d}.png'
                path.parent.mkdir(parents=True, exist_ok=True)
                path.write_bytes(data)
    return {'gt': str(root / 'gt'), 'lq': str(root / 'lq')}


def _same_item(got, ref):
    assert set(got) == set(ref)
    for k, v in ref.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
        else:
            assert got[k] == v, k


DATASETS = {
    'recurrent': {'type': 'REDSRecurrentDataset', 'num_frame': 3,
                  'interval_list': [1, 2], 'gt_size': 16},
    'recurrent_no_flips': {'type': 'REDSRecurrentDataset', 'num_frame': 4,
                           'gt_size': 8, 'use_hflip': False,
                           'use_rot': False},
    'reds': {'type': 'REDSDataset', 'num_frame': 3,
             'interval_list': [1, 2, 3], 'gt_size': 16,
             'random_reverse': True},
    'recurrent_test': {'type': 'VideoRecurrentTestDataset'},
    'recurrent_test_cap': {'type': 'VideoRecurrentTestDataset',
                           'num_frame': 4},
    'window_test': {'type': 'VideoTestDataset', 'num_frame': 5},
    'window_test_replicate': {'type': 'VideoTestDataset', 'num_frame': 3,
                              'padding': 'replicate'},
}


@pytest.mark.parametrize('case', sorted(DATASETS))
def test_video_datasets_equal_jax(clip_tree, case):
    from bsvd_tpu.data import build_dataset as jbuild
    opt = dict(DATASETS[case], name=case, dataroot_gt=clip_tree['gt'],
               dataroot_lq=clip_tree['lq'], scale=SCALE, manual_seed=5)
    got, ref = build_dataset(opt), jbuild(opt)
    assert len(got) == len(ref)
    order = [i % len(ref) for i in (0, 4, 1, 1, 5, 2, len(ref) - 1)]
    for i in order:
        _same_item(got[i], ref[i])
    if hasattr(got, 'skip'):
        # skip makes an item's draws without reading it
        again = build_dataset(opt)
        for i in order[:3]:
            again.skip(i)
        _same_item(again[order[3]], _replay(opt, order, 3))


def _replay(opt, order, n):
    """Item ``order[n]`` of a fresh dataset that first read ``order[:n]``."""
    ds = build_dataset(opt)
    for i in order[:n]:
        ds[i]
    return ds[order[n]]
