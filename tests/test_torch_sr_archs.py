"""The zoo's image-SR archs of the port against the JAX package's on the
CPU: MSRResNet, EDSR, RRDBNet, RCAN, RIDNet, the VGG feature extractor
with each of its options, both discriminators (eval; train-mode
statistics and the running update after one step; spectral norm's u after
one step) and the weights' converter (round trip; a BasicSR-layout state
dict through ``load_state_dict``).

The weights of a case are drawn once (module-scoped fixtures) by the
port's seeded init and carried to the JAX package as a tree by
``convert.torch_generic.to_jax_tree``, whose structure and shapes are
held to the JAX init's (``jax.eval_shape``, no draw: the JAX init runs
op by op and costs seconds a net); a second port module takes them back
through ``from_jax_tree``, so parity never rests on the init. The JAX
forwards are jitted. Inputs are numpy draws from a seed. fp32; outputs
within 1e-5 x max|ref| (the nets are tiny: summation order only).
Bilinear upscaling's borders are compared on their own, for x2, x3 and
x4.
"""

import numpy as np
import pytest
import torch

from bsvd_tpu_torch.archs import build_network
from bsvd_tpu_torch.archs.discriminator_arch import bn_update_running
from bsvd_tpu_torch.archs.sr_archs import bilinear_resize, pixel_unshuffle
from bsvd_tpu_torch.archs.vgg_arch import (NAMES, convert_torchvision_vgg,
                                           insert_bn, vgg_names)
from bsvd_tpu_torch.convert.torch_generic import (from_jax_tree,
                                                  load_torch_generic,
                                                  state_dict_to_tree,
                                                  to_jax_tree,
                                                  tree_to_state_dict)
from torch_threads import one_torch_thread  # noqa: F401

jax = pytest.importorskip('jax')
jnp = pytest.importorskip('jax.numpy')

REL = 1e-5


def _close(got, ref, rel=REL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = float(np.abs(got - ref).max())
    assert err <= rel * float(np.abs(ref).max()), (err, np.abs(ref).max())


def _x(shape, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(
        np.float32)


def _port(opt, tree):
    net = build_network(dict(opt), 'cpu')
    net.load_state_dict(from_jax_tree(tree), strict=True)
    return net.eval()


def _shapes(tree):
    return jax.tree.map(lambda a: tuple(np.shape(a)), dict(tree))


def _jax_case(cls, opt, seed=1):
    """(JAX wrapper of ``cls`` with ``opt`` and no init, the port's
    seeded weights as a JAX tree), the tree's structure and shapes checked
    against the JAX init's."""
    net = build_network(dict(opt, seed=seed), 'cpu')
    tree = to_jax_tree(net)
    jnet = cls.__new__(cls)
    kw = {k: v for k, v in opt.items() if k != 'type'}
    jnet.opt = kw
    want = jax.eval_shape(lambda k: cls.init_fn(k, **jnet._init_kwargs()),
                          jax.random.PRNGKey(0))
    assert _shapes(tree) == _shapes(want)
    return jnet, tree


ARCHS = {
    'msrresnet_x4': {'type': 'MSRResNet', 'num_feat': 8, 'num_block': 2,
                     'upscale': 4},
    'msrresnet_x3': {'type': 'MSRResNet', 'num_feat': 8, 'num_block': 1,
                     'upscale': 3},
    'edsr_x2': {'type': 'EDSR', 'num_feat': 8, 'num_block': 2, 'upscale': 2,
                'res_scale': 0.5},
    'edsr_x3': {'type': 'EDSR', 'num_feat': 8, 'num_block': 1, 'upscale': 3},
    'rrdbnet_x4': {'type': 'RRDBNet', 'num_feat': 8, 'num_block': 2,
                   'num_grow_ch': 4},
    'rrdbnet_x2': {'type': 'RRDBNet', 'num_feat': 8, 'num_block': 1,
                   'num_grow_ch': 4, 'scale': 2},
    'rrdbnet_x1': {'type': 'RRDBNet', 'num_feat': 8, 'num_block': 1,
                   'num_grow_ch': 4, 'scale': 1},
    'rcan_x2': {'type': 'RCAN', 'num_feat': 16, 'num_group': 2,
                'num_block': 2, 'squeeze_factor': 4, 'upscale': 2},
    'ridnet': {'type': 'RIDNet', 'mid_channels': 16, 'num_block': 2},
}


@pytest.fixture(scope='module')
def jax_archs():
    from bsvd_tpu.archs import sr_archs as jsr
    return {name: _jax_case(getattr(jsr, opt['type']), opt)
            for name, opt in ARCHS.items()}


@pytest.mark.parametrize('name', sorted(ARCHS))
def test_sr_arch_matches_jax(jax_archs, name):
    jnet, tree = jax_archs[name]
    x = _x((2, 3, 16, 16), seed=len(name))
    ref = np.asarray(jax.jit(jnet.apply)(jax.tree.map(jnp.asarray, tree),
                                         jnp.asarray(x)))
    net = _port(ARCHS[name], tree)
    with torch.no_grad():
        _close(net(torch.from_numpy(x)), ref)


@pytest.mark.parametrize('scale', [2, 3, 4])
def test_bilinear_resize_borders_match_jax(scale):
    """F.interpolate(bilinear, align_corners=False) against
    jax.image.resize: the whole image, and its outer rows and columns on
    their own (where the two clamp their taps)."""
    from bsvd_tpu.archs.sr_archs import bilinear_resize as jax_resize
    x = _x((2, 3, 7, 9), seed=scale)
    ref = np.transpose(np.asarray(jax_resize(
        jnp.asarray(np.transpose(x, (0, 2, 3, 1))), scale)), (0, 3, 1, 2))
    got = bilinear_resize(torch.from_numpy(x), scale).numpy()
    _close(got, ref)
    b = scale
    for sl in (np.s_[..., :b, :], np.s_[..., -b:, :], np.s_[..., :, :b],
               np.s_[..., :, -b:]):
        _close(got[sl], ref[sl])


def test_pixel_unshuffle_matches_jax():
    from bsvd_tpu.archs.sr_archs import pixel_unshuffle as jax_unshuffle
    x = _x((2, 3, 8, 12))
    ref = np.transpose(np.asarray(jax_unshuffle(
        jnp.asarray(np.transpose(x, (0, 2, 3, 1))), 2)), (0, 3, 1, 2))
    assert np.array_equal(pixel_unshuffle(torch.from_numpy(x), 2).numpy(),
                          ref)


# ---------------------------------------------------------------------------
# VGG feature extractor
# ---------------------------------------------------------------------------

VGG = {
    'vgg19_default': dict(layer_name_list=['relu1_2', 'conv2_1'],
                          vgg_type='vgg19'),
    'vgg16_range_norm': dict(layer_name_list=['conv1_2', 'pool1'],
                             vgg_type='vgg16', range_norm=True),
    'vgg11_no_input_norm': dict(layer_name_list=['conv2_1'],
                                vgg_type='vgg11', use_input_norm=False),
    'vgg13_bn': dict(layer_name_list=['bn1_2', 'relu2_1'],
                     vgg_type='vgg13_bn'),
    'vgg19_remove_pooling': dict(layer_name_list=['conv2_1'],
                                 vgg_type='vgg19', remove_pooling=True),
    'vgg19_pooling_stride1': dict(layer_name_list=['pool1', 'conv2_1'],
                                  vgg_type='vgg19', pooling_stride=1),
}


def _torchvision_state(vgg_type, upto, seed):
    """A torchvision-layout ``features.<idx>`` state dict (numpy) of the
    layers up to ``upto``, BN statistics away from 0 / 1."""
    rng = np.random.default_rng(seed)
    names = vgg_names(vgg_type)
    state, cin = {}, 3
    for idx, name in enumerate(names[:names.index(upto) + 1]):
        if name.startswith('conv'):
            cout = min(64 * 2 ** (int(name[4]) - 1), 512)
            state[f'features.{idx}.weight'] = rng.normal(
                0, (2 / (cin * 9)) ** 0.5, (cout, cin, 3, 3)).astype(
                np.float32)
            state[f'features.{idx}.bias'] = rng.uniform(
                -0.1, 0.1, cout).astype(np.float32)
            cin = cout
        elif name.startswith('bn'):
            for k, lo, hi in (('weight', 0.5, 1.5), ('bias', -0.2, 0.2),
                              ('running_mean', -0.3, 0.3),
                              ('running_var', 0.5, 2.0)):
                state[f'features.{idx}.{k}'] = rng.uniform(
                    lo, hi, cin).astype(np.float32)
    return state


@pytest.mark.parametrize('case', sorted(VGG))
def test_vgg_features_match_jax(case, tmp_path):
    """The features of every requested layer, weights read by both
    packages from one torchvision-layout .npz (pretrain_path)."""
    from bsvd_tpu.archs.vgg_arch import VGGFeatureExtractor as JaxVGG
    opt = VGG[case]
    names = vgg_names(opt['vgg_type'])
    deepest = max(opt['layer_name_list'], key=names.index)
    path = str(tmp_path / 'vgg.npz')
    np.savez(path, **_torchvision_state(opt['vgg_type'], deepest, 7))
    x = _x((2, 3, 16, 16), seed=3)
    if opt.get('range_norm'):
        x = x * 2 - 1
    jvgg = JaxVGG(pretrain_path=path, **opt)
    ref = jvgg(jnp.asarray(x))
    vgg = build_network(dict(opt, type='VGGFeatureExtractor',
                             pretrain_path=path), 'cpu')
    assert vgg.pretrained and jvgg.pretrained
    assert not any(p.requires_grad for p in vgg.parameters())
    vgg.train()
    assert not vgg.training          # stays in eval mode
    with torch.no_grad():
        got = vgg(torch.from_numpy(x))
    assert sorted(got) == sorted(ref)
    for k in ref:
        _close(got[k], ref[k])


def test_vgg_tables_and_random_init(tmp_path, monkeypatch, caplog):
    """The layer tables are JAX's; without weights the extractor is
    random (not pretrained) and the perceptual loss logs JAX's warning."""
    from bsvd_tpu.archs import vgg_arch as jvgg
    from bsvd_tpu_torch.losses import build_loss
    assert NAMES == jvgg.NAMES
    assert insert_bn(NAMES['vgg16']) == jvgg.insert_bn(jvgg.NAMES['vgg16'])
    monkeypatch.setenv('BSVD_VGG_PRETRAIN_PATH', str(tmp_path / 'none.pth'))
    loss = build_loss({'type': 'PerceptualLoss',
                       'layer_weights': {'conv1_1': 1.0}})
    assert not loss.vgg.pretrained
    state = _torchvision_state('vgg19', 'conv1_2', 1)
    got = convert_torchvision_vgg(state)
    assert sorted(got) == ['vgg_net.conv1_1.bias', 'vgg_net.conv1_1.weight',
                           'vgg_net.conv1_2.bias', 'vgg_net.conv1_2.weight']
    pth = tmp_path / 'vgg.pth'
    torch.save({k: torch.from_numpy(v) for k, v in state.items()}, pth)
    monkeypatch.setenv('BSVD_VGG_PRETRAIN_PATH', str(pth))
    vgg = build_network({'type': 'VGGFeatureExtractor',
                         'layer_name_list': ['conv1_2']}, 'cpu')
    assert vgg.pretrained
    assert np.array_equal(vgg.vgg_net.conv1_2.weight.numpy(),
                          state['features.2.weight'])


# ---------------------------------------------------------------------------
# discriminators
# ---------------------------------------------------------------------------

DISCS = {'128': {'type': 'VGGStyleDiscriminator128', 'num_feat': 4},
         '256': {'type': 'VGGStyleDiscriminator256', 'num_feat': 2},
         'unet': {'type': 'UNetDiscriminatorSN', 'num_feat': 4}}


@pytest.fixture(scope='module')
def jax_discs():
    """Per case: (jitted JAX apply(params, x_nchw, train), the port's
    weights as a JAX tree), the structure checked against the JAX init's."""
    from bsvd_tpu.archs import discriminator_arch as jd
    out = {}
    for key, opt in DISCS.items():
        cls = getattr(jd, opt['type'])
        jnet = cls.__new__(cls)
        jnet.num_in_ch, jnet.num_feat, jnet.opt = 3, opt['num_feat'], {}
        tree = to_jax_tree(build_network(dict(opt, seed=2), 'cpu'))
        want = jax.eval_shape(jnet._init, jax.random.PRNGKey(0))
        assert _shapes(tree) == _shapes(want)
        out[key] = (jax.jit(jnet.apply, static_argnums=2), tree)
    return out


def _disc_tree(case):
    """The case's tree with BN statistics away from 0 / 1 (an eval
    forward that reads them)."""
    rng = np.random.default_rng(5)
    tree = jax.tree.map(np.array, case[1])
    for k, v in tree.items():
        if k.startswith('bn'):
            v['mean'] = rng.uniform(-0.2, 0.2, v['mean'].shape).astype(
                np.float32)
            v['var'] = rng.uniform(0.5, 2.0, v['var'].shape).astype(
                np.float32)
    return tree


@pytest.mark.parametrize('size', ['128', '256'])
def test_vgg_discriminator_eval_matches_jax(jax_discs, size):
    tree = _disc_tree(jax_discs[size])
    x = _x((2, 3, int(size), int(size)), seed=11)
    ref, stats = jax_discs[size][0](jax.tree.map(jnp.asarray, tree),
                                    jnp.asarray(x), False)
    assert stats == {}
    net = _port(DISCS[size], tree)
    with torch.no_grad():
        _close(net(torch.from_numpy(x)), ref)


def test_vgg_discriminator_train_stats_and_running_update(jax_discs):
    """Train mode: the logits on the batch's statistics, each BN's (mean,
    biased var), and the running statistics after one update (the JAX GAN
    step's bn_update_running, n not given)."""
    from bsvd_tpu.archs.discriminator_arch import \
        bn_update_running as jax_update
    tree = _disc_tree(jax_discs['128'])
    x = _x((3, 3, 128, 128), seed=12)
    ref, jstats = jax_discs['128'][0](jax.tree.map(jnp.asarray, tree),
                                      jnp.asarray(x), True)
    net = _port(DISCS['128'], tree)
    with torch.no_grad():
        got, stats = net.forward_stats(torch.from_numpy(x), train=True)
    _close(got, ref)
    assert sorted(stats) == sorted(jstats)
    for k in stats:
        _close(stats[k][0], jstats[k][0])
        _close(stats[k][1], jstats[k][1])
    net.update_state(stats)
    for k in stats:
        want = jax_update(tree[k], jstats[k])
        bn = getattr(net, k)
        _close(bn.running_mean, want['mean'])
        _close(bn.running_var, want['var'])
    # the count makes the variance unbiased, as bsvd_tpu's n argument
    bn = getattr(net, 'bn0_1')
    before = bn.running_var.clone()
    bn_update_running(bn, stats['bn0_1'], n=4)
    want = jax_update({'mean': bn.running_mean.numpy(),
                       'var': before.numpy()}, jstats['bn0_1'], n=4)
    _close(bn.running_var, want['var'])


def test_unet_discriminator_sn_matches_jax(jax_discs):
    """Output and each conv's new u after one forward (stored by
    update_state), eval and train alike (JAX iterates in both)."""
    apply, tree = jax_discs['unet']
    x = _x((2, 3, 32, 32), seed=13)
    ref, us = apply(jax.tree.map(jnp.asarray, tree), jnp.asarray(x), False)
    net = _port(DISCS['unet'], tree)
    with torch.no_grad():
        got, state = net.forward_stats(torch.from_numpy(x))
    _close(got, ref)
    assert sorted(state) == sorted(us)
    net.update_state(state)
    for k in us:
        _close(getattr(net, k).weight_u, us[k])
    # a second forward starts from the stored u, as JAX's next step does
    tree2 = jax.tree.map(np.asarray, tree)
    for k in us:
        tree2[k]['u'] = np.asarray(us[k])
    ref2, _ = apply(jax.tree.map(jnp.asarray, tree2), jnp.asarray(x), False)
    with torch.no_grad():
        _close(net(torch.from_numpy(x)), ref2)


# ---------------------------------------------------------------------------
# the converter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('name', ['rrdbnet_x4', 'rcan_x2', 'ridnet'])
def test_converter_round_trip(jax_archs, name):
    """JAX tree -> state dict -> module -> tree: every leaf back bit for
    bit."""
    tree = jax_archs[name][1]
    back = to_jax_tree(_port(ARCHS[name], tree))
    flat = dict(_leaves(tree))
    assert dict(_leaves(back)).keys() == flat.keys()
    for k, v in _leaves(back):
        assert np.array_equal(v, flat[k]), k


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_converter_discriminators_round_trip(jax_discs):
    """BN leaves <-> weight / bias / running stats, SN w / u <->
    weight_orig / weight_u (weight_v recomputed), linear (I, O) <-> (O,
    I); JAX's own mapper agrees on everything but BN's names."""
    from bsvd_tpu.convert.torch_generic import \
        tree_to_state_dict as jax_to_state
    for key in ('128', 'unet'):
        tree = _disc_tree(jax_discs[key])
        state = tree_to_state_dict(tree)
        net = build_network(DISCS[key], 'cpu')
        assert set(state) == set(net.state_dict()) - {
            k for k in net.state_dict() if 'num_batches_tracked' in k}
        jstate = jax_to_state(tree)
        for k, v in jstate.items():
            leaf = k.rsplit('.', 1)[1]
            if leaf in ('weight', 'bias') and 'bn' not in k:
                name = k if k in state else k.replace('weight',
                                                      'weight_orig')
                assert np.array_equal(state[name], v), k
        back = state_dict_to_tree(state)
        for k, v in _leaves(tree):
            assert np.array_equal(dict(_leaves(back))[k], v), k


def test_basicsr_state_dict_loads(tmp_path):
    """A BasicSR-layout state dict (RRDBNet keys, written by torch.save
    under 'params' as BasicSR saves) loads with load_state_dict and with
    load_torch_generic, whose missing keys raise unless strict=False."""
    src = build_network({'type': 'RRDBNet', 'num_feat': 8, 'num_block': 1,
                         'num_grow_ch': 4, 'seed': 3}, 'cpu')
    keys = list(src.state_dict())
    assert {'conv_first.weight', 'body.0.rdb1.conv1.weight',
            'body.0.rdb3.conv5.bias', 'conv_body.weight', 'conv_up1.weight',
            'conv_up2.weight', 'conv_hr.weight', 'conv_last.bias'} \
        <= set(keys)
    path = tmp_path / 'rrdb.pth'
    torch.save({'params': src.state_dict()}, path)
    dst = build_network({'type': 'RRDBNet', 'num_feat': 8, 'num_block': 1,
                         'num_grow_ch': 4}, 'cpu')
    dst.load_state_dict(torch.load(path, weights_only=True)['params'])
    other = build_network({'type': 'RRDBNet', 'num_feat': 8, 'num_block': 1,
                           'num_grow_ch': 4}, 'cpu')
    load_torch_generic(path, other, 'params')
    x = torch.from_numpy(_x((1, 3, 8, 8)))
    with torch.no_grad():
        assert torch.equal(src(x), dst(x)) and torch.equal(src(x), other(x))
    state = {k: v for k, v in src.state_dict().items()
             if k != 'conv_last.bias'}
    torch.save(state, tmp_path / 'part.pth')
    with pytest.raises(KeyError, match='conv_last/b'):
        load_torch_generic(tmp_path / 'part.pth', other, 'params')
    load_torch_generic(tmp_path / 'part.pth', other, 'params', strict=False)
    # the JAX package loads the same .pth into its tree (its template from
    # jax.eval_shape of the init)
    from bsvd_tpu.archs.sr_archs import RRDBNet as JaxRRDB
    jnet = JaxRRDB.__new__(JaxRRDB)
    jnet.opt = {'num_feat': 8, 'num_block': 1, 'num_grow_ch': 4}
    jnet.params = jax.eval_shape(lambda k: JaxRRDB.init_fn(k, **jnet.opt),
                                 jax.random.PRNGKey(0))
    jnet.load(str(path))
    xn = x.numpy()
    with torch.no_grad():
        _close(src(x), np.asarray(jnet(jnp.asarray(xn))))
