"""DFDNet, the face helper and inference_dfdnet of the port against the JAX
package on the CPU (bsvd_tpu_torch.archs.dfdnet_arch,
bsvd_tpu_torch.utils.face_util, bsvd_tpu_torch.inference.inference_dfdnet).

DFDNet runs at its only width (num_feat 64: conv5_4's 512 channels feed
the dilation block) on a 256 x 256 face with tests/test_dfdnet.py's part
boxes and a seeded fake dictionary. The port's seeded weights go to JAX
through ``jax_tree_from_state``; the last conv is scaled down so that the
tanh does not saturate (random weights put its input near 1e4). Held: the
chosen atoms equal, the output within 1e-4 x max|ref|."""

import importlib.util
import os
import sys
import types

import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401

jnp = pytest.importorskip('jax.numpy')

from bsvd_tpu_torch.archs import dfdnet_arch as port  # noqa: E402
from bsvd_tpu_torch.utils import face_util as port_face  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARTS = ('left_eye', 'right_eye', 'nose', 'mouth')
# part boxes in 512-scale coordinates inside [0, 256) (tests/test_dfdnet.py)
LOCATIONS = [np.array([[64, 64, 128, 128]]), np.array([[160, 64, 224, 128]]),
             np.array([[96, 128, 160, 192]]), np.array([[96, 192, 160, 248]])]
DICT_SIZES = {'256': (128, 8, 8), '128': (256, 6, 6), '64': (512, 4, 4),
              '32': (512, 3, 3)}


def _fake_dict(seed=11, atoms=3):
    rng = np.random.default_rng(seed)
    return {s: {p: rng.standard_normal((atoms,) + v).astype(np.float32)
                for p in PARTS} for s, v in DICT_SIZES.items()}


def _nhwc_dict(d):
    return {s: {p: jnp.asarray(np.transpose(v, (0, 2, 3, 1)))
                for p, v in parts.items()} for s, parts in d.items()}


@pytest.fixture(scope='module')
def nets():
    face_dict = _fake_dict()
    net = port.DFDNet(64, face_dict=face_dict, seed=3)
    with torch.no_grad():
        net.upsample4[4].weight.mul_(3e-5)
        net.upsample4[4].bias.mul_(3e-5)
    import jax
    jtree = jax.tree_util.tree_map(
        jnp.asarray, port.jax_tree_from_state(net.state_dict()))
    return net, jtree, face_dict


def _jax_atoms(jtree, face_dict, x_nhwc):
    """JAX's chosen atoms, by its own functions (dfdnet_arch._swap_feat's
    scoring)."""
    from bsvd_tpu.archs import dfdnet_arch as jd
    from bsvd_tpu.archs.vgg_arch import vgg_feature_apply
    feats = vgg_feature_apply(jtree['vgg'], x_nhwc, list(jd.VGG_LAYERS),
                              'vgg19', use_input_norm=True, range_norm=True)
    out, margins = {}, []
    nd = _nhwc_dict(face_dict)
    for layer, fs in zip(jd.VGG_LAYERS, jd.FEATURE_SIZES):
        for i, part in enumerate(PARTS):
            x0, y0, x1, y1 = (LOCATIONS[i][0] // (512 / fs)).astype(np.int64)
            pf = feats[layer][:, y0:y1, x0:x1, :]
            atoms = nd[str(fs)][part]
            pr = jd.resize_bilinear(pf, atoms.shape[1], atoms.shape[2])
            an = jd.adaptive_instance_normalization(atoms, pr)
            scores = np.asarray(jnp.einsum('hwc,khwc->k', pr[0], an))
            out[(fs, part)] = int(np.argmax(scores))
            top = np.sort(scores)[::-1]
            margins.append((top[0] - top[1]) / abs(top[0]))
    return out, min(margins)


def test_dfdnet_matches_jax(nets):
    from bsvd_tpu.archs.dfdnet_arch import dfdnet_apply
    net, jtree, face_dict = nets
    x = np.random.default_rng(0).uniform(-1, 1, (1, 3, 256, 256)).astype(
        np.float32)
    with torch.no_grad():
        got = net(torch.from_numpy(x), LOCATIONS).numpy()
    x_nhwc = jnp.asarray(np.transpose(x, (0, 2, 3, 1)))
    atoms, margin = _jax_atoms(jtree, face_dict, x_nhwc)
    # AdaIN gives every atom the query's channel means, so the scores share
    # a large common term; the top two differ by 1.2e-5 of the top here,
    # ~100 fp32 roundings of the 8192-term sums
    assert margin > 2e-6, margin
    assert net.last_atoms == atoms
    ref = np.transpose(np.asarray(dfdnet_apply(
        jtree, _nhwc_dict(face_dict), x_nhwc, LOCATIONS)), (0, 3, 1, 2))
    assert got.shape == ref.shape == (1, 3, 256, 256)
    assert 0.05 < np.abs(ref).max() < 0.999        # tanh not saturated
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())


def test_dfdnet_helpers_match_jax():
    from bsvd_tpu.archs import dfdnet_arch as jd
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 7, 9)).astype(np.float32)
    xj = jnp.asarray(np.transpose(x, (0, 2, 3, 1)))
    for oh, ow in ((14, 18), (3, 4), (7, 9), (11, 5)):
        np.testing.assert_allclose(
            port.resize_bilinear(torch.from_numpy(x), oh, ow).numpy(),
            np.transpose(np.asarray(jd.resize_bilinear(xj, oh, ow)),
                         (0, 3, 1, 2)), rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(
            port.resize_nearest(torch.from_numpy(x), oh, ow).numpy(),
            np.transpose(np.asarray(jd.resize_nearest(xj, oh, ow)),
                         (0, 3, 1, 2)))
    m, s = port.calc_mean_std(torch.from_numpy(x))
    jm, js = jd.calc_mean_std(xj)
    np.testing.assert_allclose(m.numpy()[..., 0, 0],
                               np.asarray(jm)[:, 0, 0], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(s.numpy()[..., 0, 0],
                               np.asarray(js)[:, 0, 0], rtol=1e-6, atol=1e-6)
    style = (2 * rng.standard_normal((2, 5, 7, 9)) + 1).astype(np.float32)
    got = port.adaptive_instance_normalization(torch.from_numpy(x),
                                               torch.from_numpy(style))
    ref = jd.adaptive_instance_normalization(
        xj, jnp.asarray(np.transpose(style, (0, 2, 3, 1))))
    np.testing.assert_allclose(got.numpy(), np.transpose(
        np.asarray(ref), (0, 3, 1, 2)), rtol=1e-5, atol=1e-5)


def _basicsr_state(net, seed=5):
    """A BasicSR-style DFDNet state: the port's convs, every third one
    past the VGG as spectral norm (weight_orig, u, v), plus the VGG's
    norm buffers."""
    rng = np.random.default_rng(seed)
    state = {}
    for i, (prefix, _) in enumerate(port._jax_paths()):
        w = net.state_dict()[f'{prefix}.weight'].numpy()
        if i % 3 == 0 and not prefix.startswith('vgg'):
            state[f'{prefix}.weight_orig'] = w * 3.0
            state[f'{prefix}.weight_u'] = rng.standard_normal(
                w.shape[0]).astype(np.float32)
            state[f'{prefix}.weight_v'] = rng.standard_normal(
                w[0].size).astype(np.float32)
        else:
            state[f'{prefix}.weight'] = w
        state[f'{prefix}.bias'] = net.state_dict()[f'{prefix}.bias'].numpy()
    state['vgg_extractor.mean'] = np.zeros((1, 3, 1, 1), np.float32)
    state['vgg_extractor.std'] = np.ones((1, 3, 1, 1), np.float32)
    return state


def test_convert_torch_dfdnet_matches_jax(nets):
    """Spectral norms folded as JAX folds them; the JAX tree and the
    port's state convert both ways."""
    from bsvd_tpu.archs.dfdnet_arch import convert_torch_dfdnet as jconv
    net = nets[0]
    state = _basicsr_state(net)
    mine = port.convert_torch_dfdnet(state)
    via_jax = port.state_from_jax_tree(jconv(state))
    assert set(mine) == set(via_jax) == set(
        k for k in net.state_dict() if k.endswith(('weight', 'bias')))
    for k in mine:
        np.testing.assert_allclose(mine[k].numpy(), via_jax[k].numpy(),
                                   rtol=1e-6, atol=1e-7)
    back = port.state_from_jax_tree(port.jax_tree_from_state(mine))
    for k in mine:
        np.testing.assert_array_equal(back[k].numpy(), mine[k].numpy())
    # the JAX tree has JAX's layout (lists for the conv pairs)
    tree = port.jax_tree_from_state(mine)
    assert isinstance(tree['attn']['nose_64'], list)
    assert isinstance(tree['ms_dilation']['blocks'][3], list)
    assert tree['upsample4']['out']['w'].shape == (3, 3, 64, 3)


def test_load_face_dict_pth_and_npz(tmp_path):
    from bsvd_tpu.archs.dfdnet_arch import load_face_dict as jload
    d = _fake_dict(seed=4, atoms=2)
    pth = tmp_path / 'dict.pth'
    torch.save({int(s): {p: torch.from_numpy(v) for p, v in parts.items()}
                for s, parts in d.items()}, str(pth))
    npz = tmp_path / 'dict.npz'
    np.savez(str(npz), **{f'{s}/{p}': v for s, parts in d.items()
                          for p, v in parts.items()})
    for path in (pth, npz):
        mine = port.load_face_dict(str(path))
        ref = jload(str(path))
        assert set(mine) == set(ref) == set(DICT_SIZES)
        for s in mine:
            for p in PARTS:
                np.testing.assert_array_equal(
                    mine[s][p].numpy(),
                    np.transpose(np.asarray(ref[s][p]), (0, 3, 1, 2)))


def _jax_inference_module():
    spec = importlib.util.spec_from_file_location(
        '_t_jax_inf_dfdnet', os.path.join(ROOT, 'inference',
                                          'inference_dfdnet.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_get_part_location_matches_jax():
    from bsvd_tpu_torch.inference.inference_dfdnet import get_part_location
    ref_fn = _jax_inference_module().get_part_location
    rng = np.random.default_rng(5)
    for _ in range(5):
        lm = rng.uniform(0, 512, (68, 2))
        for a, b in zip(get_part_location(lm), ref_fn(lm)):
            np.testing.assert_array_equal(a, b)
    lm = np.tile(rng.uniform(100, 400, (1, 2)), (68, 1))   # the 16 floor
    for a, b in zip(get_part_location(lm), ref_fn(lm)):
        np.testing.assert_array_equal(a, b)


# ----------------------------------------------------------- face helper
def _face_frame(h=170, w=210, seed=4):
    import cv2
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, (h, w, 3)).astype(np.uint8)
    return cv2.GaussianBlur(img, (15, 15), 5)


def _landmarks(helper_template, scale=1.25, off=(30.0, 18.0), seed=6):
    rng = np.random.default_rng(seed)
    return (helper_template * scale + np.array(off)
            + rng.normal(0, 0.7, (5, 2)))


@pytest.mark.parametrize('upscale', [1, 2])
def test_face_helper_matches_jax(tmp_path, upscale):
    from bsvd_tpu.utils.face_util import FaceRestorationHelper as JHelper
    img = _face_frame()
    jh = JHelper(upscale, face_size=128)
    ph = port_face.FaceRestorationHelper(upscale, face_size=128,
                                         device='cpu')
    np.testing.assert_array_equal(ph.face_template, jh.face_template)
    lm = _landmarks(jh.face_template)
    jh.input_img = img
    ph.input_img = torch.from_numpy(img)
    jh.all_landmarks_5 = [lm]
    ph.all_landmarks_5 = [lm]
    jh.warp_crop_faces(str(tmp_path / 'j' / 'crop.png'),
                       str(tmp_path / 'j' / 'inv.png'))
    ph.warp_crop_faces(str(tmp_path / 'p' / 'crop.png'),
                       str(tmp_path / 'p' / 'inv.png'))
    np.testing.assert_array_equal(ph.cropped_faces[0].numpy(),
                                  jh.cropped_faces[0])
    np.testing.assert_array_equal(ph.inverse_affine_matrices[0],
                                  jh.inverse_affine_matrices[0])
    np.testing.assert_array_equal(np.load(tmp_path / 'p' / 'inv_00.npy'),
                                  np.load(tmp_path / 'j' / 'inv_00.npy'))
    import cv2
    np.testing.assert_array_equal(
        cv2.imread(str(tmp_path / 'p' / 'crop_00.png')),
        cv2.imread(str(tmp_path / 'j' / 'crop_00.png')))
    # a "restored" face: the crop in BGR with a pattern on it
    restored = cv2.cvtColor(jh.cropped_faces[0], cv2.COLOR_RGB2BGR)
    restored = (restored.astype(np.int32) + np.arange(128)[None, :, None]
                % 37).clip(0, 255).astype(np.uint8)
    jh.add_restored_face(restored)
    ph.add_restored_face(restored)
    ref = jh.paste_faces_to_input_image(str(tmp_path / 'j' / 'final.jpg'))
    got = ph.paste_faces_to_input_image(str(tmp_path / 'p' / 'final.jpg'))
    assert got.shape == ref.shape == (170 * upscale, 210 * upscale, 3)
    # cv2's float GaussianBlur differs from the port's in the last W*C % 8
    # values of a row (1.2e-7), so the blend agrees to float rounding
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-3)
    a = cv2.imread(str(tmp_path / 'p' / 'final.png')).astype(int)
    b = cv2.imread(str(tmp_path / 'j' / 'final.png')).astype(int)
    d = np.abs(a - b)
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3, ((d > 0).mean(), d.max())


def test_read_input_image_is_cv2s(tmp_path):
    import cv2
    from bsvd_tpu.utils.face_util import FaceRestorationHelper as JHelper
    img = _face_frame(40, 52)
    for ext in ('.png', '.jpg'):
        path = str(tmp_path / f'frame{ext}')
        cv2.imwrite(path, img)
        jh = JHelper(2, face_size=128)
        jh.read_input_image(path)
        ph = port_face.FaceRestorationHelper(2, face_size=128, device='cpu')
        ph.read_input_image(path)
        np.testing.assert_array_equal(ph.input_img.numpy(), jh.input_img)


def test_init_dlib_raises_without_dlib():
    from bsvd_tpu.utils import face_util as jax_face
    assert port_face.dlib is None and jax_face.dlib is None
    for helper in (port_face.FaceRestorationHelper(2, device='cpu'),
                   jax_face.FaceRestorationHelper(2)):
        with pytest.raises(ImportError, match='install dlib'):
            helper.init_dlib('a.dat', 'b.dat', 'c.dat')


# -------------------------------------------------------------- inference
class _FakeDlib:
    """dlib's detector and predictors, answering given landmarks: the 5
    points on the frame, the 68 on a 512 crop."""

    def __init__(self, lm5, lm68):
        self.lm5, self.lm68 = lm5, lm68

    @staticmethod
    def _rect():
        return types.SimpleNamespace(left=lambda: 10, right=lambda: 200,
                                     top=lambda: 10, bottom=lambda: 220)

    def cnn_face_detection_model_v1(self, path):
        del path
        return lambda img, n: [types.SimpleNamespace(rect=self._rect())]

    def shape_predictor(self, path):
        pts = self.lm5 if '5_face' in path else self.lm68

        def predict(img, rect):
            del img, rect
            return types.SimpleNamespace(parts=lambda: [
                types.SimpleNamespace(x=float(x), y=float(y))
                for x, y in pts])
        return predict


class _HalfNet(torch.nn.Module):
    """A stand-in for DFDNet: 0.5 x, the part boxes recorded."""
    calls = []

    def __init__(self, *a, **k):
        super().__init__()

    def forward(self, x, locs):
        _HalfNet.calls.append([np.asarray(v) for v in locs])
        return x * 0.5


class _JaxHalfNet:
    calls = []

    def __init__(self, *a, **k):
        pass

    def __call__(self, x, locs):
        _JaxHalfNet.calls.append([np.asarray(v) for v in locs])
        return jnp.asarray(x) * 0.5


def _inference_case(tmp_path):
    import cv2
    test = tmp_path / 'TestWhole'
    test.mkdir()
    frame = _face_frame(300, 280, seed=8)
    cv2.imwrite(str(test / 'face.png'), cv2.cvtColor(frame,
                                                     cv2.COLOR_RGB2BGR))
    tmpl = np.array([[686.77227723, 488.62376238], [586.77227723,
                     493.59405941], [337.91089109, 488.38613861],
                     [437.95049505, 493.51485149], [513.58415842,
                                                    678.5049505]]) / 2
    lm5 = tmpl * 0.45 + np.array([25.0, 20.0])
    rng = np.random.default_rng(9)
    lm68 = rng.uniform(100, 420, (68, 2))
    return str(test), lm5, lm68


def _batch_tensor2img(monkeypatch):
    """JAX's tensor2img given the batch's one image: JAX's script passes
    the (1, 3, H, W) output whole, which its tensor2img refuses (see
    test_jax_inference_dfdnet_fails_on_its_4d_output)."""
    import bsvd_tpu.utils as ju
    orig = ju.tensor2img
    monkeypatch.setattr(ju, 'tensor2img', lambda t, **k: orig(
        np.asarray(t)[0] if np.ndim(t) == 4 else t, **k))


def test_inference_dfdnet_matches_jax_script(tmp_path, monkeypatch):
    """Both scripts end to end on a stub dlib and a stub net (0.5 x): the
    same crops, part boxes, inverse matrices and restored faces, and the
    final frame within 1 LSB on 0.1% of pixels."""
    import cv2
    from bsvd_tpu.archs import dfdnet_arch as jd
    from bsvd_tpu.utils import face_util as jax_face
    from bsvd_tpu_torch.inference import inference_dfdnet as pinf
    _batch_tensor2img(monkeypatch)
    test, lm5, lm68 = _inference_case(tmp_path)
    fake = _FakeDlib(lm5, lm68)
    monkeypatch.setattr(jax_face, 'dlib', fake)
    monkeypatch.setattr(port_face, 'dlib', fake)
    monkeypatch.setattr(jd, 'DFDNet', _JaxHalfNet)
    monkeypatch.setattr(port, 'DFDNet', _HalfNet)
    _HalfNet.calls.clear()
    _JaxHalfNet.calls.clear()
    monkeypatch.chdir(tmp_path / 'TestWhole')
    os.makedirs('j')
    os.makedirs('p')
    monkeypatch.chdir('j')
    monkeypatch.setattr(sys, 'argv', ['x', '--test_path', test,
                                      '--save_inverse_affine'])
    _jax_inference_module().main()
    monkeypatch.chdir('../p')
    pinf.main(['--test_path', test, '--save_inverse_affine',
               '--device', 'cpu'])
    for a, b in zip(_HalfNet.calls[0], _JaxHalfNet.calls[0]):
        np.testing.assert_array_equal(a, b)
    root = 'results/DFDNet/TestWhole'
    for sub in ('cropped_faces/face_00.png', 'restored_faces/face_00.png'):
        np.testing.assert_array_equal(cv2.imread(f'{root}/{sub}'),
                                      cv2.imread(f'../j/{root}/{sub}'))
    np.testing.assert_array_equal(
        np.load(f'{root}/inverse_affine/face_00.npy'),
        np.load(f'../j/{root}/inverse_affine/face_00.npy'))
    a = cv2.imread(f'{root}/final_results/face.png').astype(int)
    b = cv2.imread(f'../j/{root}/final_results/face.png').astype(int)
    assert a.shape == b.shape == (600, 560, 3)
    d = np.abs(a - b)
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3


def test_inference_dfdnet_stops_without_dlib_as_jax(tmp_path, monkeypatch):
    from bsvd_tpu.archs import dfdnet_arch as jd
    from bsvd_tpu_torch.inference import inference_dfdnet as pinf
    test, _, _ = _inference_case(tmp_path)
    monkeypatch.setattr(jd, 'DFDNet', _JaxHalfNet)
    monkeypatch.setattr(port, 'DFDNet', _HalfNet)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, 'argv', ['x', '--test_path', test])
    with pytest.raises(ImportError) as ref:
        _jax_inference_module().main()
    with pytest.raises(ImportError) as got:
        pinf.main(['--test_path', test, '--device', 'cpu'])
    assert str(got.value) == str(ref.value)


def test_jax_inference_dfdnet_fails_on_its_4d_output(tmp_path, monkeypatch):
    """A fault of the JAX script the port does not copy: it hands DFDNet's
    (1, 3, 512, 512) output, and then its (1, 3, 512, 512) input, to a
    tensor2img that takes (C, H, W), so it dies at the first face with
    landmarks; the port restores it (BasicSR's tensor2img takes the
    batch)."""
    from bsvd_tpu.archs import dfdnet_arch as jd
    from bsvd_tpu.utils import face_util as jax_face
    from bsvd_tpu_torch.inference import inference_dfdnet as pinf
    test, lm5, lm68 = _inference_case(tmp_path)
    fake = _FakeDlib(lm5, lm68)
    monkeypatch.setattr(jax_face, 'dlib', fake)
    monkeypatch.setattr(port_face, 'dlib', fake)
    monkeypatch.setattr(jd, 'DFDNet', _JaxHalfNet)
    monkeypatch.setattr(port, 'DFDNet', _HalfNet)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, 'argv', ['x', '--test_path', test])
    with pytest.raises(ValueError, match='unsupported ndim 4'):
        _jax_inference_module().main()
    pinf.main(['--test_path', test, '--device', 'cpu'])
    assert os.path.isfile('results/DFDNet/TestWhole/final_results/face.png')
