"""The port's prepare_hifacegan_dataset against the JAX repo's script on the
CPU: every template over the same GT folder at the same seed writes the
same LQ files, but where cv2_ops states a gap with cv2 (the cubic upscale,
which cv2 runs in IPP, and motion blur kernels, whose float warp cv2
computes apart in its last W % 16 columns, then filters from 12 x 12
taps by a DFT): there at most 1 LSB on at most 0.1% of pixels, over the
folder. face_renov chains blur, noise, JPEG and resize: a 1-LSB step
ahead of its JPEG can move the coefficients of its 8 x 8 block, so its
bound is on blocks (at most 2 of an image's blocks, as many LSB as
JPEG's quantisation of that block gives)."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401

cv2 = pytest.importorskip('cv2')

from bsvd_tpu_torch.scripts.data_preparation import \
    prepare_hifacegan_dataset as port  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEMPLATES = ('sr4x', 'sr4x8x', 'denoise', 'deblur', 'jpeg', '16x',
             'face_renov')
EXACT = ('denoise', 'jpeg', '16x')


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        '_t_jax_hfg_prep', os.path.join(
            ROOT, 'scripts', 'data_preparation',
            'prepare_hifacegan_dataset.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope='module')
def gt_folder(tmp_path_factory):
    """Eight 96 x 96 faces-like frames (smooth noise), a 16x-odd 88 x 100
    one, and a file that does not decode (skipped by both)."""
    root = tmp_path_factory.mktemp('hfg') / 'ffhq_gt'
    os.makedirs(root)
    rng = np.random.default_rng(1)
    for i in range(8):
        img = cv2.GaussianBlur(rng.integers(0, 256, (96, 96, 3),
                                            dtype=np.uint8), (7, 7), 2)
        cv2.imwrite(str(root / f'{i:03d}.png'), img)
    img = cv2.GaussianBlur(rng.integers(0, 256, (88, 100, 3),
                                        dtype=np.uint8), (5, 5), 1)
    cv2.imwrite(str(root / '100.png'), img)
    (root / 'notes.txt').write_text('not an image')
    return str(root)


@pytest.mark.parametrize('deg', TEMPLATES)
@pytest.mark.parametrize('seed', [0, 7])
def test_template_matches_jax_script(gt_folder, tmp_path, deg, seed):
    jax_out, port_out = str(tmp_path / 'jax'), str(tmp_path / 'port')
    _jax_script().create_training_dataset(deg, gt_folder, jax_out, seed)
    port.create_training_dataset(deg, gt_folder, port_out, seed,
                                 device='cpu')
    names = sorted(os.listdir(jax_out))
    assert names == sorted(os.listdir(port_out))
    assert len(names) == 9 and 'notes.txt' not in names
    diffs, total, blocks = 0, 0, []
    for name in names:
        a = cv2.imread(os.path.join(port_out, name)).astype(int)
        b = cv2.imread(os.path.join(jax_out, name)).astype(int)
        assert a.shape == b.shape
        d = np.abs(a - b)
        if deg in EXACT:
            np.testing.assert_array_equal(a, b, err_msg=name)
        elif deg == 'face_renov':
            h, w = d.shape[:2]
            blk = d[:h // 8 * 8, :w // 8 * 8].reshape(
                h // 8, 8, w // 8, 8, 3).max((1, 3, 4))
            blocks.append(int((blk > 0).sum()))
        else:
            assert d.max() <= 1, (name, d.max())
        diffs += int((d > 0).sum())
        total += d.size
    if deg in ('sr4x', 'sr4x8x', 'deblur'):
        assert diffs <= 1e-3 * total, diffs / total
    if blocks:
        assert max(blocks) <= 2, blocks


def test_degrade_draws_follow_the_seed():
    """degrade() takes the JAX script's draws in its order: the generator
    is left where the JAX function leaves it."""
    jax_mod = _jax_script()
    img = cv2.GaussianBlur(np.random.default_rng(3).integers(
        0, 256, (64, 64, 3), dtype=np.uint8), (5, 5), 1)
    for deg in TEMPLATES:
        r1, r2 = np.random.default_rng(5), np.random.default_rng(5)
        jax_mod.DEG_TEMPLATES[deg](img, r1)
        out = port.degrade(img, deg, r2, device='cpu')
        assert out.dtype == torch.uint8 and out.shape == img.shape
        assert r1.random() == r2.random(), deg


def test_mosaic_on_ragged_blocks():
    img = np.random.default_rng(4).integers(0, 256, (37, 45, 3),
                                            dtype=np.uint8)
    ref = _jax_script()._mosaic16(img, None)
    got = port._mosaic16(torch.from_numpy(img), None).numpy()
    np.testing.assert_array_equal(got, ref)


def test_unknown_template_raises(tmp_path):
    with pytest.raises(ValueError, match='not recognized'):
        port.create_training_dataset('blur9', str(tmp_path), device='cpu')


@pytest.mark.parametrize('quality', [15, 20, 27, 34, 41, 50])
def test_jpeg_writer_bytes_equal_cv2_at_the_template_qualities(quality):
    """The jpeg template's qualities (cv2 15-50): the port's writer gives
    cv2.imencode's bytes (it was held at cv2's default 95 before)."""
    from bsvd_tpu_torch.utils.jpeg_encode import encode_jpeg
    img = cv2.GaussianBlur(np.random.default_rng(quality).integers(
        0, 256, (96, 104, 3), dtype=np.uint8), (5, 5), 1.5)
    ok, ref = cv2.imencode('.jpg', img, [cv2.IMWRITE_JPEG_QUALITY, quality])
    assert ok
    assert encode_jpeg(np.ascontiguousarray(img[..., ::-1]), quality) == \
        ref.tobytes()


def test_numpy_sum_is_numpys():
    """The motion kernel's normaliser: numpy's float32 pairwise sum."""
    rng = np.random.default_rng(11)
    for n in list(range(1, 20)) + [100, 128, 129, 144, 255, 256, 400, 1000]:
        a = (rng.random(n) * rng.random(n) ** 8).astype(np.float32)
        assert port.numpy_sum_f32(torch.from_numpy(a)).item() == a.sum()
