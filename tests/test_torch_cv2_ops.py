"""bsvd_tpu_torch.utils.cv2_ops against cv2 5.0 at the parameters its
callers use (face_util, prepare_hifacegan_dataset, img_process_util,
degradations, niqe): uint8 bit-equal, float32 within 1e-5, and the two
stated gaps (INTER_CUBIC on uint8, which cv2 sends to IPP; filter2D from
12 x 12 taps, which cv2 runs through a DFT) held to 1 LSB on at most 0.1%
of pixels."""

import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401

cv2 = pytest.importorskip('cv2')

from bsvd_tpu_torch.utils import cv2_ops  # noqa: E402


def _img(seed, shape, dtype=np.uint8, smooth=False):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        x = rng.integers(0, 256, shape, dtype=np.uint8)
        return cv2.GaussianBlur(x, (5, 5), 1.0) if smooth else x
    return rng.random(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _lsb_gap(got, ref, frac=1e-3):
    d = np.abs(got.astype(np.int64) - ref.astype(np.int64))
    assert d.max() <= 1, d.max()
    assert (d > 0).mean() <= frac, (d > 0).mean()


@pytest.mark.parametrize('shape,dsize', [
    ((40, 52, 3), (104, 80)),        # face_util: x upscale_factor 2
    ((33, 47, 3), (141, 99)),        # x upscale 3, odd widths
    ((30, 41), (82, 60)),            # gray
    ((37, 53, 3), (90, 70)),         # a fractional factor
    ((64, 64, 3), (32, 32)),         # /2: cv2's INTER_AREA
])
def test_resize_linear_uint8_bit_equal(shape, dsize):
    x = _img(0, shape)
    ref = cv2.resize(x, dsize)
    got = cv2_ops.resize(_t(x), dsize).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize('shape,dsize', [
    ((64, 64, 3), (16, 16)),         # sr4x: an integer factor 4
    ((64, 64, 3), (8, 8)),           # factor 8
    ((64, 64, 3), (32, 32)),         # factor 2: (s + 2) >> 2
    ((64, 64, 3), (13, 13)),         # sr4x8x: fractional
    ((64, 64, 3), (9, 9)),
    ((100, 130, 3), (23, 31)),
    ((67, 67, 3), (16, 16)),
])
def test_resize_area_uint8_bit_equal(shape, dsize):
    x = _img(1, shape)
    ref = cv2.resize(x, dsize, interpolation=cv2.INTER_AREA)
    got = cv2_ops.resize(_t(x), dsize, cv2_ops.INTER_AREA).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize('small', [16, 13, 9, 8, 11])
def test_resize_cubic_uint8_within_ipp_gap(small):
    """sr4x / sr4x8x's cubic upscale back to 64: cv2 5.0 sends it to IPP;
    the port's float64 Keys cubic is within 1 LSB on at most 0.1%."""
    x = _img(2, (small, small, 3), smooth=False)
    ref = cv2.resize(x, (64, 64), interpolation=cv2.INTER_CUBIC)
    got = cv2_ops.resize(_t(x), (64, 64), cv2_ops.INTER_CUBIC).numpy()
    _lsb_gap(got, ref)


def _warp_matrices(w, h):
    out = []
    for ang, sc, tx, ty in [(0, 1, 0.3, 0.7), (0, 1, 1 / 32, 2 / 32),
                            (10, 1.1, 3.3, -2.2), (33, 0.7, 5.1, 4.9),
                            (-71, 1.3, 0.1234, 9.87), (0, 1, 0.5, 0.25)]:
        m = cv2.getRotationMatrix2D((w / 2, h / 2), ang, sc)
        m[0, 2] += tx
        m[1, 2] += ty
        out.append(m)
    return out


def _assert_warp_equal(got, ref):
    """uint8 bit-equal; float32 bit-equal but for the last W % 16
    columns of a row, which cv2 computes apart (within 1e-5)."""
    if got.dtype == np.uint8:
        np.testing.assert_array_equal(got, ref)
        return
    body = ref.shape[1] // 16 * 16
    np.testing.assert_array_equal(got[:, :body], ref[:, :body])
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize('shape', [(48, 64, 3), (37, 53, 3), (41, 29)])
def test_warp_affine_bit_equal(shape):
    h, w = shape[:2]
    for dtype in (np.uint8, np.float32):
        x = _img(4, shape, dtype)
        for m in _warp_matrices(w, h):
            for dsize in ((w, h), (w + 7, h - 5)):
                ref = cv2.warpAffine(x, m, dsize)
                got = cv2_ops.warp_affine(_t(x), m, dsize).numpy()
                _assert_warp_equal(got, ref)


def test_face_util_warps_bit_equal():
    """face_util's three warps: an RGB frame onto the template, a restored
    face and a float mask of ones back by the inverse similarity."""
    from bsvd_tpu_torch.utils.face_util import umeyama_similarity
    rng = np.random.default_rng(5)
    frame = _img(5, (90, 110, 3), smooth=True)
    tmpl = np.array([[686.77, 488.62], [586.77, 493.59], [337.91, 488.39],
                     [437.95, 493.51], [513.58, 678.50]]) / 16
    lm = tmpl * 1.3 + rng.uniform(5, 20, (1, 2)) + rng.normal(0, 1, (5, 2))
    fwd = umeyama_similarity(lm, tmpl)
    inv = umeyama_similarity(tmpl, lm * 2)
    crop = cv2.warpAffine(frame, fwd, (64, 64))
    np.testing.assert_array_equal(
        cv2_ops.warp_affine(_t(frame), fwd, (64, 64)).numpy(), crop)
    np.testing.assert_array_equal(
        cv2_ops.warp_affine(_t(crop), inv, (220, 180)).numpy(),
        cv2.warpAffine(crop, inv, (220, 180)))
    ones = np.ones((64, 64, 3), np.float32)
    _assert_warp_equal(
        cv2_ops.warp_affine(_t(ones), inv, (220, 180)).numpy(),
        cv2.warpAffine(ones, inv, (220, 180)))


@pytest.mark.parametrize('k', [4, 3, 6, 1, 0, 2])
def test_erode_bit_equal(k):
    m = cv2.warpAffine(np.ones((40, 40, 3), np.float32),
                       cv2.getRotationMatrix2D((20, 20), 17, 0.8), (56, 48))
    kern = np.ones((k, k), np.uint8)
    np.testing.assert_array_equal(cv2_ops.erode(_t(m), kern).numpy(),
                                  cv2.erode(m, kern))
    u = _img(6, (31, 45, 3))
    np.testing.assert_array_equal(cv2_ops.erode(_t(u), kern).numpy(),
                                  cv2.erode(u, kern))


@pytest.mark.parametrize('ksize,sigma', [(19, 3.0), (49, 8.0), (23, 3.6),
                                         (37, 6.1), (31, 5.17), (5, 0),
                                         (9, 0), (21, 0)])
def test_gaussian_blur_uint8_bit_equal(ksize, sigma):
    """prepare_hifacegan's blur: ksize 2 * round(3 sigma) + 1, sigma 3-8."""
    x = _img(7, (60, 70, 3))
    ref = cv2.GaussianBlur(x, (ksize, ksize), sigma)
    got = cv2_ops.gaussian_blur(_t(x), (ksize, ksize), sigma).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize('ksize', [51, 21, 13, 7, 5, 3, 1])
def test_gaussian_blur_float32_within_1e5(ksize):
    """usm_sharp's radius-51 blur and face_util's feathering (sigma 0)."""
    x = _img(8, (50, 61, 3), np.float32)
    ref = cv2.GaussianBlur(x, (ksize, ksize), 0)
    got = cv2_ops.gaussian_blur(_t(x), (ksize, ksize), 0).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    # from 7 taps all but the last W * C % 8 values of a row are cv2's
    # bits (3 and 5 taps take cv2's small-kernel path)
    if ksize >= 7:
        tail = (61 * 3) // 8 * 8
        np.testing.assert_array_equal(got.reshape(50, -1)[:, :tail],
                                      ref.reshape(50, -1)[:, :tail])


def test_gaussian_kernel_and_rotation_matrix():
    for n, s in [(7, 7 / 6), (51, 0), (9, 0), (19, 3.0), (11, 0)]:
        np.testing.assert_allclose(cv2_ops.get_gaussian_kernel(n, s),
                                   cv2.getGaussianKernel(n, s),
                                   rtol=1e-14, atol=0)
    for k in (10, 15, 20):
        for ang in (0.0, 33.7, 181.2, 359.9):
            np.testing.assert_array_equal(
                cv2_ops.get_rotation_matrix_2d((k / 2 - 0.5, k / 2 - 0.5),
                                               ang, 1.0),
                cv2.getRotationMatrix2D((k / 2 - 0.5, k / 2 - 0.5), ang,
                                        1.0))


def _motion_kernel(k, ang):
    kern = np.zeros((k, k), np.float32)
    kern[k // 2, :] = 1.0
    rot = cv2.getRotationMatrix2D((k / 2 - 0.5, k / 2 - 0.5), ang, 1.0)
    kern = cv2.warpAffine(kern, rot, (k, k))
    return kern / kern.sum()


@pytest.mark.parametrize('k', range(10, 21))
def test_filter2d_motion_kernels(k):
    """prepare_hifacegan's motion blur: 10-20 taps at a random angle.
    Bit-equal up to 11 x 11; from 12 x 12 cv2 takes a DFT and the port
    stays within 1 LSB on at most 0.1% of pixels."""
    ang = float(np.random.default_rng(k).uniform(0, 360))
    kern = _motion_kernel(k, ang)
    x = _img(9, (96, 104, 3))
    ref = cv2.filter2D(x, -1, kern)
    got = cv2_ops.filter2d(_t(x), -1, _t(kern)).numpy()
    if k <= 11:
        np.testing.assert_array_equal(got, ref)
    else:
        _lsb_gap(got, ref)
    xf = _img(9, (40, 44, 3), np.float32)
    np.testing.assert_allclose(cv2_ops.filter2d(_t(xf), -1, kern).numpy(),
                               cv2.filter2D(xf, -1, kern), rtol=0, atol=1e-5)


def test_cvt_color():
    u = _img(10, (33, 47, 3))
    f = _img(10, (33, 47, 3), np.float32)
    np.testing.assert_array_equal(
        cv2_ops.cvt_color(_t(u), cv2_ops.COLOR_BGR2RGB).numpy(),
        cv2.cvtColor(u, cv2.COLOR_BGR2RGB))
    np.testing.assert_allclose(
        cv2_ops.cvt_color(_t(f), cv2_ops.COLOR_BGR2GRAY).numpy(),
        cv2.cvtColor(f, cv2.COLOR_BGR2GRAY), rtol=0, atol=1e-6)


def test_rejects_what_it_does_not_port():
    x = _t(_img(12, (8, 8, 3)))
    with pytest.raises(NotImplementedError):
        cv2_ops.resize(x, (16, 16), cv2_ops.INTER_AREA)
    with pytest.raises(TypeError):
        cv2_ops.resize(x.float(), (4, 4))
    with pytest.raises(TypeError):
        cv2_ops.warp_affine(x.double(), np.eye(2, 3), (8, 8))
    with pytest.raises(NotImplementedError):
        cv2_ops.cvt_color(x, cv2_ops.COLOR_BGR2GRAY)
    with pytest.raises(NotImplementedError):
        cv2_ops.erode(x, np.eye(3))
    with pytest.raises(ValueError):
        cv2_ops.gaussian_blur(x, (4, 4), 1.0)
