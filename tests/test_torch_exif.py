"""EXIF orientation on the port's cv2 routes against the JAX package's,
which read through cv2 5.0 (``cv2.imread`` / ``cv2.imdecode`` turn an
image by its orientation tag in colour and gray mode, not in unchanged
mode), on a 32 x 48 image made from seeded numpy and written by the
port's JPEG and PNG writers, the tag put in an APP1 ``Exif`` segment or
an ``eXIf`` chunk (``tests/exif_util.py``):

- all 8 orientations, in both byte orders, through ``open_image`` (colour
  and gray), ``open_sequence(gray_mode=True)``,
  ``open_sequence(expand_if_needed=True)`` (also on a 33-row image: the
  turn comes before the expansion), ``imfrombytes`` in every mode and
  ``imsize``;
- the routes that stay unturned, as in the JAX package: the default
  ``open_sequence`` (its native decoder) and the train loader's window
  reader (``load_crop_seq``);
- malformed Exif (truncated, a bad byte order or mark, an IFD past the
  end, a cut entry, a string or rational value past the end before the
  orientation entry) read as cv2 reads it: orientation 1, unless a whole
  orientation entry came before the fault.

Everything must be the same bits.
"""

import os

import numpy as np
import pytest

from exif_util import jpeg_with, png_with, tiff

from bsvd_tpu_torch.data import orientation
from bsvd_tpu_torch.data import utils_common as port
from bsvd_tpu_torch.utils import img_util
from bsvd_tpu_torch.utils.jpeg_encode import encode_jpeg

jax_uc = pytest.importorskip('bsvd_tpu.data.utils_common')
cv2 = pytest.importorskip('cv2')


def _image(h=32, w=48, seed=0):
    """Smooth colour ramps with noise: a picture whose turns all differ."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([yy * 200 // h, xx * 200 // w, (yy + xx) * 100 // (h + w)],
                   -1) + rng.integers(0, 50, (h, w, 3))
    return img.astype(np.uint8)


def _base(kind, h=32, w=48):
    img = _image(h, w)
    if kind == 'jpg':
        return encode_jpeg(img, 95)
    return img_util.encode_png(img[..., ::-1])


def _tagged(kind, data, **kw):
    base = _base(kind, **kw)
    return jpeg_with(base, data) if kind == 'jpg' else png_with(base, data)


def _write(folder, kind, data, n=1):
    os.makedirs(folder, exist_ok=True)
    paths = []
    for i in range(n):
        paths.append(os.path.join(folder, f'{i:08d}.{kind}'))
        with open(paths[-1], 'wb') as f:
            f.write(data)
    return paths


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.dtype == want.dtype
    assert np.array_equal(got, want)


CASES = [(k, o, order) for k in ('jpg', 'png') for o in range(1, 9)
         for order in ('II', 'MM')]


@pytest.mark.parametrize('kind,orient,order', CASES,
                         ids=[f'{k}-{o}-{b}' for k, o, b in CASES])
def test_cv2_routes_turn_as_jax(tmp_path, kind, orient, order):
    data = _tagged(kind, tiff(orient, order))
    path, = _write(str(tmp_path / 'clip'), kind, data)
    assert orientation.file_orientation(path) == orient
    assert orientation.buffer_orientation(data) == orient
    for gray in (False, True):
        for expand in (False, True):
            got = port.open_image(path, gray_mode=gray,
                                  expand_if_needed=expand)
            want = jax_uc.open_image(path, gray_mode=gray,
                                     expand_if_needed=expand)
            _same(got[0], want[0])
            assert got[1:] == want[1:]
    for kw in ({'gray_mode': True}, {'expand_if_needed': True}):
        got = port.open_sequence(str(tmp_path / 'clip'), **kw)
        want = jax_uc.open_sequence(str(tmp_path / 'clip'), **kw)
        _same(got[0], want[0])
        assert got[1:] == want[1:]
    assert port.open_image_dims(path) == want[0].shape[-2:]
    from bsvd_tpu.utils.img_util import imfrombytes as jax_imfrombytes
    for flag in ('color', 'grayscale', 'unchanged'):
        for f32 in (False, True):
            _same(img_util.imfrombytes(data, flag, f32),
                  jax_imfrombytes(data, flag, f32))
    assert img_util.imsize(data) == jax_imfrombytes(data).shape[:2]


@pytest.mark.parametrize('kind', ['jpg', 'png'])
def test_turn_comes_before_the_expansion(tmp_path, kind):
    """A 33 x 48 frame turned by 6 is 48 x 33: the width is expanded."""
    data = _tagged(kind, tiff(6), h=33)
    path, = _write(str(tmp_path / 'clip'), kind, data, 1)
    for gray in (False, True):
        got = port.open_image(path, gray_mode=gray, expand_if_needed=True)
        want = jax_uc.open_image(path, gray_mode=gray, expand_if_needed=True)
        _same(got[0], want[0])
        assert got[1:] == want[1:] == (False, True)


@pytest.mark.parametrize('kind', ['jpg', 'png'])
def test_native_routes_stay_unturned(tmp_path, kind):
    """The default open_sequence (the JAX package's native decoder) and the
    train loader's window reader keep the stored pixels."""
    from bsvd_tpu.data import native_decode
    if not native_decode.available():
        pytest.skip('the JAX package\'s native decoder is not built here')
    clip = str(tmp_path / 'clip')
    paths = _write(clip, kind, _tagged(kind, tiff(6)), 3)
    got = port.open_sequence(clip)
    want = jax_uc.open_sequence(clip)
    _same(got[0], want[0])
    assert got[0].shape == (3, 3, 32, 48)
    _same(port.load_crop_seq(paths, 3, 5, 16, 24),
          native_decode.load_crop_seq(paths, 3, 5, 16, 24))
    assert port.image_dims(paths[0]) == (32, 48)


MALFORMED = {
    'truncated_ifd': tiff(6)[:12],
    'bad_byte_order': b'XX' + tiff(6)[2:],
    'bad_mark': tiff(6)[:2] + b'\x2b\x00' + tiff(6)[4:],
    'ifd_past_end': tiff(6)[:4] + (999).to_bytes(4, 'little') + tiff(6)[8:],
    'cut_after_another_entry': tiff(entries=[(0x0100, 3, 1, 6),
                                             (0x0112, 3, 1, 6)])[:30],
    'empty': b'',
    # cv2 keeps an entry read before the fault: these read 6, not 1
    'whole_entry_then_cut': tiff(entries=[(0x0112, 3, 1, 6),
                                          (0x010f, 2, 40, 0)])[:30],
    'count_past_the_end': tiff(6, count=5),
    'first_of_two': tiff(entries=[(0x0112, 3, 1, 6), (0x0112, 3, 1, 3)]),
    # values cv2 reads before the orientation: out of bounds, the walk
    # stops (1); in bounds or inline, it goes on (6)
    'make_past_the_end': tiff(entries=[(0x010f, 2, 40, 999),
                                       (0x0112, 3, 1, 6)]),
    'xresolution_past_the_end': tiff(entries=[(0x011a, 5, 1, 31),
                                              (0x0112, 3, 1, 6)]),
    'resolution_unit_cut': tiff(entries=[(0x0128, 3, 1, 2)], count=2),
    'make_inline': tiff(entries=[(0x010f, 2, 4, 0x4142),
                                 (0x0112, 3, 1, 6)]),
    'xresolution_in_bounds': tiff(entries=[(0x011a, 5, 1, 8),
                                           (0x0112, 3, 1, 6)]),
}


@pytest.mark.parametrize('kind', ['jpg', 'png'])
@pytest.mark.parametrize('case', sorted(MALFORMED))
def test_malformed_exif_reads_as_cv2_reads_it(tmp_path, kind, case):
    from bsvd_tpu.utils.img_util import imfrombytes as jax_imfrombytes
    data = _tagged(kind, MALFORMED[case])
    path, = _write(str(tmp_path / 'c'), kind, data)
    want_o = 6 if case in ('whole_entry_then_cut', 'count_past_the_end',
                           'first_of_two', 'make_inline',
                           'xresolution_in_bounds') else 1
    assert orientation.buffer_orientation(data) == want_o
    _same(port.open_image(path)[0], jax_uc.open_image(path)[0])
    _same(img_util.imfrombytes(data), jax_imfrombytes(data))
    assert img_util.imsize(data) == jax_imfrombytes(data).shape[:2]


def test_tag_placement_as_cv2():
    """JPEG: the first APP1 that starts with Exif\\0\\0, other APP1s
    skipped; PNG: eXIf after IDAT too, an Exif\\0\\0 prefix refused."""
    from bsvd_tpu.utils.img_util import imfrombytes as jax_imfrombytes
    jpg = _base('jpg')
    xmp = jpeg_with(b'\xff\xd8', b'<x/>',
                    b'http://ns.adobe.com/xap/1.0/\0')[2:]
    cases = [jpg[:2] + xmp + jpeg_with(jpg, tiff(6))[2:],
             jpeg_with(jpg, tiff(6), b'Exif\0\1'),
             jpeg_with(jpeg_with(jpg, tiff(3)), tiff(6)),
             png_with(_base('png'), tiff(8), after_idat=True),
             png_with(_base('png'), b'Exif\0\0' + tiff(8))]
    for data, want in zip(cases, (6, 1, 6, 8, 1)):
        assert orientation.buffer_orientation(data) == want
        _same(img_util.imfrombytes(data), jax_imfrombytes(data))


def test_orient_is_cv2s_transform():
    """orient / oriented_dims on an odd-sized gray and colour image against
    cv2's flips and transposes, and the BMP route (no tag)."""
    img = _image(5, 7)
    cv = {2: lambda a: cv2.flip(a, 1), 3: lambda a: cv2.flip(a, -1),
          4: lambda a: cv2.flip(a, 0), 5: cv2.transpose,
          6: lambda a: cv2.flip(cv2.transpose(a), 1),
          7: lambda a: cv2.flip(cv2.transpose(a), -1),
          8: lambda a: cv2.flip(cv2.transpose(a), 0)}
    for o in range(0, 10):
        for a in (img, img[..., 0]):
            want = cv[o](a) if o in cv else a
            _same(orientation.orient(a, o), want)
            assert orientation.oriented_dims(5, 7, o) == want.shape[:2]
    ok, bmp = cv2.imencode('.bmp', img)
    assert orientation.buffer_orientation(bmp.tobytes()) == 1
