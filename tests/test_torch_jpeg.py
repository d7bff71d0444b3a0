"""The port's JPEG and BMP frames on CPU against libjpeg-turbo (cv2 and the
JAX package): the standard-C++ JPEG decoder (``data/jpeg_decode``) bit for
bit against ``cv2.imread`` (the JAX package's ``open_image``) on every kind
it reads, its windows against the crop of the whole decode and against the
JAX package's libjpeg-turbo ROI decode, its errors; the JPEG writer
(``utils/jpeg_encode``) against ``cv2.imencode``; the committed fixtures
the card's run is held to; the BMP reader against cv2; gray mode (the Y
plane; cv2's BMP conversion); ``open_image`` / ``open_sequence`` on JPEG
folders against the JAX package's.

Tolerances: none. Every decode is integer arithmetic on both sides; the
writer's files decode to the same pixels as cv2's.
"""

import os
import struct

import numpy as np
import pytest

from bsvd_tpu_torch.data import bmp_decode, jpeg_decode, utils_common
from bsvd_tpu_torch.utils.img_util import imwrite
from bsvd_tpu_torch.utils.jpeg_encode import encode_jpeg
from torch_threads import one_torch_thread  # noqa: F401

cv2 = pytest.importorskip('cv2')

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        'fixtures', 'jpeg')
SAMPLING = {'444': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            '422': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            '440': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            '420': cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420}
# kind -> cv2.imwrite flags (quality 95 and 4:2:0 unless given)
KINDS = {
    **{f's{k}': [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, v]
       for k, v in SAMPLING.items()},
    'gray': [],
    'progressive': [cv2.IMWRITE_JPEG_PROGRESSIVE, 1],
    'progressive_s444': [cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                         cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING['444']],
    'progressive_gray': [cv2.IMWRITE_JPEG_PROGRESSIVE, 1],
    'restart3': [cv2.IMWRITE_JPEG_RST_INTERVAL, 3],
    'progressive_restart2': [cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                             cv2.IMWRITE_JPEG_RST_INTERVAL, 2],
    'optimize': [cv2.IMWRITE_JPEG_OPTIMIZE, 1],
    'q50': [cv2.IMWRITE_JPEG_QUALITY, 50],
    'q95': [cv2.IMWRITE_JPEG_QUALITY, 95],
    'q100_s422': [cv2.IMWRITE_JPEG_QUALITY, 100,
                  cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING['422']],
}
CASES = [(k, 37, 53) for k in KINDS] + [
    ('s420', 1, 9), ('s420', 17, 1), ('s422', 17, 1), ('s440', 1, 9),
    ('s444', 1, 1), ('s420', 2, 3), ('s422', 5, 4), ('progressive', 9, 2),
    ('gray', 1, 9)]


def _frame(rng, h, w):
    """Colour waves plus texture, uint8 BGR (h, w, 3)."""
    yy, xx = np.mgrid[0:h, 0:w]
    wave = np.sin(0.3 * xx[..., None] + 0.17 * yy[..., None]
                  + np.arange(3) * 2.1)
    return np.clip(128 + 90 * wave + rng.integers(-30, 31, (h, w, 3)), 0,
                   255).astype(np.uint8)


def _write(path, kind, h, w, seed=0):
    img = _frame(np.random.default_rng(seed), h, w)
    if 'gray' in kind:
        img = img[..., 1]
    assert cv2.imwrite(path, img, KINDS[kind])
    return path


def _cv2_rgb(path):
    return cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)


@pytest.mark.parametrize('kind,h,w', CASES,
                         ids=[f'{k}-{h}x{w}' for k, h, w in CASES])
def test_decoder_matches_libjpeg_turbo(tmp_path, kind, h, w):
    """Whole frames equal cv2.imread (BGR -> RGB) and the JAX package's
    open_image, bit for bit; the dims come from the header."""
    from bsvd_tpu.data.utils_common import open_image
    path = _write(str(tmp_path / 'f.jpg'), kind, h, w)
    got = jpeg_decode.load(path)
    assert got.dtype == np.uint8 and got.shape == (h, w, 3)
    np.testing.assert_array_equal(got, _cv2_rgb(path))
    ref, _, _ = open_image(path, normalize_data=False)
    np.testing.assert_array_equal(got, ref.transpose(1, 2, 0))
    assert jpeg_decode.image_dims(path) == (h, w)


@pytest.mark.parametrize('kind', ['s420', 'restart3', 'progressive', 's440',
                                  's422', 'gray'])
def test_windows_equal_the_whole_decode_and_jax(tmp_path, kind):
    """Random windows equal the crop of the whole decode and the JAX
    package's load_crop_seq (libjpeg-turbo's jpeg_crop_scanline /
    jpeg_skip_scanlines)."""
    from bsvd_tpu.data import native_decode
    paths = [_write(str(tmp_path / f'{i}.jpg'), kind, 75, 98, seed=i)
             for i in range(2)]
    whole = jpeg_decode.load_seq(paths)
    rng = np.random.default_rng(7)
    for _ in range(12):
        ch, cw = int(rng.integers(1, 76)), int(rng.integers(1, 99))
        y0, x0 = int(rng.integers(0, 76 - ch)), int(rng.integers(0, 99 - cw))
        win = utils_common.load_crop_seq(paths, y0, x0, ch, cw)
        np.testing.assert_array_equal(win,
                                      whole[:, y0:y0 + ch, x0:x0 + cw])
        if native_decode.available():
            np.testing.assert_array_equal(
                win, native_decode.load_crop_seq(paths, y0, x0, ch, cw))
    with pytest.raises(IOError, match='outside'):
        jpeg_decode.load_crop_seq(paths[:1], 70, 0, 6, 6)


def _sof_patched(tmp_path, code=None, precision=None, ncomp_cmyk=False,
                 luma=None):
    """A cv2 baseline file with its SOF0 segment changed by hand."""
    _, buf = cv2.imencode('.jpg', _frame(np.random.default_rng(1), 16, 16))
    data = bytearray(buf.tobytes())
    i = data.index(b'\xff\xc0')
    if code is not None:
        data[i + 1] = code
    if precision is not None:
        data[i + 4] = precision
    if luma is not None:
        data[i + 11] = luma                    # first component's h / v
    if ncomp_cmyk:
        data[i + 9] = 4
    path = str(tmp_path / 'f.jpg')
    open(path, 'wb').write(bytes(data))
    return path


@pytest.mark.parametrize('change,match', [
    ({'code': 0xC9}, 'arithmetic.*SOF9'),
    ({'code': 0xCA}, 'arithmetic.*SOF10'),
    ({'code': 0xC3}, 'lossless.*SOF3'),
    ({'code': 0xC1, 'precision': 12}, '12-bit.*SOF1'),
    ({'code': 0xC2, 'precision': 12}, '12-bit.*SOF2'),
    ({'ncomp_cmyk': True}, 'CMYK'),
    ({'luma': 0x41}, 'sampling factors 4x1'),
], ids=['sof9', 'sof10', 'sof3', '12bit', '12bit_progressive', 'cmyk',
        's411'])
def test_unsupported_kinds_raise_naming_the_marker(tmp_path, change, match):
    path = _sof_patched(tmp_path, **change)
    for call in (lambda: jpeg_decode.image_dims(path),
                 lambda: jpeg_decode.load_crop_seq([path], 0, 0, 4, 4)):
        with pytest.raises(jpeg_decode.UnsupportedJPEG, match=match) as e:
            call()
        assert isinstance(e.value, (IOError, NotImplementedError))


def _segments(data):
    """A JPEG's marker segments before its first scan: (code, payload)
    pairs, and the rest of the file from SOS on."""
    pos, segs = 2, []
    while data[pos + 1] != 0xDA:
        length = int.from_bytes(data[pos + 2:pos + 4], 'big')
        segs.append((data[pos + 1], data[pos + 4:pos + 2 + length]))
        pos += 2 + length
    return segs, data[pos:]


def _join(segs, rest):
    return b'\xff\xd8' + b''.join(
        bytes([0xFF, c]) + (len(p) + 2).to_bytes(2, 'big') + p
        for c, p in segs) + rest


def _dqt16(p):
    """A DQT payload of 8-bit tables rewritten as 16-bit ones."""
    out, pos = b'', 0
    while pos < len(p):
        out += bytes([0x10 | p[pos]]) + b''.join(
            int(v).to_bytes(2, 'big') for v in p[pos + 1:pos + 65])
        pos += 65
    return out


_ADOBE = b'Adobe' + bytes([0, 100, 0, 0, 0, 0])
VARIANTS = {
    # 16-bit quantization tables holding the same values
    'dqt16': lambda segs: [(c, _dqt16(p) if c == 0xDB else p)
                           for c, p in segs],
    # a comment and unknown APPn segments among the tables
    'com_app': lambda segs: segs[:1] + [(0xFE, b'a comment'),
                                        (0xE1, b'Exif\0\0junk'),
                                        (0xE9, b'')] + segs[1:],
    # no JFIF, an Adobe APP14 segment with transform 1 (YCbCr)
    'adobe_ycc': lambda segs: [(0xEE, _ADOBE + b'\x01')] + segs[1:],
}


@pytest.mark.parametrize('variant', sorted(VARIANTS) + ['fill_bytes'])
def test_marker_variants_decode_as_the_original(tmp_path, variant):
    """The same coded image behind other marker segments (16-bit DQT, COM
    and APPn, Adobe APP14 transform 1, 0xFF fill bytes before markers)
    decodes to the original's pixels, as libjpeg-turbo does."""
    path = _write(str(tmp_path / 'f.jpg'), 'restart3', 30, 45)
    data = open(path, 'rb').read()
    if variant == 'fill_bytes':
        assert data.count(b'\xff\xd0') == 1                # RST0, one
        seq = data.replace(b'\xff\xdb', b'\xff\xff\xff\xdb')
        seq = seq.replace(b'\xff\xd0', b'\xff\xff\xd0')
    else:
        segs, rest = _segments(data)
        seq = _join(VARIANTS[variant](segs), rest)
    assert seq != data
    other = str(tmp_path / 'v.jpg')
    open(other, 'wb').write(seq)
    np.testing.assert_array_equal(_cv2_rgb(other), _cv2_rgb(path))
    np.testing.assert_array_equal(jpeg_decode.load(other), _cv2_rgb(path))


def test_rgb_coded_jpeg_is_refused(tmp_path):
    """An Adobe APP14 transform 0 file holds RGB, not YCbCr: refused, not
    colour-converted."""
    path = _write(str(tmp_path / 'f.jpg'), 's444', 16, 16)
    segs, rest = _segments(open(path, 'rb').read())
    open(path, 'wb').write(_join([(0xEE, _ADOBE + b'\x00')] + segs[1:],
                                 rest))
    with pytest.raises(jpeg_decode.UnsupportedJPEG, match='RGB'):
        jpeg_decode.load(path)


def test_truncated_and_corrupt_streams_raise_ioerror(tmp_path):
    path = _write(str(tmp_path / 'f.jpg'), 's420', 40, 56)
    data = open(path, 'rb').read()
    for cut in (len(data) // 2, len(data) - 40, 30):
        short = str(tmp_path / f'cut{cut}.jpg')
        open(short, 'wb').write(data[:cut])
        with pytest.raises(IOError) as e:
            jpeg_decode.load(short)
        assert not isinstance(e.value, jpeg_decode.UnsupportedJPEG)
    bad = str(tmp_path / 'bad.jpg')
    open(bad, 'wb').write(b'\xff\xd8\xff\xdb\x00\x03\x25')  # table 5
    with pytest.raises(IOError, match='bad DQT'):
        jpeg_decode.load(bad)
    # a DHT with three 1-bit codes (and one with the all-ones 1-bit code)
    for counts in (b'\x03', b'\x02'):
        dht = b'\x00' + counts + b'\x00' * 15 + bytes(counts[0])
        open(bad, 'wb').write(b'\xff\xd8\xff\xc4' + (len(dht) + 2).to_bytes(
            2, 'big') + dht)
        with pytest.raises(IOError, match='Huffman table'):
            jpeg_decode.load(bad)
    open(bad, 'wb').write(b'not a jpeg')
    with pytest.raises(IOError, match='SOI'):
        jpeg_decode.image_dims(bad)


ENC_CASES = [(q, s) for q in (75, 90, 95) for s in ('4:2:0', '4:2:2',
                                                     '4:4:4')] + \
    [(95, '4:4:0'), (100, '4:2:0'), (30, '4:2:2')]


@pytest.mark.parametrize('quality,sampling', ENC_CASES,
                         ids=[f'q{q}-{s}' for q, s in ENC_CASES])
def test_writer_decodes_as_cv2s_own_file(quality, sampling):
    """cv2.imdecode of the port's file equals that of cv2.imencode's at
    the same quality and sampling (the quantized coefficients are
    libjpeg-turbo's), at odd and tiny sizes and in gray."""
    rng = np.random.default_rng(quality)
    flag = SAMPLING[sampling.replace(':', '')]
    for h, w in ((37, 53), (1, 9), (17, 1), (16, 24)):
        img = _frame(rng, h, w)
        _, ref = cv2.imencode('.jpg', img, [
            cv2.IMWRITE_JPEG_QUALITY, quality,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, flag])
        ours = encode_jpeg(img[..., ::-1], quality, sampling)
        np.testing.assert_array_equal(
            cv2.imdecode(np.frombuffer(ours, np.uint8), cv2.IMREAD_COLOR),
            cv2.imdecode(ref, cv2.IMREAD_COLOR))
    gray = _frame(rng, 23, 31)[..., 0]
    _, ref = cv2.imencode('.jpg', gray, [cv2.IMWRITE_JPEG_QUALITY, quality])
    np.testing.assert_array_equal(
        cv2.imdecode(np.frombuffer(encode_jpeg(gray, quality), np.uint8),
                     cv2.IMREAD_UNCHANGED),
        cv2.imdecode(ref, cv2.IMREAD_UNCHANGED))


def test_imwrite_jpeg_takes_cv2s_flags(tmp_path):
    """imwrite(.jpg) with cv2's flag list reads back as cv2.imwrite's file;
    4:1:1, unknown flags and auto_mkdir=False into a missing folder
    raise."""
    img = _frame(np.random.default_rng(3), 21, 30)
    params = [cv2.IMWRITE_JPEG_QUALITY, 80, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
              cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422]
    ours, ref = str(tmp_path / 'a' / 'o.jpg'), str(tmp_path / 'r.jpg')
    assert imwrite(img, ours, params)
    cv2.imwrite(ref, img, params)
    np.testing.assert_array_equal(cv2.imread(ours), cv2.imread(ref))
    with pytest.raises(ValueError, match='4:1:1'):
        imwrite(img, ours, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                            cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411])
    with pytest.raises(ValueError, match='flag 4 '):
        imwrite(img, ours, [cv2.IMWRITE_JPEG_RST_INTERVAL, 2])
    with pytest.raises(IOError):
        imwrite(img, str(tmp_path / 'missing' / 'f.jpg'), auto_mkdir=False)
    imwrite(img, str(tmp_path / 'p.png'), [cv2.IMWRITE_PNG_COMPRESSION, 1])
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / 'p.png')), img)


def test_fixtures_are_cv2s_decode():
    """The committed fixtures (tools/make_jpeg_fixtures.py) still decode
    here as their .npz holds, by cv2 and by the port; the card's run is
    held to the same .npz."""
    ref = np.load(os.path.join(FIXTURES, 'decoded.npz'))
    assert len(ref.files) == 8
    for name in ref.files:
        path = os.path.join(FIXTURES, f'{name}.jpg')
        np.testing.assert_array_equal(_cv2_rgb(path), ref[name])
        np.testing.assert_array_equal(jpeg_decode.load(path), ref[name])


@pytest.mark.parametrize('expand', [False, True])
def test_open_image_and_sequence_on_jpeg_equal_jax(tmp_path, expand):
    """open_image (float and uint8) and open_sequence of a JPEG folder of
    odd-sized frames, with and without expand_if_needed, in colour and in
    gray_mode, equal the JAX package's; the frames take the JPEG route."""
    from bsvd_tpu.data import utils_common as jax_uc
    for i in range(3):
        _write(str(tmp_path / f'{i}.jpg'), 's420', 21, 33, seed=i)
    path = str(tmp_path / '1.jpg')
    for norm in (True, False):
        got = utils_common.open_image(path, expand_if_needed=expand,
                                      normalize_data=norm)
        ref = jax_uc.open_image(path, expand_if_needed=expand,
                                normalize_data=norm)
        assert got[1:] == ref[1:] == (expand, expand)
        assert got[0].dtype == ref[0].dtype
        np.testing.assert_array_equal(got[0], ref[0])
    before = utils_common.ROUTES['jpeg_decode']
    got = utils_common.open_sequence(str(tmp_path), expand_if_needed=expand,
                                     max_num_fr=2)
    ref = jax_uc.open_sequence(str(tmp_path), expand_if_needed=expand,
                               max_num_fr=2)
    assert utils_common.ROUTES['jpeg_decode'] == before + 2
    assert got[1:] == ref[1:] and got[0].shape == (2, 3, 21 + expand,
                                                   33 + expand)
    np.testing.assert_array_equal(got[0], ref[0])
    # gray_mode: the Y plane, as the JAX package's cv2.IMREAD_GRAYSCALE
    for norm in (True, False):
        got = utils_common.open_image(path, True, expand, norm)
        ref = jax_uc.open_image(path, True, expand, norm)
        assert got[1:] == ref[1:] and got[0].dtype == ref[0].dtype
        assert got[0].shape == (1, 21 + expand, 33 + expand)
        np.testing.assert_array_equal(got[0], ref[0])
    got = utils_common.open_sequence(str(tmp_path), True, expand, 3)
    ref = jax_uc.open_sequence(str(tmp_path), True, expand, 3)
    assert got[1:] == ref[1:] and got[0].shape == (3, 1, 21 + expand,
                                                   33 + expand)
    np.testing.assert_array_equal(got[0], ref[0])


@pytest.mark.parametrize('kind,h,w', CASES,
                         ids=[f'{k}-{h}x{w}' for k, h, w in CASES])
def test_gray_mode_is_the_y_plane(tmp_path, kind, h, w):
    """load_gray equals cv2.IMREAD_GRAYSCALE (libjpeg's JCS_GRAYSCALE: Y
    alone, the chroma never upsampled), its windows the crop of it."""
    path = _write(str(tmp_path / 'f.jpg'), kind, h, w)
    got = jpeg_decode.load_gray(path)
    np.testing.assert_array_equal(got, cv2.imread(path,
                                                  cv2.IMREAD_GRAYSCALE))
    y0, x0 = h // 3, w // 4
    ch, cw = max(1, h - y0 - 1), max(1, w - x0 - 2)
    np.testing.assert_array_equal(
        jpeg_decode.load_crop_seq([path, path], y0, x0, ch, cw, gray=True),
        np.stack([got[y0:y0 + ch, x0:x0 + cw]] * 2))


def _own_bmp(path, rgb, bpp, top_down=False, palette=None, info=40):
    """A BI_RGB BMP written by hand (cv2 writes bottom-up files only)."""
    h, w = rgb.shape[:2]
    stride = (w * bpp + 31) // 32 * 4
    rows = np.zeros((h, stride), np.uint8)
    if bpp == 8:
        rows[:, :w] = rgb
    else:
        px = rgb[..., ::-1]
        if bpp == 32:
            px = np.concatenate([px, np.full((h, w, 1), 7, np.uint8)], -1)
        rows[:, :w * bpp // 8] = px.reshape(h, -1)
    if not top_down:
        rows = rows[::-1]
    pal = b'' if palette is None else np.concatenate(
        [palette[:, ::-1], np.zeros((len(palette), 1), np.uint8)],
        1).tobytes()
    hdr = struct.pack('<IiiHHIIiiII', info, w, -h if top_down else h, 1, bpp,
                      0, rows.size, 2835, 2835,
                      0 if palette is None else len(palette), 0)
    hdr += b'\0' * (info - 40)
    off = 14 + len(hdr) + len(pal)
    open(path, 'wb').write(b'BM' + struct.pack('<IHHI', off + rows.size, 0, 0,
                                               off) + hdr + pal
                           + rows.tobytes())


_RNG = np.random.default_rng(9)
_BMP_IMG = _RNG.integers(0, 256, (13, 7, 3), dtype=np.uint8)
_PAL = _RNG.integers(0, 256, (40, 3), dtype=np.uint8)
BMP_KINDS = {
    'cv2_24': lambda p: cv2.imwrite(p, _BMP_IMG[..., ::-1]),
    'cv2_32': lambda p: cv2.imwrite(p, np.concatenate(
        [_BMP_IMG[..., ::-1], _BMP_IMG[..., :1]], -1)),
    'cv2_gray8': lambda p: cv2.imwrite(p, _BMP_IMG[..., 0]),
    'top_down_24': lambda p: _own_bmp(p, _BMP_IMG, 24, top_down=True),
    'bottom_up_32': lambda p: _own_bmp(p, _BMP_IMG, 32),
    'top_down_32_v5': lambda p: _own_bmp(p, _BMP_IMG, 32, True, info=124),
    'palette8': lambda p: _own_bmp(p, _BMP_IMG[..., 0] % 40, 8,
                                   palette=_PAL),
    'palette8_top_down_v4': lambda p: _own_bmp(
        p, _BMP_IMG[..., 1] % 40, 8, True, _PAL, info=108),
}


@pytest.mark.parametrize('kind', sorted(BMP_KINDS))
def test_bmp_reader_matches_cv2(tmp_path, kind):
    path = str(tmp_path / 'f.bmp')
    BMP_KINDS[kind](path)
    got = bmp_decode.load(path)
    np.testing.assert_array_equal(got, _cv2_rgb(path))
    assert bmp_decode.image_dims(path) == got.shape[:2] == (13, 7)
    np.testing.assert_array_equal(bmp_decode.load_crop(path, 3, 2, 9, 4),
                                  got[3:12, 2:6])
    assert utils_common.route(path) == 'bmp_decode'


@pytest.mark.parametrize('kind', sorted(BMP_KINDS))
def test_bmp_gray_matches_cv2(tmp_path, kind):
    """gray_mode on BMP: cv2's conversion (fixed point for 24-bit pixels and
    palettes, float32 for 32-bit pixels), as the JAX package reads it."""
    from bsvd_tpu.data.utils_common import open_image as jax_open_image
    path = str(tmp_path / 'f.bmp')
    BMP_KINDS[kind](path)
    np.testing.assert_array_equal(bmp_decode.load_gray(path),
                                  cv2.imread(path, cv2.IMREAD_GRAYSCALE))
    got = utils_common.open_image(path, True, True)
    ref = jax_open_image(path, True, True)
    assert got[1:] == ref[1:] == (True, True)
    np.testing.assert_array_equal(got[0], ref[0])


def test_bmp_reader_refuses_other_kinds(tmp_path):
    path = str(tmp_path / 'f.bmp')
    _own_bmp(path, _BMP_IMG, 24)
    data = bytearray(open(path, 'rb').read())
    rle = bytearray(data)
    rle[30] = 1                                       # BI_RLE8
    open(path, 'wb').write(bytes(rle))
    with pytest.raises(bmp_decode.UnsupportedBMP, match='compression 1'):
        bmp_decode.load(path)
    open(path, 'wb').write(bytes(data[:-10]))
    with pytest.raises(IOError, match='truncated'):
        bmp_decode.load(path)
