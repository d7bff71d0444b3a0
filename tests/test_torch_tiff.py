"""The port's TIFF frames on CPU against the JAX package's cv2 routes
(libtiff): ``data/tiff_decode`` on every committed fixture
(``tools/make_tiff_fixtures.py``: cv2's files with compression 1, 5, 8,
32946 and 32773, 8- and 16-bit gray, RGB and RGBA; hand-built tiles, MM
byte order, PlanarConfiguration 2, the old LZW bit order, tag 274 at every
value) through ``open_image`` / ``open_sequence`` / ``imfrombytes`` /
``imsize``; the cases it refuses, by tag; the ``.tif`` writer read back by
cv2 and by the reader; ``ValFolderDataset``, ``test_pipeline``'s CSVs and
the train loader on ``.tif`` folders.

Tolerances: none but the CSVs' (``test_torch_eval``'s metric
tolerances: the two packages' nets differ in fp32 summation order).
Frames are integer decodes: equal bit for bit.

Where cv2 itself fails, the port does not copy it (each pinned below):
``cv2.imread`` gives None for a frame tagged 5-8 that is not square
(``cv2.imdecode`` turns it); cv2 reads 16-bit PlanarConfiguration 2
planes under IMREAD_UNCHANGED as if interleaved (the port refuses).
"""

import copy
import glob
import os
import re
import shutil
import sys

import numpy as np
import pytest

from bsvd_tpu_torch.data import build_dataset, tiff_decode, utils_common
from bsvd_tpu_torch.data.orientation import orient
from bsvd_tpu_torch.data.video_train_loader import train_video_loader
from bsvd_tpu_torch.utils import img_util
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from tools.make_tiff_fixtures import write_tiff  # noqa: E402

cv2 = pytest.importorskip('cv2')
jax_uc = pytest.importorskip('bsvd_tpu.data.utils_common')
jax_iu = pytest.importorskip('bsvd_tpu.utils.img_util')

FIXTURES = sorted(glob.glob(os.path.join(ROOT, 'tests', 'fixtures', 'tiff',
                                         '*.tif')))
NAMES = [os.path.basename(p)[:-4] for p in FIXTURES]
# cv2.imread gives None (a non-square frame tagged 5-8)
IMREAD_FAILS = {n for n in NAMES
                if re.fullmatch(r'orient[5-8]_rgb(8|16)', n)}
# cv2 misreads (16-bit planes under IMREAD_UNCHANGED): the port refuses
REFUSED_UNCHANGED = {'planar2_rgb16_deflate_pred'}


def test_fixtures_are_all_there():
    assert len(FIXTURES) == 40
    assert {'cv2_rgb8_lzw', 'tiles_rgb8_lzw_pred', 'mm_rgb16_lzw_pred',
            'planar2_rgb8_lzw', 'lzw_compat_rgb8', 'orient8_rgb8',
            'cv2_rgb8_adobe', 'cv2_gray8_packbits'} <= set(NAMES)


@pytest.mark.parametrize('path', FIXTURES, ids=NAMES)
def test_imfrombytes_and_imsize_match_jax(path):
    """Each flag bit for bit against JAX's cv2.imdecode (16-bit colour
    round(v / 257), 16-bit gray v >> 8, unassociated alpha premultiplied,
    tag 274 applied under 'unchanged' too); imsize = the colour image's
    (H, W)."""
    name = os.path.basename(path)[:-4]
    data = open(path, 'rb').read()
    for flag in ('color', 'grayscale', 'unchanged'):
        if flag == 'unchanged' and name in REFUSED_UNCHANGED:
            with pytest.raises(tiff_decode.UnsupportedTIFF, match='tag 284'):
                img_util.imfrombytes(data, flag)
            ref = jax_iu.imfrombytes(data, flag)
            planes = tiff_decode.decode(data, 'color')
            assert ref.dtype == np.uint16 and not np.array_equal(
                (ref[..., ::-1].astype(np.int64) + 128) // 257, planes)
            continue
        ref = jax_iu.imfrombytes(data, flag)
        got = img_util.imfrombytes(data, flag)
        assert got.dtype == ref.dtype and got.shape == ref.shape, flag
        np.testing.assert_array_equal(got, ref)
    assert img_util.imsize(data) == jax_iu.imfrombytes(data).shape[:2]
    f32 = img_util.imfrombytes(data, 'color', float32=True)
    np.testing.assert_array_equal(f32, jax_iu.imfrombytes(data, 'color',
                                                          float32=True))


@pytest.mark.parametrize('path', FIXTURES, ids=NAMES)
def test_open_image_and_sequence_match_jax(path, tmp_path):
    """open_image, and open_sequence of a folder of two copies, in colour,
    gray and expand mode against JAX's cv2.imread route; where cv2.imread
    gives None (tags 5-8, not square) JAX raises and the port turns the
    frame as cv2.imdecode does."""
    name = os.path.basename(path)[:-4]
    for i in range(2):
        shutil.copy(path, tmp_path / f'{i}.tif')
    for kw in ({}, {'gray_mode': True}, {'expand_if_needed': True}):
        got = utils_common.open_image(path, **kw)
        seq = utils_common.open_sequence(str(tmp_path), **kw)
        assert seq[1:] == got[1:]
        np.testing.assert_array_equal(seq[0], np.stack([got[0]] * 2))
        if name in IMREAD_FAILS:
            for call in (lambda: jax_uc.open_image(path, **kw),
                         lambda: jax_uc.open_sequence(str(tmp_path), **kw)):
                with pytest.raises(IOError, match='cannot read'):
                    call()
            flag = 'grayscale' if kw.get('gray_mode') else 'color'
            want = jax_iu.imfrombytes(open(path, 'rb').read(), flag)
            want = want[None] if want.ndim == 2 else \
                np.transpose(want[..., ::-1], (2, 0, 1))
            if kw.get('expand_if_needed'):
                want = utils_common._expand(want, True)[0]
            np.testing.assert_array_equal(got[0], np.float32(want / 255.))
            continue
        ref = jax_uc.open_image(path, **kw)
        assert got[1:] == ref[1:]
        assert got[0].dtype == ref[0].dtype
        np.testing.assert_array_equal(got[0], ref[0])
        ref = jax_uc.open_sequence(str(tmp_path), **kw)
        assert seq[1:] == ref[1:]
        np.testing.assert_array_equal(seq[0], ref[0])
    assert utils_common.open_image_dims(path) == \
        utils_common.open_image(path)[0].shape[1:]


def test_readers_keep_the_stored_pixels():
    """decode / load / load_crop / buffer_dims are the stored pixels (the
    cv2 routes turn them): a frame tagged 6 decodes untransposed."""
    path = FIXTURES[NAMES.index('orient6_rgb8')]
    data = open(path, 'rb').read()
    rgb = tiff_decode.decode(data)
    assert tiff_decode.buffer_dims(data) == tiff_decode.image_dims(path) \
        == rgb.shape[:2] == (6, 9)
    want = jax_iu.imfrombytes(data)[..., ::-1]
    np.testing.assert_array_equal(orient(rgb, 6), want)
    np.testing.assert_array_equal(tiff_decode.load(path), rgb)
    np.testing.assert_array_equal(tiff_decode.load_crop(path, 1, 2, 4, 5),
                                  rgb[1:5, 2:7])


@pytest.mark.parametrize('name', ['cv2_rgb8_strips_lzw', 'tiles_rgb8_lzw_pred',
                                  'planar2_tiles_rgb8', 'mm_rgb16_lzw_pred',
                                  'tiles_gray16_deflate'])
def test_window_crop_equals_the_crop_of_the_frame(name):
    """A window decodes only its strips or tiles: equal to the crop of the
    whole frame, in colour and gray, at windows that start and end inside
    strips / tiles and across them."""
    path = FIXTURES[NAMES.index(name)]
    whole, gray = tiff_decode.load(path), tiff_decode.load_gray(path)
    h, w = whole.shape[:2]
    for y0, x0, ch, cw in ((0, 0, h, w), (1, 3, h - 5, w - 7),
                           (h - 4, w - 6, 4, 6), (5, 0, 1, w)):
        np.testing.assert_array_equal(
            tiff_decode.load_crop(path, y0, x0, ch, cw),
            whole[y0:y0 + ch, x0:x0 + cw])
        np.testing.assert_array_equal(
            tiff_decode.load_crop(path, y0, x0, ch, cw, gray=True),
            gray[y0:y0 + ch, x0:x0 + cw])
    with pytest.raises(IOError, match='outside'):
        tiff_decode.load_crop(path, 1, 0, h, w)


_IMG = np.random.default_rng(5).integers(0, 256, (10, 12, 3)).astype(
    np.uint8)


@pytest.mark.parametrize('kw,tag', [
    (dict(compression=7), 'tag 259 .* = 7'),
    (dict(compression=6), 'tag 259 .* = 6'),
    (dict(compression=34712), 'tag 259 .* = 34712'),
    (dict(photometric=6), 'tag 262 .* = 6'),
    (dict(photometric=3), 'tag 262 .* = 3'),
    (dict(photometric=0, gray=True), 'tag 262 .* = 0'),
    (dict(photometric=5, samples=4), 'tag 262 .* = 5'),
    (dict(predictor=3), 'tag 317 .* = 3'),
    (dict(tags={339: (3, [3, 3, 3])}), r'tag 339 .* = \(3, 3, 3\)'),
    (dict(tags={339: (3, [2, 2, 2])}), r'tag 339 .* = \(2, 2, 2\)'),
    (dict(tags={258: (3, [4, 4, 4])}), r'tag 258 .* = \(4, 4, 4\)'),
    (dict(tags={266: (3, [2])}), 'tag 266 .* = 2'),
    (dict(samples=2, gray=True), 'tag 277 .* = 2'),
    (dict(page=1), 'page 1'),
], ids=['jpeg', 'old_jpeg', 'jpeg2000', 'ycbcr', 'palette', 'min_is_white',
        'cmyk', 'float_predictor', 'float_samples', 'signed_samples',
        'bits4', 'fill_order', 'gray_alpha', 'second_page'])
def test_unsupported_tiffs_raise_naming_the_tag(kw, tag):
    """Each kind the reader does not read raises UnsupportedTIFF (an
    IOError and a NotImplementedError) naming the tag and its value, from
    every entry point that reads the header."""
    kw = dict(kw)
    img = _IMG
    if kw.pop('gray', False):
        img = img[..., 0]
    n = kw.pop('samples', None)
    if n == 4:
        img = np.concatenate([img, img[..., :1]], -1)
    elif n == 2:
        img = np.stack([img, img], -1)
    page = kw.pop('page', 0)
    data = write_tiff(img, pages=2 if page else 1, **kw)
    calls = [lambda: tiff_decode.decode(data, page=page)]
    if not page:
        calls += [lambda: tiff_decode.buffer_dims(data),
                  lambda: img_util.imfrombytes(data),
                  lambda: img_util.imsize(data)]
    for call in calls:
        with pytest.raises(tiff_decode.UnsupportedTIFF, match=tag) as e:
            call()
        assert isinstance(e.value, IOError) and \
            isinstance(e.value, NotImplementedError)
    if page:         # the first page of a two-page file reads as cv2's
        np.testing.assert_array_equal(img_util.imfrombytes(data),
                                      jax_iu.imfrombytes(data))


def _set_entry(raw, tag, value):
    """Set the one-LONG value of IFD0's entry ``tag`` in II bytes."""
    ifd = int.from_bytes(raw[4:8], 'little')
    for i in range(int.from_bytes(raw[ifd:ifd + 2], 'little')):
        e = ifd + 2 + 12 * i
        if int.from_bytes(raw[e:e + 2], 'little') == tag:
            raw[e + 8:e + 12] = value.to_bytes(4, 'little')
            return
    raise KeyError(tag)


def test_broken_files_raise_ioerror():
    """Truncated data, a cut directory, a strip past the end and a corrupt
    LZW stream raise IOError (not UnsupportedTIFF). cv2 gives None for
    each, except the LZW stream, whose strip it zero-fills and goes on
    (libtiff logs "not enough data"): the port does not copy that. An
    uncompressed strip whose byte count is too small reads whole, as
    libtiff reads it."""
    good = write_tiff(_IMG, compression=5, predictor=2, rows_per_strip=3)
    cases = {'signature': b'II+\0' + good[4:], 'no_ifd': good[:8],
             'cut_directory': good[:len(good) - 30]}
    lzw = bytearray(good)
    lzw[9:20] = b'\xff' * 11                 # codes past the table
    cases['lzw_table'] = bytes(lzw)
    raw = bytearray(write_tiff(_IMG))
    _set_entry(raw, 279, len(_IMG.tobytes()) - 7)       # StripByteCounts
    np.testing.assert_array_equal(img_util.imfrombytes(bytes(raw)),
                                  jax_iu.imfrombytes(bytes(raw)))
    _set_entry(raw, 273, len(raw) - 10)                 # StripOffsets
    cases['strip_past_end'] = bytes(raw)
    for name, data in cases.items():
        with pytest.raises(IOError) as e:
            tiff_decode.decode(data)
        assert not isinstance(e.value, tiff_decode.UnsupportedTIFF), name
        ref = jax_iu.imfrombytes(data)
        if name == 'lzw_table':
            assert not ref[:3].any() and ref[3:].any()
        else:
            assert ref is None, name


@pytest.mark.parametrize('dtype,channels', [(np.uint8, 3), (np.uint8, 1),
                                            (np.uint8, 4), (np.uint16, 3)])
def test_tiff_writer_reads_back_through_cv2_and_the_reader(
        tmp_path, dtype, channels):
    """imwrite('.tif') as cv2.imwrite writes by default (LZW, predictor 2,
    ~8 KB strips, II), and with IMWRITE_TIFF_COMPRESSION 1 and 8: cv2 and
    the port's reader give back what was written; other values raise."""
    top = 256 if dtype == np.uint8 else 65536
    shape = (37, 700) + ((channels,) if channels > 1 else ())
    img = np.random.default_rng(6).integers(0, top, shape).astype(dtype)
    for params in (None, [img_util.IMWRITE_TIFF_COMPRESSION, 1],
                   [img_util.IMWRITE_TIFF_COMPRESSION, 8]):
        path = str(tmp_path / 'f.tif')
        img_util.imwrite(img, path, params)
        np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED),
                                      img)
        data = open(path, 'rb').read()
        np.testing.assert_array_equal(
            img_util.imfrombytes(data, 'unchanged'), img)
        t = tiff_decode._Tiff(data, path)
        want = 1 if params is None else params[1]
        ref_tags = tiff_decode._Tiff(cv2.imencode(
            '.tif', img, [] if params is None else params)[1].tobytes(),
            'cv2')
        assert t.compression == ref_tags.compression == (
            5 if params is None else want)
        assert t.predictor == ref_tags.predictor
        assert t.th == ref_tags.th and t.end == ref_tags.end == '<'
        assert t.tags[tiff_decode.SAMPLE_FORMAT] == \
            ref_tags.tags[tiff_decode.SAMPLE_FORMAT]
    for value in (2, 7, 32773, 32946):
        with pytest.raises(ValueError, match='IMWRITE_TIFF_COMPRESSION'):
            img_util.imwrite(img, str(tmp_path / 'g.tif'),
                             [img_util.IMWRITE_TIFF_COMPRESSION, value])


def test_lzw_codec_round_trips_past_table_resets():
    """The native LZW encoder's stream decodes to its input through the
    native decoder and through cv2 (libtiff), across several table
    resets (random bytes fill the 4094-code table every ~4 KB)."""
    raw = np.random.default_rng(8).integers(0, 256, 60000).astype(np.uint8)
    raw[1000:5000] = 7                            # long runs too
    img = raw.reshape(100, 200, 3)
    data = img_util.encode_tiff(img[..., ::-1].copy(), 5)
    np.testing.assert_array_equal(tiff_decode.decode(data), img)
    np.testing.assert_array_equal(
        cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR),
        img[..., ::-1])


# ---------------------------------------------------------------------------
# .tif folders: open_sequence, ValFolderDataset, test_pipeline, loader
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def tif_data(tmp_path_factory):
    """tools/make_synth_dataset's two 8-frame 48x48 clips as PNG, and the
    same frames as .tif written by the port (LZW and predictor 2)."""
    sys.path.insert(0, os.path.join(ROOT, 'tools'))
    from make_synth_dataset import main as make_ds
    png = tmp_path_factory.mktemp('synth_png')
    make_ds(str(png), num_clips=2, t=8, h=48, w=48, seed=0)
    tif = tmp_path_factory.mktemp('synth_tif')
    for clip in sorted(os.listdir(png)):
        os.makedirs(tif / clip)
        for f in sorted(os.listdir(png / clip)):
            img = cv2.imread(str(png / clip / f))
            img_util.imwrite(img, str(tif / clip / f.replace('.png',
                                                             '.tif')))
    return str(png), str(tif)


@pytest.mark.parametrize('kw', [{}, {'gray_mode': True},
                                {'expand_if_needed': True}],
                         ids=['color', 'gray', 'expand'])
def test_open_sequence_matches_jax_and_png(tif_data, tmp_path, kw):
    """open_sequence of a .tif folder equals JAX's (cv2, frame by frame)
    and, in colour, the same frames as PNG (gray differs: libpng's and
    cv2's own BGR -> gray rules); a folder tagged 3 is turned by the port
    as by JAX (its native decoder does not read TIFF, so every mode is a
    cv2 route)."""
    png, tif = tif_data
    folder = os.path.join(tif, 'clip00')
    got, ref = utils_common.open_sequence(folder, **kw), \
        jax_uc.open_sequence(folder, **kw)
    assert got[1:] == ref[1:]
    np.testing.assert_array_equal(got[0], ref[0])
    if not kw.get('gray_mode'):
        np.testing.assert_array_equal(
            got[0], utils_common.open_sequence(os.path.join(png, 'clip00'),
                                               **kw)[0])
    src = FIXTURES[NAMES.index('orient3_rgb8')]
    for i in range(3):
        shutil.copy(src, tmp_path / f'{i}.tif')
    got, ref = utils_common.open_sequence(str(tmp_path), **kw), \
        jax_uc.open_sequence(str(tmp_path), **kw)
    np.testing.assert_array_equal(got[0], ref[0])


@pytest.mark.parametrize('blind', [False, True])
def test_val_folder_dataset_matches_jax_on_tif(tif_data, blind):
    from bsvd_tpu.data import build_dataset as jax_build
    opt = {'name': 's', 'type': 'ValFolderDataset', 'valsetdir': tif_data[1],
           'num_validation_frames': 6, 'valnoisestd': 20, 'manual_seed': 7,
           'blind': blind}
    ds, jds = build_dataset(opt), jax_build(opt)
    assert len(ds) == len(jds) == 2
    for i in range(2):
        a, b = ds[i], jds[i]
        assert sorted(a) == sorted(b) and a['folder'] == b['folder']
        for k in ('lq', 'gt', 'noise_map'):
            if k in b:
                np.testing.assert_array_equal(a[k], b[k])


def test_test_pipeline_csvs_match_jax_on_tif(tif_data, tmp_path):
    """test_pipeline on a .tif folder: the port's CSVs against JAX's, with
    test_torch_eval's options, checkpoint and tolerances."""
    sys.path.insert(0, os.path.join(ROOT, 'tests'))
    import test_torch_eval as te
    from bsvd_tpu.test import test_pipeline as jax_test_pipeline
    from bsvd_tpu_torch.test import test_pipeline
    ckpt = te._shared_ckpt(tmp_path)
    jpath, _ = te._pipeline_opts(tif_data[1], str(tmp_path / 'jax'), ckpt)
    ppath, _ = te._pipeline_opts(tif_data[1], str(tmp_path / 'port'), ckpt)
    before = utils_common.ROUTES['tiff_decode']
    ref = jax_test_pipeline(str(tmp_path / 'jax'), opt_path=jpath)
    got = test_pipeline(str(tmp_path / 'port'),
                        cmd=['-opt', ppath, '--device', 'cpu'])
    assert utils_common.ROUTES['tiff_decode'] >= before + 16
    for m, tol in te.TOL_UINT8.items():
        assert abs(got['synth_20'][m] - ref['synth_20'][m]) < tol, m
    jroot = tmp_path / 'jax' / 'results' / 'smoke_eval'
    root = tmp_path / 'port' / 'results' / 'smoke_eval'
    names = sorted(p.name for p in root.glob('*.csv'))
    assert names == sorted(p.name for p in jroot.glob('*.csv')) == \
        ['synth_20_clip00.csv', 'synth_20_clip01.csv']
    for name in names:
        head, vals = te._read_csv(root / name)
        jhead, jvals = te._read_csv(jroot / name)
        assert head == jhead and vals.shape == jvals.shape == (8, 3)
        for m, tol in enumerate(te.TOL_UINT8.values()):
            np.testing.assert_allclose(vals[:, m], jvals[:, m], rtol=0,
                                       atol=tol)


def test_train_loader_windows_from_tif_equal_png(tif_data):
    """train_video_loader over the .tif folders gives the batches of the
    same frames as PNG, bit for bit (windows through load_crop_seq)."""
    opt = {'batch_size_per_gpu': 2, 'temp_patch_size': 5,
           'patch_size': [24, 32], 'max_number_patches': 4,
           'noise_ival': [5, 55], 'noise_shape': 'NF', 'num_workers': 1,
           'manual_seed': 4}
    batches = []
    for root in tif_data:
        loader = train_video_loader(dict(copy.deepcopy(opt),
                                         trainset_dir=root))
        try:
            batches.append(list(loader))
        finally:
            loader.close()
    assert len(batches[0]) == len(batches[1]) == 2
    for got, want in zip(*batches):
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
