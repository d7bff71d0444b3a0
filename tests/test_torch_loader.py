"""The port's frame reading and train loader on CPU against the JAX package
and libpng: the zlib-only PNG reader (``data/png_decode``) bit for bit
against cv2.imread and the JAX package's native decoder on every PNG kind
the reader takes, Adam7-interlaced files, gray mode (cv2's
IMREAD_GRAYSCALE and the JAX package's open_image), its crop entry and
its errors; the committed gray / Adam7 fixtures; the route by file type;
``train_video_loader`` with one worker bit for bit against the JAX
package's loader, its epoch length, the skipped short clip, the refused
video files and the reference's alias.

Tolerances: none. Frames and batches are integer decodes and the same
numpy arithmetic on both sides: equal bit for bit.
"""

import os
import struct
import zlib

import numpy as np
import pytest

from bsvd_tpu_torch.data import build_dataset, png_decode, utils_common
from bsvd_tpu_torch.data.video_train_loader import (_ClipIndex,
                                                    train_dali_loader,
                                                    train_video_loader)
from bsvd_tpu_torch.utils.img_util import imwrite
from bsvd_tpu_torch.utils.registry import DATASET_REGISTRY

from png_util import chunk, make_png, pack_rows

cv2 = pytest.importorskip('cv2')

RNG = np.random.default_rng(20)
IMG = RNG.integers(0, 256, (19, 23, 4))
IMG16 = RNG.integers(0, 65536, (19, 23, 4))
PAL = RNG.integers(0, 256, (256, 3), dtype=np.uint8)


def _own(samples, depth, color, **kw):
    return lambda path: open(path, 'wb').write(
        make_png(samples, depth, color, **kw))


def _cv2(img):
    return lambda path: cv2.imwrite(path, img)


# each kind of PNG the reader takes: cv2's writer (libpng, adaptive filter
# choice) and the tests' own (every colour type, depth, tRNS, filter 0-4)
KINDS = {
    'cv2_bgr8': _cv2(IMG[..., :3].astype(np.uint8)),
    'cv2_gray8': _cv2(IMG[..., 0].astype(np.uint8)),
    'cv2_bgra8': _cv2(IMG.astype(np.uint8)),
    'cv2_bgr16': _cv2(IMG16[..., :3].astype(np.uint16)),
    'cv2_gray16': _cv2(IMG16[..., 0].astype(np.uint16)),
    'cv2_bgra16': _cv2(IMG16.astype(np.uint16)),
    'gray_alpha8': _own(IMG[..., :2], 8, 4, filters=[0, 1, 2, 3, 4]),
    'gray_alpha16': _own(IMG16[..., :2], 16, 4, filters=[4, 3, 2, 1, 0]),
    'rgb16_trns': _own(IMG16[..., :3], 16, 2, filters=[1, 4],
                       trns=struct.pack('>HHH', *IMG16[0, 0, :3])),
    'rgba16': _own(IMG16, 16, 6, filters=[2, 3, 4]),
    'rgb8_trns': _own(IMG[..., :3], 8, 2, filters=[3],
                      trns=struct.pack('>HHH', *IMG[0, 0, :3])),
    'gray8_trns': _own(IMG[..., 0], 8, 0, filters=[4],
                       trns=struct.pack('>H', IMG[1, 1, 0])),
    'palette8': _own(IMG[..., 0], 8, 3, palette=PAL, filters=[0, 4]),
    'palette8_trns': _own(IMG[..., 0], 8, 3, palette=PAL, filters=[1, 3],
                          trns=bytes(range(0, 256, 2))),
    'palette4_trns': _own(IMG[..., 0] % 16, 4, 3, palette=PAL[:16],
                          filters=[2, 4], trns=bytes([0, 128, 255])),
    'palette2': _own(IMG[..., 0] % 4, 2, 3, palette=PAL[:4], filters=[3]),
    'palette1': _own(IMG[..., 0] % 2, 1, 3, palette=PAL[:2], filters=[4]),
    'gray1': _own(IMG[..., 0] % 2, 1, 0, filters=[0, 1, 2, 3, 4]),
    'gray2': _own(IMG[..., 0] % 4, 2, 0, filters=[4, 2]),
    'gray4': _own(IMG[..., 0] % 16, 4, 0, filters=[3, 1]),
    '1x1': _own(IMG[:1, :1, :3], 8, 2, filters=[4]),
    '7x13': _own(IMG[:7, :13, :3], 8, 2, filters=[0, 1, 2, 3, 4]),
    'four_idat_chunks': _own(IMG[..., :3], 8, 2, filters=[2],
                             idat_chunks=4),
}
KINDS.update({f'rgb8_filter{f}': _own(IMG[..., :3], 8, 2, filters=[f])
              for f in range(5)})


def _native_jax(path):
    from bsvd_tpu.data import native_decode
    if not native_decode.available():
        pytest.skip('the JAX package\'s native decoder does not build here')
    return native_decode.decode_image(path)


@pytest.mark.parametrize('kind', sorted(KINDS))
def test_png_reader_matches_libpng(tmp_path, kind):
    """Equal to libpng bit for bit, twice over: cv2.imread (BGR -> RGB) and
    the JAX package's native decoder (libpng with the same transforms)."""
    path = str(tmp_path / f'{kind}.png')
    KINDS[kind](path)
    got = png_decode.load(path)
    ref = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, _native_jax(path))
    assert png_decode.image_dims(path) == got.shape[:2]


@pytest.mark.parametrize('kind', ['cv2_bgr8', 'gray_alpha16', 'palette2',
                                  'gray1', '7x13', 'four_idat_chunks'])
def test_png_crop_equals_the_crop_of_the_frame(tmp_path, kind):
    path = str(tmp_path / 'f.png')
    KINDS[kind](path)
    whole = png_decode.load(path)
    h, w = whole.shape[:2]
    for y0, x0, ch, cw in ((0, 0, h, w), (0, 0, 1, 1), (h - 1, w - 1, 1, 1),
                           (h // 3, w // 4, h - h // 3, w // 2)):
        np.testing.assert_array_equal(
            png_decode.load_crop(path, y0, x0, ch, cw),
            whole[y0:y0 + ch, x0:x0 + cw])
    seq = png_decode.load_crop_seq([path, path], 1, 2, h - 2, w - 3)
    np.testing.assert_array_equal(seq, np.stack([whole[1:-1, 2:-1]] * 2))
    with pytest.raises(IOError, match='outside'):
        png_decode.load_crop(path, 1, 0, h, w)


def _corrupt(data, kind):
    if kind == 'truncated':
        return data[:len(data) // 2]
    if kind == 'no_iend':
        return data[:-12]
    if kind == 'bad_crc':
        i = data.index(b'IDAT') + 10
        return data[:i] + bytes([data[i] ^ 0xff]) + data[i + 1:]
    if kind == 'bad_signature':
        return b'\x89PNX' + data[4:]
    if kind == 'bad_filter':          # row 0 with filter type 5
        rows = pack_rows(IMG[..., :3], 8)
        raw = np.concatenate([np.full((len(rows), 1), 5, np.uint8), rows], 1)
        return data[:33] + chunk(b'IDAT', zlib.compress(raw.tobytes())) + \
            chunk(b'IEND', b'')
    raise AssertionError(kind)


@pytest.mark.parametrize('kind', ['truncated', 'no_iend', 'bad_crc',
                                  'bad_signature', 'bad_filter', 'adam7'])
def test_png_reader_refuses_broken_and_interlaced_files(tmp_path, kind):
    """Each broken file raises IOError naming the file; the Adam7 file is
    valid and reads as cv2 reads it (the reader takes interlacing now),
    whole and cropped."""
    path = str(tmp_path / 'f.png')
    if kind == 'adam7':
        data = make_png(IMG[..., :3], 8, 2, interlace=True)
    else:
        data = _corrupt(make_png(IMG[..., :3], 8, 2), kind)
    open(path, 'wb').write(data)
    if kind == 'adam7':
        want = IMG[..., :3].astype(np.uint8)
        np.testing.assert_array_equal(
            cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB), want)
        np.testing.assert_array_equal(png_decode.load(path), want)
        np.testing.assert_array_equal(png_decode.load_crop(path, 0, 0, 2, 2),
                                      want[:2, :2])
        return
    with pytest.raises(IOError, match='f.png'):
        png_decode.load(path)
    with pytest.raises(IOError):
        png_decode.load_crop(path, 0, 0, 2, 2)


# Adam7 files: every colour type and depth, tRNS, sizes under 8 pixels
# (passes without pixels), filters 0-4
ADAM7 = [(color, depth, h, w) for color, depths in (
    (0, (1, 2, 4, 8, 16)), (2, (8, 16)), (3, (1, 2, 4, 8)), (4, (8, 16)),
    (6, (8, 16))) for depth in depths for h, w in ((19, 23), (1, 1), (3, 5),
                                                  (7, 2))]


def _adam7(path, color, depth, h, w):
    rng = np.random.default_rng(color * 100 + depth * 10 + h + w)
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    n_pal = min(1 << depth, 256) - 1 if color == 3 else 0
    samples = rng.integers(0, 1 << depth, (h, w, ch))
    trns = None
    if (h + w) % 2 and color in (0, 2):
        trns = struct.pack(f'>{ch}H', *(int(v) for v in samples[0, 0]))
    elif (h + w) % 2 and color == 3:
        trns = bytes(rng.integers(0, 256, max(1, n_pal // 2)).astype(
            np.uint8))
    open(path, 'wb').write(make_png(
        samples if ch > 1 else samples[..., 0], depth, color,
        palette=rng.integers(0, 256, (n_pal, 3)) if color == 3 else None,
        trns=trns, filters=rng.integers(0, 5, h), interlace=True))


@pytest.mark.parametrize('color,depth,h,w', ADAM7,
                         ids=[f'c{c}_d{d}_{h}x{w}' for c, d, h, w in ADAM7])
def test_adam7_matches_libpng(tmp_path, color, depth, h, w):
    """Each pass unfiltered on its own width and put in place: equal to
    cv2.imread in colour and in gray mode, windows the crop of the frame;
    the passes of a frame under 8 pixels may hold no pixel."""
    path = str(tmp_path / 'f.png')
    _adam7(path, color, depth, h, w)
    got = png_decode.load(path)
    np.testing.assert_array_equal(
        got, cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB))
    gray = png_decode.load_gray(path)
    np.testing.assert_array_equal(gray,
                                  cv2.imread(path, cv2.IMREAD_GRAYSCALE))
    y0, x0 = h // 3, w // 3
    np.testing.assert_array_equal(
        png_decode.load_crop(path, y0, x0, h - y0, w - x0), got[y0:, x0:])
    np.testing.assert_array_equal(
        png_decode.load_crop(path, y0, x0, h - y0, w - x0, gray=True),
        gray[y0:, x0:])


@pytest.mark.parametrize('kind', sorted(KINDS))
def test_png_gray_matches_cv2_and_jax(tmp_path, kind):
    """gray_mode on every PNG kind: libpng's rgb_to_gray with cv2's weights
    (colour and palettes), 16-bit reduced as cv2 does; open_image's gray
    frame equal to the JAX package's."""
    from bsvd_tpu.data.utils_common import open_image as jax_open_image
    path = str(tmp_path / f'{kind}.png')
    KINDS[kind](path)
    np.testing.assert_array_equal(png_decode.load_gray(path),
                                  cv2.imread(path, cv2.IMREAD_GRAYSCALE))
    for norm in (True, False):
        got = utils_common.open_image(path, True, True, norm)
        ref = jax_open_image(path, True, True, norm)
        assert got[1:] == ref[1:] and got[0].dtype == ref[0].dtype
        np.testing.assert_array_equal(got[0], ref[0])


@pytest.mark.parametrize('chunk_type,payload,refused', [
    (b'gAMA', struct.pack('>I', 45455), True), (b'sRGB', b'\x00', True),
    (b'gAMA', struct.pack('>I', 100000), False)],
    ids=['gAMA_0.45455', 'sRGB', 'gAMA_1.0'])
def test_png_gray_of_a_colour_space(tmp_path, chunk_type, payload, refused):
    """libpng converts a colour file that names a non-linear colour space
    in linear light: refused in gray mode (colour reads as before); a
    gray file and a gAMA of 1.0 read as cv2 reads them."""
    path = str(tmp_path / 'f.png')
    for color, samples in ((2, IMG[..., :3]), (0, IMG[..., 0])):
        data = make_png(samples, 8, color)
        open(path, 'wb').write(data[:33] + chunk(chunk_type, payload)
                               + data[33:])
        np.testing.assert_array_equal(
            png_decode.load(path),
            cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB))
        if refused and color == 2:
            with pytest.raises(png_decode.UnsupportedPNG, match=chunk_type
                               .decode()):
                png_decode.load_gray(path)
            continue
        np.testing.assert_array_equal(png_decode.load_gray(path),
                                      cv2.imread(path, cv2.IMREAD_GRAYSCALE))


def test_frame_fixtures_are_cv2s_decode():
    """The committed gray / Adam7 fixtures (tools/make_frame_fixtures.py)
    decode here as their .npz holds, by cv2 and by the port's readers; the
    card's run is held to the same .npz."""
    from bsvd_tpu_torch.data import bmp_decode, jpeg_decode
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        'fixtures')
    ref = np.load(os.path.join(root, 'frames', 'decoded.npz'))
    files = sorted(f for f in os.listdir(os.path.join(root, 'frames'))
                   if not f.endswith('.npz'))
    assert len(files) == 13 and len(ref.files) == 2 * 13 + 8
    for f in files:
        path, stem = os.path.join(root, 'frames', f), f[:-4]
        mod = png_decode if f.endswith('.png') else bmp_decode
        for got, want, cv in ((mod.load(path), ref[stem], cv2.cvtColor(
                cv2.imread(path), cv2.COLOR_BGR2RGB)),
                (mod.load_gray(path), ref[f'{stem}_gray'],
                 cv2.imread(path, cv2.IMREAD_GRAYSCALE))):
            np.testing.assert_array_equal(cv, want)
            np.testing.assert_array_equal(got, want)
    for f in sorted(os.listdir(os.path.join(root, 'jpeg'))):
        if f.endswith('.jpg'):
            path = os.path.join(root, 'jpeg', f)
            want = ref[f'jpeg_{f[:-4]}_gray']
            np.testing.assert_array_equal(
                cv2.imread(path, cv2.IMREAD_GRAYSCALE), want)
            np.testing.assert_array_equal(jpeg_decode.load_gray(path), want)


def test_frames_take_a_route_by_file_type(tmp_path):
    """.png always the zlib reader, .jpg / .jpeg the standard-C++ JPEG
    decoder, .bmp the BMP reader; .tif raises NotImplementedError naming
    the type; open_sequence counts each frame's route."""
    assert [utils_common.route(f'a{e}') for e in (
        '.png', '.PNG', '.jpg', '.jpeg', '.JPG', '.bmp')] == \
        ['png_decode'] * 2 + ['jpeg_decode'] * 3 + ['bmp_decode']
    with pytest.raises(NotImplementedError, match='.tif'):
        utils_common.route('a.tif')
    frames = RNG.integers(0, 256, (3, 9, 11, 3), dtype=np.uint8)
    for i, f in enumerate(frames):
        imwrite(f[..., ::-1], str(tmp_path / f'{i}.png'))
    before = utils_common.ROUTES['png_decode']
    got, _, _ = utils_common.open_sequence(str(tmp_path))
    assert utils_common.ROUTES['png_decode'] == before + 3
    np.testing.assert_array_equal(
        got, np.transpose(frames, (0, 3, 1, 2)) / np.float32(255))
    # a folder is read by one route: frames of several types raise
    (tmp_path / '3.jpg').write_bytes(b'\xff\xd8')
    with pytest.raises(IOError, match='several file types'):
        utils_common.open_sequence(str(tmp_path))


# ---------------------------------------------------------------------------
# the train loader
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def clip_root(tmp_path_factory):
    """Three 12-frame clips at 40x52 (odd frames written by cv2, even ones
    by the port's writer with filters 0-4) and a 3-frame clip, shorter
    than the loaders' temp_patch_size."""
    root = tmp_path_factory.mktemp('train_clips')
    rng = np.random.default_rng(21)
    for c, n in enumerate((12, 12, 3, 12)):
        folder = root / f'clip{c}'
        folder.mkdir()
        for k in range(n):
            f = rng.integers(0, 256, (40, 52, 3), dtype=np.uint8)
            path = str(folder / f'{k:03d}.png')
            if k % 2:
                cv2.imwrite(path, f)
            else:
                open(path, 'wb').write(make_png(f[..., ::-1], 8, 2,
                                                filters=[0, 1, 2, 3, 4]))
    return str(root)


@pytest.fixture(scope='module')
def jpg_root(tmp_path_factory):
    """The clips of ``clip_root`` as JPEG frames: the odd ones written by
    cv2 at 4:4:4, the even ones by the port's writer (quality 95, 4:2:0)."""
    root = tmp_path_factory.mktemp('train_jpg_clips')
    rng = np.random.default_rng(21)
    for c, n in enumerate((12, 12, 3, 12)):
        folder = root / f'clip{c}'
        folder.mkdir()
        for k in range(n):
            f = rng.integers(0, 256, (40, 52, 3), dtype=np.uint8)
            path = str(folder / f'{k:03d}.jpg')
            if k % 2:
                cv2.imwrite(path, f, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                      cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444])
            else:
                imwrite(f, path)
    return str(root)


def _opt(root, **over):
    return dict({'trainset_dir': root, 'batch_size_per_gpu': 2,
                 'temp_patch_size': 5, 'patch_size': [24, 24],
                 'max_number_patches': 6, 'noise_ival': [5, 55],
                 'noise_shape': 'N', 'num_workers': 1, 'manual_seed': 4},
                **over)


@pytest.mark.parametrize('over', [
    {}, {'noise_shape': 'NF'}, {'blind': True},
    {'noise_shape': 'NF', 'patch_size': [16, 32], 'manual_seed': 9},
    {'frames': 'jpg', 'noise_shape': 'NF'}],
    ids=['N', 'NF', 'blind', 'rectangular', 'jpg'])
def test_train_loader_matches_jax_with_one_worker(clip_root, request, over):
    """Three batches (one epoch) bit for bit: the worker's seed, clip,
    start and window from the same Generators, the short clip skipped
    alike, the augmentation and the noise; PNG frames, and JPEG frames
    (windows decoded by the JPEG decoder here, by libjpeg-turbo's ROI
    decode in the JAX package)."""
    from bsvd_tpu.data.video_train_loader import train_video_loader as jax
    over = dict(over)
    root = request.getfixturevalue('jpg_root') \
        if over.pop('frames', 'png') == 'jpg' else clip_root
    opt = _opt(root, **over)
    ours, ref = train_video_loader(opt), jax(dict(opt))
    try:
        assert len(ours) == len(ref) == 3
        got, want = list(ours), list(ref)
    finally:
        ours.close()
        ref.close()
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        assert ('noise_map' in a) == (not over.get('blind', False))
        for k in b:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            np.testing.assert_array_equal(a[k], b[k])
    ps = opt['patch_size']
    assert sorted(got[0]['gt'].shape[-2:]) == sorted(ps)


def test_train_loader_epoch_and_short_clips(clip_root, tmp_path):
    """len() counts batches of max_number_patches windows (ceil), and
    without it the frames over temp_patch_size; the 3-frame clip raises
    in the index and is skipped by the workers; a folder of clips all
    shorter than temp_patch_size raises at construction."""
    from bsvd_tpu.data.video_train_loader import train_video_loader as jax
    for over in ({'max_number_patches': 7}, {'max_number_patches': -1},
                 {'batch_size_per_gpu': 4, 'max_number_patches': 1}):
        ours, ref = train_video_loader(_opt(clip_root, **over)), \
            jax(_opt(clip_root, **over))
        ours.close()
        ref.close()
        assert len(ours) == len(ref)
    assert len(ours) == 1
    index = _ClipIndex(clip_root)
    assert [n for _, _, n in index.entries] == [12, 12, 3, 12]
    seeds = [s for s in range(50)
             if np.random.default_rng(s).integers(4) == 2]
    with pytest.raises(IOError, match='shorter'):
        index.sample(np.random.default_rng(seeds[0]), 5, (24, 24))
    short = tmp_path / 'short' / 'clip0'
    short.mkdir(parents=True)
    for k in range(3):
        imwrite(np.zeros((8, 8, 3), np.uint8), str(short / f'{k}.png'))
    with pytest.raises(IOError, match='temp_patch_size'):
        train_video_loader(_opt(str(tmp_path / 'short')))
    # frames smaller than patch_size: no window fits
    small = tmp_path / 'small' / 'clip0'
    small.mkdir(parents=True)
    for k in range(6):
        imwrite(np.zeros((8, 30, 3), np.uint8), str(small / f'{k}.png'))
    with pytest.raises(IOError, match='patch_size'):
        train_video_loader(_opt(str(tmp_path / 'small')))


def test_train_loader_raises_on_unread_kinds_and_endless_redraws(
        clip_root, tmp_path, monkeypatch):
    """Adam7 frames are read: a folder of interlaced clips gives the batches
    of the same frames written without interlacing. A clip whose windows
    never decode raises in __next__ after MAX_REDRAWS draws in a row, each
    reason logged once."""
    from bsvd_tpu_torch.data import video_train_loader as vtl
    img = np.random.default_rng(3).integers(0, 256, (32, 32, 3), np.uint8)
    good, adam7 = tmp_path / 'mixed' / 'clip0', tmp_path / 'mixed' / 'clip1'
    only = tmp_path / 'only' / 'clip0'
    for folder in (good, adam7, only):
        folder.mkdir(parents=True)
    for k in range(6):
        imwrite(img[..., ::-1], str(good / f'{k}.png'))
        for folder in (adam7, only):
            (folder / f'{k}.png').write_bytes(make_png(img, 8, 2,
                                                       interlace=True))
    plain = tmp_path / 'plain' / 'clip0'
    plain.mkdir(parents=True)
    for k in range(6):
        (plain / f'{k}.png').write_bytes(make_png(img, 8, 2))
    batches = []
    for root in (only.parent, plain.parent):
        loader = train_video_loader(_opt(str(root)))
        try:
            batches.append([b for b in loader])
        finally:
            loader.close()
    assert len(batches[0]) == len(batches[1]) == 3
    for got, want in zip(*batches):
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])
    loader = train_video_loader(_opt(str(tmp_path / 'mixed')))
    try:
        assert len([b for b in loader]) == 3
    finally:
        loader.close()

    broken = tmp_path / 'broken' / 'clip0'
    broken.mkdir(parents=True)
    imwrite(img[..., ::-1], str(broken / '0.png'))
    for k in range(1, 6):
        (broken / f'{k}.png').write_bytes(b'\x89PNG\r\n\x1a\n')
    monkeypatch.setattr(vtl, 'MAX_REDRAWS', 20)
    warned = []
    monkeypatch.setattr(vtl, 'get_root_logger', lambda: type(
        'L', (), {'warning': staticmethod(warned.append)})())
    loader = train_video_loader(_opt(str(broken.parent)))
    try:
        with pytest.raises(RuntimeError, match='worker failed') as err:
            next(iter(loader))
    finally:
        loader.close()
    assert 'in a row' in str(err.value.__cause__)
    assert loader.skipped == 20 and 0 < len(warned) < 20


def test_train_loader_refuses_video_files_and_more_devices(clip_root,
                                                           tmp_path):
    """An unreadable .mp4 raises IOError naming the file; .mkv / .avi
    raise NotImplementedError naming the container; a rank outside
    num_devices raises ValueError."""
    (tmp_path / 'clip0').mkdir()
    imwrite(np.zeros((8, 8, 3), np.uint8), str(tmp_path / 'clip0' / '0.png'))
    (tmp_path / 'davis.mp4').write_bytes(b'\x00' * 16)
    with pytest.raises(IOError, match='davis.mp4'):
        train_video_loader(_opt(str(tmp_path)))
    os.remove(tmp_path / 'davis.mp4')
    for name, container in (('davis.mkv', 'Matroska'), ('davis.avi', 'AVI')):
        (tmp_path / name).write_bytes(b'\x00' * 16)
        with pytest.raises(NotImplementedError,
                           match=f'{name}: {container}'):
            train_video_loader(_opt(str(tmp_path)))
        os.remove(tmp_path / name)
    with pytest.raises(ValueError, match='num_devices'):
        train_video_loader(_opt(clip_root, num_devices=2, rank=2))


def test_train_loader_is_registered_under_both_names(clip_root):
    assert DATASET_REGISTRY.get('train_video_loader') is train_video_loader
    assert DATASET_REGISTRY.get('train_dali_loader') is train_dali_loader
    loader = build_dataset(dict(_opt(clip_root), type='train_dali_loader'))
    try:
        batch = next(iter(loader))
    finally:
        loader.close()
    assert isinstance(loader, train_video_loader)
    assert batch['lq'].shape == (2, 5, 3, 24, 24)
    assert not any(t.is_alive() for t in loader._workers)


def test_train_loader_hands_a_worker_fault_to_the_caller(clip_root,
                                                         monkeypatch):
    """A fault other than an unreadable window ends the worker and raises
    in __next__, instead of leaving the caller waiting."""
    def broken(self, rng, seq_len, crop_hw):
        raise MemoryError('decoder out of memory')
    monkeypatch.setattr(_ClipIndex, 'sample', broken)
    loader = train_video_loader(_opt(clip_root))
    try:
        with pytest.raises(RuntimeError, match='worker failed'):
            next(iter(loader))
    finally:
        loader.close()


def test_clip_windows_read_the_frames_that_cv2_reads(clip_root):
    """The index's window equals the crop of the frames cv2 reads, at the
    positions drawn from the Generator in the JAX package's order."""
    from bsvd_tpu.data.video_train_loader import _ClipIndex as JaxIndex
    ours, ref = _ClipIndex(clip_root), JaxIndex(clip_root)
    for seed in range(6):
        try:
            want = ref.sample(np.random.default_rng(seed), 4, (16, 20))
        except IOError:
            with pytest.raises(IOError):
                ours.sample(np.random.default_rng(seed), 4, (16, 20))
            continue
        np.testing.assert_array_equal(
            ours.sample(np.random.default_rng(seed), 4, (16, 20)), want)
    assert os.path.isdir(clip_root)


def test_reads_from_many_threads_keep_every_count(clip_root):
    """More threads than cores, a short switch interval: the route counter
    loses no update, every window equals the one read alone, and a loader
    with 16 workers stops within its join timeout."""
    import sys
    import threading
    files = utils_common.get_imagenames(os.path.join(clip_root, 'clip0'))[:4]
    want = utils_common.load_crop_seq(files, 3, 5, 16, 20)
    before = utils_common.ROUTES['png_decode']
    errors, n_threads, n_reads = [], 16, 5
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def read():
            for _ in range(n_reads):
                if not np.array_equal(utils_common.load_crop_seq(
                        files, 3, 5, 16, 20), want):
                    errors.append('window differs')
        threads = [threading.Thread(target=read) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert utils_common.ROUTES['png_decode'] - before == \
            n_threads * n_reads * len(files)
        loader = train_video_loader(_opt(clip_root, num_workers=16))
        try:
            batches = [next(iter(loader)) for _ in range(2)]
        finally:
            loader.close()
        assert not any(t.is_alive() for t in loader._workers)
    finally:
        sys.setswitchinterval(interval)
    assert not errors
    assert all(b['gt'].shape == (2, 5, 3, 24, 24) for b in batches)
