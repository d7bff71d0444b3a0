"""The port's host H.264 decoder (``data/h264_decode``,
``_native/h264_decode.cpp``) on the CPU, against cv2's FFmpeg decode: the
JAX package's route for mp4 clips (``cv2.VideoCapture``, then
``cvtColor(BGR2RGB)``).

Streams: ``tools/make_h264_streams`` writes one family for each coding
tool the decoder reads (intra 4x4 / 8x8 / 16x16 / PCM, P partitions,
skips, several references with list modification, MMCO and long-term
references, weighted P, scaling matrices, each deblocking idc, POC types
0 / 1 / 2, several slices, cropping, constrained intra, level escapes,
frame_num wrap), two seeds each, coded 48 x 64 to 96 x 128, 12 frames
(``frame_num_wrap``: 20 frames, since a wrap needs more reference frames
than MaxFrameNum = 16). Each decodes, through ``nv12_to_rgb_plain``, to
cv2's RGB on every frame, from the first frame and from every start (cv2's
seek). The fixture clips of ``tools/make_video_fixtures`` decode to the
writer's NV12 planes. Each refusal raises ``UnsupportedH264`` naming its
syntax element; corrupt data raises IOError.

Not held to cv2: a left crop. FFmpeg keeps its buffers aligned on a left
crop and cv2's frames are then not the cropped picture; the decoder
crops as the standard says, held here to the crop of its own uncropped
decode.

Tolerances: none. Both sides are integer decodes: equal bit for bit.
"""

import copy
import re
import threading

import numpy as np
import pytest
import torch

from bsvd_tpu_torch.data import h264_decode, h264_headers, mp4_demux
from bsvd_tpu_torch.data.h264_decode import UnsupportedH264
from bsvd_tpu_torch.data.video_train_loader import nv12_window
from bsvd_tpu_torch.data.yuv import nv12_to_rgb, nv12_to_rgb_plain
from tools import make_h264_streams as mhs
from tools import make_video_fixtures as mvf
from torch_threads import one_torch_thread  # noqa: F401

cv2 = pytest.importorskip('cv2')

SEEDS = (0, 1)
# the tool each family is written for, as the writer counts it
TOOLS = {
    'intra4x4': ['I4_mode_4', 'I4_mode_8', 'chroma_mode_3'],
    'intra8x8': ['I8_mode_3', 'I8_mode_5', 'P_transform_8x8'],
    'intra16x16': ['I16_type_4', 'I16_type_24', 'I16_type_13'],
    'pcm': ['PCM'],
    'p_partitions': ['P16x8', 'P8x16', 'sub_mb_type_3', 'mv_past_the_edge'],
    'skips': ['SKIP', 'P_Skip_nonzero_mv'],
    'multiref': ['modification', 'list_duplicates', 'P8x8ref0'],
    'long_term': ['mmco_1', 'mmco_3', 'mmco_4', 'mmco_6',
                  'modification_long_term'],
    'weighted': ['weighted_slices', 'weights_log2_0'],
    'scaling_sps': ['sps_scaling', 'scaling_list_default'],
    'scaling_pps': ['pps_scaling_rule_A'],
    'scaling_both': ['sps_scaling', 'pps_scaling_rule_B'],
    'deblock': ['deblock_idc_0', 'deblock_idc_1', 'deblock_idc_2',
                'several_slices'],
    'poc0_bframes': ['poc_type_0', 'B_I4'],
    'poc1': ['poc_type_1', 'B_I16'],
    'poc2': ['poc_type_2'],
    'slices': ['several_slices', 'I_slice_mb', 'P_slice_mb'],
    'cropping': ['P_transform_8x8'],
    'constrained_intra': ['I4', 'SKIP'],
    'escapes': ['level_prefix_15', 'level_prefix_16'],
    'frame_num_wrap': ['frame_num_wraps'],
    'high_qp_dense': ['coeff_token_8+'],
    'low_qp_dense': ['coeff_token_8+', 'coeff_token_4-7'],
}
CASES = [(f, s) for f in mhs.FAMILIES for s in SEEDS]


@pytest.fixture(scope='module')
def streams(tmp_path_factory):
    """(family, seed) -> (path, frame count, the writer's tool counts)."""
    root = tmp_path_factory.mktemp('h264')
    out = {}
    for fam, seed in CASES:
        path = str(root / f'{fam}_{seed}.mp4')
        n, stats = mhs.write_stream(path, fam, seed)
        out[fam, seed] = (path, n, stats)
    return out


def _cv2_rgb(path, start=0):
    """cv2's frames from ``start`` (its seek) to the end, RGB."""
    cap = cv2.VideoCapture(path)
    if start:
        cap.set(cv2.CAP_PROP_POS_FRAMES, start)
    frames = []
    while True:
        ok, img = cap.read()
        if not ok:
            break
        frames.append(img[..., ::-1])
    cap.release()
    return np.stack(frames)


def _rgb(track, nv12):
    h, w = track.hw
    return nv12_to_rgb_plain(nv12, 0, 0, h, w).numpy()


def test_every_family_has_a_test():
    assert set(TOOLS) == set(mhs.FAMILIES)


@pytest.mark.parametrize('family', list(mhs.FAMILIES))
def test_family_writes_its_tool(streams, family):
    """Each family's two streams hold the tool it is written for."""
    got = sum((streams[family, s][2] for s in SEEDS), start=type(
        streams[family, SEEDS[0]][2])())
    missing = [k for k in TOOLS[family] if not got[k]]
    assert not missing, (family, missing)


@pytest.mark.parametrize('family,seed', CASES)
def test_decode_equals_cv2_from_every_start(streams, family, seed):
    """Every frame equal to cv2's, decoding the whole clip and decoding
    from every start (cv2's CAP_PROP_POS_FRAMES seek, the JAX package's
    window); one decoder for every window."""
    path, n, _ = streams[family, seed]
    track = mp4_demux.open_track(path)
    assert track.frame_count == n
    dec = h264_decode.Decoder()
    try:
        want = _cv2_rgb(path)
        assert want.shape == (n, *track.hw, 3)
        np.testing.assert_array_equal(_rgb(track, dec.decode(track, 0, n)),
                                      want)
        for start in range(1, n):
            np.testing.assert_array_equal(
                _rgb(track, dec.decode(track, start, n - start)),
                _cv2_rgb(path, start), err_msg=f'{family}@{start}')
    finally:
        dec.close()


@pytest.mark.parametrize('kind', ['idr_p', 'cropped', 'bframes', 'all_uv'])
def test_fixture_clips_decode_to_the_writers_planes(tmp_path, kind):
    """The I_PCM / P_Skip fixtures of make_video_fixtures (the card's
    fixtures, B frames and an edit list included) decode to the writer's
    NV12 exactly, from every start."""
    path = str(tmp_path / f'{kind}.mp4')
    if kind == 'all_uv':
        planes = mvf.write_clip(path, 0, 512, 512, 2,
                                planes=mvf.all_chroma_planes(
                                    np.random.default_rng(5), 2))
        n = 2
    else:
        w, h, kw, mux_kw = {
            'idr_p': (128, 96, dict(gop=8), {}),
            'cropped': (120, 96, dict(gop=5), dict(chunk=5, co64=True,
                                                   moov_first=True)),
            'bframes': (112, 90, dict(gop=6, bframes=True, profile=mvf.HIGH),
                        dict(chunk=3))}[kind]
        n = 12
        planes = mvf.write_clip(path, 3, w, h, n, **kw, **mux_kw)
    want = mvf.nv12(*planes)
    track = mp4_demux.open_track(path)
    dec = h264_decode.Decoder()
    for start in range(n):
        count = min(5, n - start)
        got = dec.decode(track, start, count)
        assert got.dtype == torch.uint8 and got.device.type == 'cpu'
        np.testing.assert_array_equal(got.numpy(), want[start:start + count])
    dec.close()


def test_left_crop_is_the_crop_of_the_whole_picture(tmp_path):
    """A left and top crop (cv2 differs there: module docstring): the
    decode equals the crop of the decoder's uncropped picture."""
    path = str(tmp_path / 'left.mp4')
    n, _ = mhs.write_stream(path, 'cropping', 0, options={'crop_lt': (6, 4)})
    track = mp4_demux.open_track(path)
    assert track.crop[0] == 6 and track.crop[2] == 4
    whole = copy.copy(track)
    whole.hw, whole.crop = track.coded_hw, (0, 0, 0, 0)
    dec = h264_decode.Decoder()
    full = dec.decode(whole, 0, n).numpy()
    got = dec.decode(track, 0, n).numpy()
    h, w = track.hw
    ch = track.coded_hw[0]
    np.testing.assert_array_equal(got[:, :h], full[:, 4:4 + h, 6:6 + w])
    np.testing.assert_array_equal(got[:, h:], full[:, ch + 2:ch + 2 + h // 2,
                                                   6:6 + w])


def test_windows_convert_as_the_whole_frame():
    """The loader's NV12 window (even rows and columns around it) converts
    to the same RGB as the whole frame's window, at odd and even
    corners."""
    rng = np.random.default_rng(2)
    nv12 = torch.from_numpy(rng.integers(0, 256, (3, 72, 80), dtype=np.uint8))
    for y0, x0, ch, cw in ((0, 0, 48, 80), (1, 1, 21, 33), (3, 6, 20, 11),
                           (47, 79, 1, 1), (2, 3, 45, 76)):
        sub, wy, wx = nv12_window(nv12, 48, y0, x0, ch, cw)
        rows = (ch + (y0 & 1) + 1) & ~1
        assert sub.shape == (3, rows * 3 // 2, (cw + (x0 & 1) + 1) & ~1)
        np.testing.assert_array_equal(
            nv12_to_rgb(sub, wy, wx, ch, cw).numpy(),
            nv12_to_rgb(nv12, y0, x0, ch, cw).numpy())


def test_threads_decode_alike(streams):
    """Decoders of one clip in four threads at once give the one thread's
    frames (the ctypes call releases the GIL)."""
    path, n, _ = streams['slices', 0]
    track = mp4_demux.open_track(path)
    want = h264_decode.Decoder().decode(track, 0, n)
    got = [None] * 4

    def run(i):
        d = h264_decode.Decoder()
        got[i] = [d.decode(track, s, n - s) for s in range(0, n, 3)]
        d.close()
    threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for frames in got:
        for s, f in zip(range(0, n, 3), frames):
            assert torch.equal(f, want[s:])


# ------------------------------------------------------------ refusals

class _Stream:
    """Access units given as NAL units, in the shape of an
    ``mp4_demux.Track`` (display order = decode order)."""

    def __init__(self, units, hw=(32, 32)):
        self.units = [b''.join(mp4_demux.START_CODE + u for u in au)
                      for au in units]
        self.hw, self.crop, self.path = hw, (0, 0, 0, 0), '<stream>'

    def window(self, start, count):
        offsets = np.zeros(len(self.units) + 1, np.int64)
        offsets[1:] = np.cumsum([len(u) for u in self.units])
        return (b''.join(self.units), offsets,
                np.arange(len(self.units), dtype=np.int64))


def _sps(profile=77, gaps=0, bypass=0, frame_mbs_only=1, chroma=1, depth=8):
    w = mvf.BitWriter()
    w.u(8, profile)
    w.u(8, 0)
    w.u(8, 30)
    w.ue(0)
    if profile == 100 or chroma != 1 or depth != 8 or bypass:
        w.ue(chroma)
        w.ue(depth - 8)
        w.ue(depth - 8)
        w.u(1, bypass)
        w.u(1, 0)
    w.ue(0)                         # log2_max_frame_num 4
    w.ue(2)                         # POC type 2
    w.ue(2)                         # max_num_ref_frames
    w.u(1, gaps)
    w.ue(1)
    w.ue(1)                         # 2 x 2 macroblocks
    w.u(1, frame_mbs_only)
    if not frame_mbs_only:
        w.u(1, 0)
    w.u(1, 1)
    w.u(1, 0)
    w.u(1, 0)
    w.trailing()
    return mvf.nal(3, 7, w.bytes())


def _pps(cabac=0, groups=0, redundant=0):
    w = mvf.BitWriter()
    w.ue(0)
    w.ue(0)
    w.u(1, cabac)
    w.u(1, 0)
    w.ue(groups)
    if groups:
        w.ue(0)                     # slice_group_map_type 0
        for _ in range(groups + 1):
            w.ue(0)
    w.ue(0)
    w.ue(0)
    w.u(1, 0)
    w.u(2, 0)
    w.se(0)
    w.se(0)
    w.se(0)
    w.u(1, 1)
    w.u(1, 0)
    w.u(1, redundant)
    w.trailing()
    return mvf.nal(3, 8, w.bytes())


def _slice(slice_type, frame_num, first_mb=0, n_mb=4, idr=False,
           redundant=None, mb=None, skip_run=None, ref_idc=2):
    """A slice of I_PCM macroblocks (``mb``: another mb_type to code
    first, ``skip_run``: a first mb_skip_run)."""
    w = mvf.BitWriter()
    w.ue(first_mb)
    w.ue(slice_type)
    w.ue(0)
    w.u(4, frame_num)
    if idr:
        w.ue(0)
    if redundant is not None:
        w.ue(redundant)
    kind = slice_type % 5
    if kind == 1:
        w.u(1, 1)                   # direct_spatial_mv_pred_flag
    if kind in (0, 1, 3):
        w.u(1, 0)
        w.u(1, 0)
        if kind == 1:
            w.u(1, 0)
    if kind == 3:
        w.u(1, 0)                   # sp_for_switch_flag
    if ref_idc:
        w.u(1, 0)
        if idr:
            w.u(1, 0)
    w.se(0)
    if kind in (3, 4):
        w.se(0)                     # slice_qs_delta
    w.ue(1)                         # deblocking off
    pcm = {0: 30, 1: 48, 2: 25, 3: 30, 4: 26}[kind]
    rng = np.random.default_rng(frame_num)
    for i in range(n_mb):
        if kind != 2:
            w.ue(skip_run if skip_run is not None and i == 0 else 0)
        if i == 0 and mb is not None:
            w.ue(mb)
            w.trailing()
            break
        w.ue(pcm)
        w.align_zero()
        w.raw(rng.integers(1, 256, 384, dtype=np.uint8).tobytes())
    else:
        w.trailing()
    return mvf.nal(ref_idc, 5 if idr else 1, w.bytes())


def _idr(sps=None, pps=None):
    return [sps or _sps(), pps or _pps(), _slice(7, 0, idr=True)]


REFUSALS = {
    'cabac': ([[_sps(), _pps(cabac=1), _slice(7, 0, idr=True)]],
              'entropy_coding_mode_flag 1', '5c'),
    'b_inter': ([_idr(), [_slice(6, 1, mb=0, ref_idc=0)]],
                'mb_type 0 in a B slice', '5b'),
    'b_skip': ([_idr(), [_slice(6, 1, skip_run=1, ref_idc=0)]],
               'mb_skip_run 1 in a B slice', '5b'),
    'slice_groups': ([[_sps(), _pps(groups=1), _slice(7, 0, idr=True)]],
                     'num_slice_groups_minus1 1', '5e'),
    'slice_order': ([[_sps(66), _pps(), _slice(7, 0, first_mb=2, n_mb=2,
                                             idr=True),
                      _slice(7, 0, first_mb=0, n_mb=2, idr=True)]],
                    'first_mb_in_slice 0 before macroblock 4', '5e'),
    'redundant': ([[_sps(66), _pps(redundant=1),
                    _slice(7, 0, idr=True, redundant=1)]],
                  'redundant_pic_cnt 1', '5e'),
    'sp': ([_idr(_sps(88)), [_slice(3, 1)]], 'slice_type 3 (SP)', '5e'),
    'si': ([_idr(_sps(88)), [_slice(4, 1)]], 'slice_type 4 (SI)', '5e'),
    'gap': ([_idr(_sps(gaps=1)), [_slice(5, 3)]],
            'gaps_in_frame_num_value_allowed_flag 1 with a gap', '5e'),
    'bypass': ([_idr(_sps(100, bypass=1))],
               'qpprime_y_zero_transform_bypass_flag 1', '5e'),
    'interlaced': ([_idr(_sps(frame_mbs_only=0))], 'frame_mbs_only_flag 0',
                   '5e'),
    'chroma_422': ([_idr(_sps(122, chroma=2))], 'chroma_format_idc 2', '5e'),
    'depth_10': ([_idr(_sps(110, depth=10))], 'bit_depth_luma 10', '5e'),
    'data_partitioning': ([_idr(_sps(88)), [bytes([0x42]) + b'\x88\x80']],
                          'nal_unit_type 2 (data partitioning)', '5e'),
}


@pytest.mark.parametrize('name', list(REFUSALS))
def test_refusals_name_the_syntax_element(name):
    """Each stream the decoder does not read raises UnsupportedH264 (a
    NotImplementedError, which the loader never redraws) naming the syntax
    element, its value and the ROADMAP item."""
    units, field, item = REFUSALS[name]
    dec = h264_decode.Decoder()
    with pytest.raises(UnsupportedH264, match=re.escape(field)) as e:
        dec.decode(_Stream(units), 0, len(units))
    assert isinstance(e.value, NotImplementedError)
    assert f'ROADMAP Queue 1 item {item}' in str(e.value)
    # the decoder stays usable
    good = _Stream([_idr(), [_slice(5, 1)]])
    assert dec.decode(good, 0, 2).shape == (2, 48, 32)


# the refused syntax in a stream whose profile does not allow it (Annex A):
# what only damaged data holds
FORBIDDEN = {
    'sp_in_main': [_idr(), [_slice(3, 1)]],
    'si_in_high': [_idr(_sps(100)), [_slice(4, 1)]],
    'data_partitioning_in_main': [_idr(), [bytes([0x42]) + b'\x88\x80']],
    'slice_order_in_main': [[_sps(), _pps(), _slice(7, 0, first_mb=2,
                                                      n_mb=2, idr=True),
                             _slice(7, 0, first_mb=0, n_mb=2, idr=True)]],
    'redundant_in_main': [[_sps(), _pps(redundant=1),
                           _slice(7, 0, idr=True, redundant=1)]],
    'b_slice_in_baseline': [_idr(_sps(66)), [_slice(6, 1, ref_idc=0)]],
}


@pytest.mark.parametrize('name', list(FORBIDDEN))
def test_syntax_the_profile_forbids_is_corrupt(name):
    """Refused syntax that the stream's profile does not allow raises
    IOError (corrupt data, which the loader redraws), not
    UnsupportedH264."""
    units = FORBIDDEN[name]
    with pytest.raises(IOError, match='does not allow it') as e:
        h264_decode.Decoder().decode(_Stream(units), 0, len(units))
    assert not isinstance(e.value, NotImplementedError)


def test_the_streams_decode_without_the_refused_element():
    """The refusal streams' own base: the same headers and I_PCM slices
    decode to the samples they hold."""
    units = [_idr(), [_slice(5, 1)], [_slice(6, 2, ref_idc=0)]]
    got = h264_decode.Decoder().decode(_Stream(units), 0, 3).numpy()
    rng = np.random.default_rng(0)
    mb0 = rng.integers(1, 256, 384, dtype=np.uint8)
    np.testing.assert_array_equal(got[0, :16, :16], mb0[:256].reshape(16, 16))


def test_sps_reader_names_the_host_decoder():
    """h264_headers' refusals (read from the avcC when a clip is opened)
    name the host decoder and the ROADMAP item, not NVDEC."""
    for nal, field in ((_sps(122, chroma=2), 'chroma_format_idc 2'),
                       (_sps(110, depth=10), 'bit_depth_luma 10'),
                       (_sps(frame_mbs_only=0), 'frame_mbs_only_flag 0')):
        with pytest.raises(NotImplementedError, match=field) as e:
            h264_headers.parse_sps(nal)
        assert 'host decoder' in str(e.value) and 'NVDEC' not in str(e.value)
        assert 'ROADMAP Queue 1 item 5e' in str(e.value)


def test_cabac_clip_refused_when_the_folder_is_indexed(tmp_path):
    """A CABAC clip raises UnsupportedH264 from the avcC's PPS when the
    loader indexes its folder, before any window is drawn."""
    from bsvd_tpu_torch.data.video_train_loader import train_video_loader
    units, params, order, (h, w), profile, _ = mhs.encode('intra4x4', 0)
    folder = tmp_path / 'clips'
    folder.mkdir()
    mvf.mux(str(folder / 'cabac.mp4'), units, (params[0], _pps(cabac=1)),
            order, w, h, profile)
    opt = {'trainset_dir': str(folder), 'batch_size_per_gpu': 1,
           'temp_patch_size': 3, 'patch_size': 16, 'noise_ival': [5, 55],
           'num_workers': 1, 'device': 'cpu'}
    with pytest.raises(UnsupportedH264, match='CABAC'):
        train_video_loader(opt)


def _mux_units(path, units, order):
    """The refusal streams' access units (parameter sets first) as an
    mp4 at ``path``."""
    params = tuple(units[0][:2])
    mvf.mux(str(path), [units[0][2:]] + units[1:], params, order, 32, 32,
            mvf.MAIN)


def test_b_inter_clip_refused_when_the_folder_is_indexed(tmp_path):
    """A clip whose B slice holds an inter macroblock raises
    UnsupportedH264 when the loader indexes its folder (its group of
    pictures is decoded once there), before any window is drawn."""
    from bsvd_tpu_torch.data.video_train_loader import train_video_loader
    folder = tmp_path / 'clips'
    folder.mkdir()
    units = [_idr(), [_slice(5, 1)], [_slice(6, 2, mb=0, ref_idc=0)]]
    _mux_units(folder / 'b.mp4', units,
               [(0, 'I', True), (2, 'P', False), (1, 'B', False)])
    opt = {'trainset_dir': str(folder), 'batch_size_per_gpu': 1,
           'temp_patch_size': 3, 'patch_size': 16, 'noise_ival': [5, 55],
           'num_workers': 1, 'device': 'cpu'}
    with pytest.raises(UnsupportedH264, match='mb_type 0 in a B slice'):
        train_video_loader(opt)


@pytest.mark.parametrize('family', ['poc0_bframes', 'p_partitions'])
def test_check_track_passes_decodable_clips(streams, family):
    """Clips the decoder reads pass the index-time check: intra B slices
    (decoded there) and clips without B slices (not decoded)."""
    path, n, _ = streams[family, 0]
    track = mp4_demux.open_track(path)
    before = h264_decode.frames_decoded
    h264_decode.check_track(track)
    decoded = h264_decode.frames_decoded - before
    assert (decoded > 0) == (family == 'poc0_bframes')


@pytest.mark.parametrize('cut', ['nal', 'sample', 'missing_frame'])
def test_corrupt_data_raises_ioerror(streams, cut):
    """A NAL unit cut short, a sample cut in its length prefix, and a
    missing reference frame raise IOError (the loader redraws those)."""
    path, n, _ = streams['p_partitions', 0]
    track = mp4_demux.open_track(path)
    dec = h264_decode.Decoder()
    if cut == 'sample':
        track.sizes = track.sizes.copy()
        track.sizes[1] -= 7
        with pytest.raises(IOError):
            dec.decode(track, 0, 3)
        return
    data, offsets, ts = track.window(0, 4)
    units = [data[offsets[i]:offsets[i + 1]] for i in range(len(ts))]
    if cut == 'nal':
        units[2] = units[2][:len(units[2]) * 2 // 3]
    else:
        del units[1]
    fake = _Stream([])
    fake.units, fake.hw, fake.crop = units, track.hw, track.crop
    with pytest.raises(IOError) as e:
        dec.decode(fake, 0, len(units))
    assert not isinstance(e.value, NotImplementedError)


def test_corrupt_bytes_raise_or_decode(streams):
    """Bytes overwritten, flipped or zeroed at random in every family's
    stream (300 cases, seeded): the decoder raises IOError or
    UnsupportedH264, or decodes, and never crashes the process."""
    rng = np.random.default_rng(11)
    outcomes = {'decoded': 0, 'IOError': 0, 'UnsupportedH264': 0}
    dec = h264_decode.Decoder()
    for i in range(300):
        path, n, _ = streams[CASES[i % len(CASES)]]
        track = mp4_demux.open_track(path)
        data, offsets, ts = track.window(0, n)
        b = bytearray(data)
        kind = int(rng.integers(3))
        for _ in range(int(rng.integers(1, 6))):
            at = int(rng.integers(len(b)))
            if kind == 0:
                b[at] = int(rng.integers(256))
            elif kind == 1:
                b[at] ^= 1 << int(rng.integers(8))
            else:
                m = int(rng.integers(1, 20))
                b[at:at + m] = bytes(len(b[at:at + m]))
        bad = _Stream([])
        bad.units = [bytes(b[offsets[k]:offsets[k + 1]]) for k in range(n)]
        bad.hw, bad.crop = track.hw, track.crop
        try:
            got = dec.decode(bad, 0, n)
            assert got.shape == (n, track.hw[0] * 3 // 2, track.hw[1])
            outcomes['decoded'] += 1
        except UnsupportedH264:
            outcomes['UnsupportedH264'] += 1
        except IOError:
            outcomes['IOError'] += 1
    dec.close()
    assert outcomes['IOError'] > 100 and outcomes['decoded'] > 0, outcomes
