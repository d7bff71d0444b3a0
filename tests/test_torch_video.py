"""The port's mp4 path on the CPU: the demuxer (``data/mp4_demux``), the
SPS reader (``data/h264_headers``), the plain NV12 -> RGB conversion
(``data/yuv``) and ``train_video_loader`` over a folder of mp4 clips,
against the fixture writer's ground truth (``tools/make_video_fixtures``),
cv2's FFmpeg and the JAX package's loader.

The fixtures: H.264 CAVLC of ``I_PCM`` / ``P_Skip`` macroblocks, whose
decode is exactly the planes written (cv2's luma is checked against them
below): IDR/P at 128 x 96; IDR/P cropped to 120 x 96 (coded 128 x 96,
``co64``, ``moov`` first, 5-sample chunks); High profile with
non-reference B frames, ``ctts`` and an edit list, cropped to 112 x 90.

The loader decodes with the port's host decoder (``data/h264_decode``,
held to cv2 on every coding tool in tests/test_torch_h264.py) on every
device; here the whole route is the port's own: the demuxer's window, the
decode, the draws, the crop, the plain conversion, augmentation and
noise. NVDEC runs only on the card (tests/test_torch_cuda.py,
chip_smoke.py phase 16), and the loader does not use it.

Tolerances: none. Every comparison is of integer decodes and the same
integer or numpy arithmetic: equal bit for bit.
"""

import os
import struct
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from bsvd_tpu_torch.data import h264_decode, h264_headers, mp4_demux, nvdec
from bsvd_tpu_torch.data.video_train_loader import train_video_loader
from bsvd_tpu_torch.data.yuv import nv12_to_rgb, nv12_to_rgb_plain
from tools import make_video_fixtures as mvf
from torch_threads import one_torch_thread  # noqa: F401

cv2 = pytest.importorskip('cv2')

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FRAMES = 12
# name -> (width, height, writer options, mux options)
KINDS = {
    'idr_p': (128, 96, dict(gop=8), {}),
    'cropped': (120, 96, dict(gop=5),
                dict(chunk=5, co64=True, moov_first=True)),
    'bframes': (112, 90, dict(gop=6, bframes=True, profile=mvf.HIGH),
                dict(chunk=3)),
}


@pytest.fixture(scope='module')
def clips(tmp_path_factory):
    """name -> (path, (y, u, v) display planes, decode order)."""
    root = tmp_path_factory.mktemp('mp4_clips')
    out = {}
    for seed, (name, (w, h, kw, mux_kw)) in enumerate(KINDS.items()):
        path = str(root / f'{name}.mp4')
        planes = mvf.write_clip(path, seed, w, h, N_FRAMES, **kw, **mux_kw)
        out[name] = (path, planes, mvf.gop_order(N_FRAMES, kw['gop'],
                                                 kw.get('bframes', False)))
    return out


def _cv2_frames(path, convert=True):
    args = () if convert else (cv2.CAP_FFMPEG, [cv2.CAP_PROP_CONVERT_RGB, 0])
    cap = cv2.VideoCapture(path, *args)
    frames = []
    while True:
        ok, img = cap.read()
        if not ok:
            break
        frames.append(img.copy())
    cap.release()
    return np.stack(frames)


@pytest.mark.parametrize('kind', list(KINDS))
def test_demuxer_matches_the_writer_and_cv2(clips, kind):
    """Frame count (= cv2.CAP_PROP_FRAME_COUNT), display order, sync
    samples and the SPS's sizes against the writer, and cv2's decode of
    the same file equal to the writer's planes (its luma, read without
    conversion, and its frame size)."""
    path, (y, u, v), order = clips[kind]
    track = mp4_demux.open_track(path)
    cap = cv2.VideoCapture(path)
    assert track.frame_count == N_FRAMES == int(
        cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    disp = [d for d, _, _ in order]
    np.testing.assert_array_equal(track.display, np.argsort(disp))
    np.testing.assert_array_equal(np.nonzero(track.sync)[0],
                                  [i for i, o in enumerate(order) if o[2]])
    w, h = KINDS[kind][:2]
    assert track.hw == (h, w) == y.shape[1:]
    assert track.coded_hw == (-(-h // 16) * 16, -(-w // 16) * 16)
    assert track.crop == (0, track.coded_hw[1] - w, 0, track.coded_hw[0] - h)
    assert _cv2_frames(path).shape == (N_FRAMES, h, w, 3)
    np.testing.assert_array_equal(_cv2_frames(path, convert=False), y)
    assert track.header['profile_idc'] == KINDS[kind][2].get('profile',
                                                             mvf.MAIN)


@pytest.mark.parametrize('kind', list(KINDS))
def test_windows_are_annexb_from_the_last_sync_sample(clips, kind):
    """From every start: the access units from the last IDR at or before
    the window to the last sample it needs, each after a start code, the
    SPS and PPS before the IDR, and every display index of the window."""
    path, _, order = clips[kind]
    track = mp4_demux.open_track(path)
    for start in range(N_FRAMES - 4):
        data, offsets, ts = track.window(start, 4)
        first, last = track.window_samples(start, 4)
        assert order[first][2] and order[first][0] <= start
        assert not any(o[2] and o[0] <= start for o in order[first + 1:])
        assert set(range(start, start + 4)) <= set(ts.tolist())
        assert len(offsets) == last - first + 2
        units = [data[offsets[i]:offsets[i + 1]] for i in range(len(ts))]
        assert all(u.startswith(mp4_demux.START_CODE) for u in units)
        nal_types = [n[0] & 0x1F for n in units[0].split(
            mp4_demux.START_CODE)[1:]]
        assert nal_types == [7, 8, 5]
    with pytest.raises(IOError, match='decode failed'):
        track.window(N_FRAMES - 3, 4)


def _sps(profile, chroma=1, depth=8, frame_mbs_only=1, vui=None):
    """An SPS NAL unit with the fields under test (others as the writer's).
    vui: (full_range, matrix) for a colour description."""
    w = mvf.BitWriter()
    w.u(8, profile)
    w.u(8, 0)
    w.u(8, 40)
    w.ue(0)
    if profile in (100, 110, 122, 244):
        w.ue(chroma)
        if chroma == 3:
            w.u(1, 0)
        w.ue(depth - 8)
        w.ue(depth - 8)
        w.u(1, 0)
        w.u(1, 0)
    w.ue(4)
    w.ue(0)
    w.ue(4)
    w.ue(1)
    w.u(1, 0)
    w.ue(119)                     # 1920 / 16 - 1
    w.ue(67 if frame_mbs_only else 33)
    w.u(1, frame_mbs_only)
    if not frame_mbs_only:
        w.u(1, 0)
    w.u(1, 1)
    w.u(1, 1)                     # cropping: 1088 -> 1080
    for c in (0, 0, 0, 4):
        w.ue(c)
    w.u(1, int(vui is not None))
    if vui is not None:
        w.u(1, 0)
        w.u(1, 0)
        w.u(1, 1)
        w.u(3, 5)
        w.u(1, vui[0])
        w.u(1, 1)
        w.u(8, 1)
        w.u(8, 1)
        w.u(8, vui[1])
        w.u(1, 0)
        w.u(1, 0)
        w.u(1, 0)
        w.u(1, 0)
        w.u(1, 0)
        w.u(1, 0)
    w.trailing()
    return mvf.nal(3, 7, w.bytes())


def test_sps_reader_sizes_and_refusals():
    """1080p with its crop; 8-bit 4:2:0 progressive BT.601 is read, the
    rest raises NotImplementedError naming the field."""
    for profile in (66, 77, 100):
        sps = h264_headers.parse_sps(_sps(profile))
        assert sps['hw'] == (1080, 1920) and sps['coded_hw'] == (1088, 1920)
    assert h264_headers.parse_sps(_sps(100, vui=(0, 6)))['hw'] == (1080,
                                                                  1920)
    for nal, field in ((_sps(244, chroma=3), 'chroma_format_idc 3'),
                       (_sps(122, chroma=2), 'chroma_format_idc 2'),
                       (_sps(110, depth=10), 'bit_depth_luma 10'),
                       (_sps(77, frame_mbs_only=0), 'frame_mbs_only_flag 0'),
                       (_sps(100, vui=(1, 6)), 'video_full_range_flag 1'),
                       (_sps(100, vui=(0, 1)), 'matrix_coefficients 1')):
        with pytest.raises(NotImplementedError, match=field):
            h264_headers.parse_sps(nal)
    with pytest.raises(IOError, match='truncated'):
        h264_headers.parse_sps(_sps(77)[:6])


@pytest.mark.parametrize('kind', list(KINDS))
def test_plain_conversion_equals_cv2(clips, kind):
    """nv12_to_rgb_plain on the writer's planes equals cv2's decode (BGR
    -> RGB) on every pixel of every frame, and a window at odd and even
    (y0, x0) equals that crop of it."""
    path, planes, _ = clips[kind]
    want = _cv2_frames(path)[..., ::-1]
    nv12 = torch.from_numpy(mvf.nv12(*planes))
    h, w = planes[0].shape[1:]
    np.testing.assert_array_equal(
        nv12_to_rgb_plain(nv12, 0, 0, h, w).numpy(), want)
    for y0, x0 in ((0, 0), (1, 0), (0, 1), (3, 5), (h - 21, w - 33)):
        np.testing.assert_array_equal(
            nv12_to_rgb(nv12, y0, x0, 21, 33).numpy(),
            want[:, y0:y0 + 21, x0:x0 + 33])


def test_plain_conversion_equals_cv2_on_every_chroma_pair(tmp_path):
    """A 512 x 512 I_PCM frame whose chroma holds every (Cb, Cr) pair,
    the luma random: every pixel equal to cv2's."""
    planes = mvf.all_chroma_planes(np.random.default_rng(5))
    path = str(tmp_path / 'all_uv.mp4')
    got = mvf.write_clip(path, 0, 512, 512, 1, planes=planes)
    want = _cv2_frames(path)[..., ::-1]
    np.testing.assert_array_equal(
        nv12_to_rgb_plain(torch.from_numpy(mvf.nv12(*got)), 0, 0, 512,
                          512).numpy(), want)
    with pytest.raises(ValueError, match='outside'):
        nv12_to_rgb_plain(torch.from_numpy(mvf.nv12(*got)), 1, 0, 512, 512)


@pytest.mark.parametrize('kind', list(KINDS))
def test_cv2_seeks_are_frame_accurate_on_the_fixtures(clips, kind):
    """The JAX package's window (CAP_PROP_POS_FRAMES, then seq_len reads)
    is the frame-accurate one on each fixture, B frames and edit list
    included: the loader comparison below holds the port to it."""
    path = clips[kind][0]
    seq = _cv2_frames(path)
    for start in range(N_FRAMES):
        cap = cv2.VideoCapture(path)
        cap.set(cv2.CAP_PROP_POS_FRAMES, start)
        ok, img = cap.read()
        cap.release()
        assert ok
        np.testing.assert_array_equal(img, seq[start])


def _opt(root, **over):
    return dict({'trainset_dir': root, 'batch_size_per_gpu': 2,
                 'temp_patch_size': 5, 'patch_size': [24, 40],
                 'max_number_patches': 6, 'noise_ival': [5, 55],
                 'noise_shape': 'NF', 'num_workers': 1, 'manual_seed': 4,
                 'device': 'cpu'}, **over)


@pytest.mark.parametrize('kind', list(KINDS))
def test_loader_over_mp4_equals_jax(clips, kind, tmp_path):
    """Three batches bit for bit against the JAX package's loader (cv2's
    decode) over a folder of the clip and a copy, one worker, the same
    seed: the clip, start, row and column drawn in JAX's order for video,
    the window decoded on the host and converted by the plain version,
    augmentation and noise."""
    from bsvd_tpu.data.video_train_loader import train_video_loader as jax
    path, _, _ = clips[kind]
    data = open(path, 'rb').read()
    folder = tmp_path / 'clips'
    folder.mkdir()
    for name in ('a.mp4', 'b.mp4'):
        (folder / name).write_bytes(data)
    opt = _opt(str(folder), manual_seed=4 + len(kind))
    decoded = h264_decode.frames_decoded
    ours, ref = train_video_loader(opt), jax(dict(opt))
    try:
        got, want = list(ours), list(ref)
    finally:
        ours.close()
        ref.close()
    assert len(got) == len(want) == 3
    assert h264_decode.frames_decoded - decoded >= 6 * opt['temp_patch_size']
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        for k in b:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize('device,want', [
    ('cuda', 'cuda:1'), ('cuda:2', 'cuda:2'), ('cpu', 'cpu')])
def test_loader_keeps_the_builders_card(clips, tmp_path, monkeypatch,
                                        device, want):
    """A CUDA device with no index is the card current on the thread that
    builds the loader (a rank's after set_device, under torchrun), and the
    worker threads' streams go to it, not to their own current card 0."""
    from bsvd_tpu_torch.data.video_train_loader import _ClipIndex
    folder = tmp_path / 'clips'
    folder.mkdir()
    (folder / 'a.mp4').write_bytes(open(clips['idr_p'][0], 'rb').read())
    made = []
    monkeypatch.setattr(torch.cuda, 'current_device', lambda: 1)
    monkeypatch.setattr(torch.cuda, 'Stream',
                        lambda dev: made.append(torch.device(dev)))
    index = _ClipIndex(str(folder), device)
    assert index.device == torch.device(want)
    if index.device.type == 'cuda':
        monkeypatch.setattr(torch.cuda, 'current_device', lambda: 0)
        worker = threading.Thread(target=index._stream)
        worker.start()
        worker.join()
        assert made == [torch.device(want)]


def test_loader_over_frame_folders_asks_no_card(tmp_path, monkeypatch):
    """Without mp4 clips the loader resolves no card (it converts none)."""
    from bsvd_tpu_torch.data.video_train_loader import _ClipIndex
    clip = tmp_path / 'clips' / 'c0'
    clip.mkdir(parents=True)
    (clip / '00000.png').write_bytes(b'')

    def no_card():
        raise AssertionError('a card asked for over frame folders')
    monkeypatch.setattr(torch.cuda, 'current_device', no_card)
    assert _ClipIndex(str(tmp_path / 'clips'), 'cuda').device is None


def test_nvdec_decoder_on_a_cpu_device_raises_naming_nvdec():
    """NVDEC has no CPU device: its decoder refuses one."""
    with pytest.raises(NotImplementedError, match='NVDEC'):
        nvdec.Decoder('cpu')


def test_missing_libnvcuvid_raises_naming_it():
    """The binding builds with g++ alone; without NVIDIA's video
    library loading it raises NvdecError naming the library."""
    code = ('from bsvd_tpu_torch.data import nvdec\n'
            'nvdec.NVCUVID = "libnvcuvid_absent.so.1"\n'
            'try:\n    nvdec.lib()\n'
            'except nvdec.NvdecError as e:\n    print("REFUSED", e)\n')
    res = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert 'REFUSED libnvcuvid_absent.so.1 not found' in res.stdout


@pytest.mark.parametrize('code,msg,env,hidden', [
    (2, 'cuvidGetDecoderCaps: CUDA_ERROR_OUT_OF_MEMORY', 'compute,utility',
     True),
    (2, 'cuvidGetDecoderCaps: CUDA_ERROR_OUT_OF_MEMORY',
     'compute,utility,video', False),
    (2, 'cuvidGetDecoderCaps: CUDA_ERROR_OUT_OF_MEMORY', 'all', False),
    (2, 'cuvidGetDecoderCaps: CUDA_ERROR_OUT_OF_MEMORY', None, False),
    (2, 'cuvidCreateDecoder: CUDA_ERROR_OUT_OF_MEMORY', 'compute,utility',
     False),
    (-1, 'cuvidGetDecoderCaps: NVDEC on this card does not decode H.264 '
     'chroma_format 1, bit depth 8', 'compute,utility', False),
])
def test_nvdec_not_exposed_only_on_its_evidence(monkeypatch, code, msg, env,
                                                hidden):
    """NvdecNotExposed (which the card tests skip on) only where
    cuvidGetDecoderCaps returned CUDA_ERROR_OUT_OF_MEMORY in a container
    whose driver capabilities lack 'video'; anything else, a format the
    engine refuses or a struct it reads wrong included, is an error."""
    if env is None:
        monkeypatch.delenv('NVIDIA_DRIVER_CAPABILITIES', raising=False)
    else:
        monkeypatch.setenv('NVIDIA_DRIVER_CAPABILITIES', env)
    e = nvdec._error(msg, code)
    assert isinstance(e, nvdec.NvdecError) and e.code == code
    assert isinstance(e, nvdec.NvdecNotExposed) == hidden
    assert msg in str(e) and ('lacks \'video\'' in str(e)) == hidden


def test_unsupported_and_broken_files_raise(clips, tmp_path):
    """Another codec and a fragmented file raise NotImplementedError naming
    the codec / box; a file cut inside its samples raises IOError at the
    window; an empty one at the index."""
    data = open(clips['idr_p'][0], 'rb').read()
    at = data.index(b'avc1', data.index(b'stsd'))
    hevc = tmp_path / 'hevc.mp4'
    hevc.write_bytes(data[:at] + b'hvc1' + data[at + 4:])
    with pytest.raises(NotImplementedError, match="'hvc1'"):
        mp4_demux.open_track(str(hevc))
    frag = tmp_path / 'frag.mp4'
    frag.write_bytes(data + struct.pack('>I4s', 8, b'moof'))
    with pytest.raises(NotImplementedError, match='moof'):
        mp4_demux.open_track(str(frag))
    # moov first: the file cut in the middle of its mdat, whose size says
    # so (a copy cut short and its header rewritten)
    data = open(clips['cropped'][0], 'rb').read()
    mdat = data.index(b'mdat') - 4
    cut = tmp_path / 'cut.mp4'
    half = len(data) // 2
    cut.write_bytes(data[:mdat] + struct.pack('>I', half - mdat)
                    + data[mdat + 4:half])
    track = mp4_demux.open_track(str(cut))
    track.window(0, 2)
    with pytest.raises(IOError, match='cut.mp4'):
        track.window(N_FRAMES - 4, 4)
    empty = tmp_path / 'empty.mp4'
    empty.write_bytes(b'')
    with pytest.raises(IOError, match='empty.mp4'):
        mp4_demux.open_track(str(empty))
