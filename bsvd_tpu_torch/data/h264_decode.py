"""H.264 decoded on the host by the port's own C++ (the JAX package decodes
the same mp4 clips with cv2's FFmpeg, bsvd_tpu/data/video_train_loader.py
:50-52, :114-127): ``_native/h264_decode.cpp``, standard C++ only, built
by g++ at first use (never at import) into
``bsvd_tpu_torch/_build/bsvd_h264-<hash>/`` and bound with ctypes. It is
the train loader's decoder for every mp4 clip on every device.

``Decoder().decode(track, start, count)`` decodes display frames ``start
.. start + count - 1`` of an ``mp4_demux.Track`` from the last sync sample
at or before ``start`` and returns them as (count, H * 3 / 2, W) uint8
NV12 on the CPU (the luma rows, then Cb Cr interleaved), cropped to the
displayed size: the frames cv2's decode gives before its conversion, bit
for bit (tests/test_torch_h264.py). A decoder keeps its buffers between
calls; use each from one thread at a time (the ctypes call releases the
GIL, so threads with decoders of their own decode in parallel).

It decodes progressive 8-bit 4:2:0 CAVLC streams with I and P slices
(Constrained Baseline, and Main / High streams coded with
``entropy_coding_mode_flag`` 0 whose B slices hold intra macroblocks
only); the coding tools are listed at the top of the C++ source. Streams
it does not decode raise ``UnsupportedH264`` naming the syntax element,
its value and the ROADMAP item that will take it: CABAC and inter
macroblocks in B slices (both found by ``check_track`` when a loader
indexes its folder), slice groups, arbitrary slice order, redundant
pictures, SP / SI slices, data partitioning, a gap in ``frame_num``,
lossless macroblocks, and the formats ``h264_headers`` refuses. Corrupt
or truncated data raises IOError, and so does refused syntax the
stream's profile does not allow (only damaged data holds it).
"""

import ctypes
import threading
from pathlib import Path

import numpy as np
import torch

from bsvd_tpu_torch.data import _gxx, h264_headers

SOURCE = Path(__file__).resolve().parent / '_native' / 'h264_decode.cpp'
GXX_FLAGS = ['-O2', '-shared', '-fPIC', '-std=c++20']
_ERRLEN = 512

_lock = threading.Lock()
_lib = None
# pictures decoded by every Decoder of the process (decode windows start at
# a sync sample, so this counts more than the frames returned)
frames_decoded = 0


class UnsupportedH264(NotImplementedError):
    """A valid H.264 stream of a kind the host decoder does not decode
    (module docstring); the message names the syntax element, its value
    and the ROADMAP item."""


def build():
    """Compile the decoder if this source has no library yet; returns its
    path. Raises RuntimeError with g++'s output on failure."""
    return _gxx.build(SOURCE, 'bsvd_h264', GXX_FLAGS, [])


def lib():
    """The loaded library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            so = ctypes.CDLL(str(build()))
            so.bsvd_h264_open.restype = ctypes.c_void_p
            so.bsvd_h264_open.argtypes = []
            so.bsvd_h264_close.restype = None
            so.bsvd_h264_close.argtypes = [ctypes.c_void_p]
            so.bsvd_h264_decode.restype = ctypes.c_int
            so.bsvd_h264_decode.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_char_p, ctypes.c_int]
            _lib = so
        return _lib


def check_track(track):
    """Raise UnsupportedH264 for what a loader must learn of a clip when it
    indexes its folder, not at a window mid-run: a CABAC stream (each
    PPS's ``entropy_coding_mode_flag`` in the ``avcC``; the decoder
    refuses the rest of a PPS when it reads it), and inter macroblocks in
    B slices: each group of pictures that holds a B slice is decoded once,
    through its last B slice (an encoder's first B picture refuses at
    once). Corrupt data is left to the windows, which raise IOError."""
    for nal in track.pps:
        r = h264_headers.BitReader(h264_headers.rbsp(nal))
        r.ue()                                # pic_parameter_set_id
        r.ue()                                # seq_parameter_set_id
        if r.u(1):
            raise UnsupportedH264(
                f'{track.path}: H.264 entropy_coding_mode_flag 1 (CABAC): '
                f'the host decoder reads CAVLC streams only (ROADMAP Queue '
                f'1 item 5c)')
    b_samples = _b_samples(track)
    if not b_samples:
        return
    syncs = list(np.nonzero(track.sync)[0]) + [len(track.sizes)]
    dec = Decoder()
    try:
        for first, end in zip(syncs, syncs[1:]):
            held = [i for i in b_samples if first <= i < end]
            shown = track.disp_index[first:held[-1] + 1] if held else []
            shown = [int(d) for d in shown if d >= 0]
            if not shown:
                continue
            try:
                dec.decode(track, min(shown), max(shown) - min(shown) + 1)
            except IOError:
                pass              # corrupt: the windows there raise it too
    finally:
        dec.close()


def _b_samples(track):
    """Decode indices of the samples that hold a B slice (slice_type, the
    second field of a slice header)."""
    out, n = [], track.length_size
    with open(track.path, 'rb') as f:
        for i, (at, size) in enumerate(zip(track.offsets, track.sizes)):
            f.seek(int(at))
            sample = f.read(int(size))
            pos = 0
            while pos + n <= len(sample):
                length = int.from_bytes(sample[pos:pos + n], 'big')
                nal = sample[pos + n:pos + n + length]
                pos += n + length
                if not nal or nal[0] & 0x1F not in (1, 5):
                    continue
                r = h264_headers.BitReader(h264_headers.rbsp(nal[:16]))
                try:
                    r.ue()                    # first_mb_in_slice
                    kind = r.ue() % 5         # slice_type
                except IOError:
                    continue                  # corrupt: left to the windows
                if kind == 1:
                    out.append(i)
                    break
    return out


class Decoder:
    """One host decoder (module docstring); ``close()`` frees it."""

    def __init__(self):
        self._handle = lib().bsvd_h264_open()

    def decode(self, track, start, count):
        """Display frames ``start .. start + count - 1`` of ``track`` ->
        (count, H * 3 / 2, W) uint8 NV12 on the CPU. IOError where the
        clip cannot give them, UnsupportedH264 where the stream is of a
        kind not decoded."""
        global frames_decoded
        if self._handle is None:
            raise ValueError('h264_decode.Decoder: closed')
        data, offsets, ts = track.window(start, count)
        h, w = track.hw
        left, _, top, _ = track.crop
        out = np.empty((count, h * 3 // 2, w), np.uint8)
        got = np.zeros(count, np.uint8)
        decoded = ctypes.c_int64(0)
        err = ctypes.create_string_buffer(_ERRLEN)
        code = lib().bsvd_h264_decode(
            self._handle, data, offsets.ctypes.data, ts.ctypes.data,
            len(ts), start, count, out.ctypes.data, h, w, left, top,
            got.ctypes.data, ctypes.addressof(decoded), err, _ERRLEN)
        with _lock:
            frames_decoded += decoded.value
        msg = f'{track.path}@{start}: {err.value.decode(errors="replace")}'
        if code == 2:
            raise UnsupportedH264(msg)
        if code:
            raise IOError(f'decode failed at {msg}')
        if not got.all():
            raise IOError(f'decode failed at {track.path}@{start}: the '
                          f'stream gave {int(got.sum())} of {count} frames')
        return torch.from_numpy(out)

    def close(self):
        if self._handle is not None:
            lib().bsvd_h264_close(self._handle)
            self._handle = None

    def __del__(self):
        if getattr(self, '_handle', None) is not None and _lib is not None:
            _lib.bsvd_h264_close(self._handle)
            self._handle = None
