"""H.264 on the card's NVDEC (the JAX package decodes mp4 clips with cv2
on the host, bsvd_tpu/data/video_train_loader.py:75-84, :114-127). The
train loader does not use it: it decodes every mp4 on the host with
``data/h264_decode``. This binding stays, with its card tests, for a
machine whose container exposes the video engine (ROADMAP Queue 1 item
5).

``_native/nvdec.cpp`` is built by g++ at first use (never at import) into
``bsvd_tpu_torch/_build/bsvd_nvdec-<hash>/``; it declares the CUVID types
itself and ``dlopen``s NVIDIA's ``libnvcuvid.so.1`` and
``libcuda.so.1`` (no Video Codec SDK, no FFmpeg). It decodes in PyTorch's
primary context (current on the calling thread once
``torch.cuda.set_device`` has run there).

A ``Decoder`` is one NVDEC decoder, kept by one thread for one clip as
the JAX package keeps a ``VideoCapture``. ``Decoder.decode(track, start,
count)`` seeks to the last sync sample at or before display frame
``start``, decodes forward, drops the frames before ``start`` and copies
each of the ``count`` display frames, while it is mapped, into a device
NV12 buffer (count, H * 3 / 2, W) uint8 cropped to the display size, on
PyTorch's current stream (synchronised before each frame is unmapped).

No fallback hides the device: an mp4 on a CPU device raises
NotImplementedError naming NVDEC (``require``); a missing
``libnvcuvid.so.1``, a stream NVDEC does not take (``cuvidGetDecoderCaps``)
or a failed ``cuvidCreateDecoder`` raise ``NvdecError`` (a RuntimeError)
with its CUresult; ``NvdecNotExposed`` where the container hides the
card's video engine from the process. Only a window the clip cannot give (a short or
corrupt clip: frames missing after the flush) raises IOError, which the
loader redraws.
"""

import ctypes
import os
import threading
from pathlib import Path

import numpy as np
import torch

from bsvd_tpu_torch.data import _gxx

SOURCE = Path(__file__).resolve().parent / '_native' / 'nvdec.cpp'
GXX_FLAGS = ['-O2', '-std=c++17', '-shared', '-fPIC']
LIBS = ['-ldl']
NVCUVID = 'libnvcuvid.so.1'
CUDA_ERROR_OUT_OF_MEMORY = 2
_ERRLEN = 1024
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

_lock = threading.Lock()
_lib = None
# pictures NVDEC decoded, over every decoder (frames a second on the card)
frames_decoded = 0


class NvdecError(RuntimeError):
    """NVDEC refused: ``code`` is the CUresult it returned (-1
    for the binding's own checks)."""

    def __init__(self, msg, code=-1):
        super().__init__(f'{msg} [code {code}]')
        self.code = code


class NvdecNotExposed(NvdecError):
    """The card's video engine is hidden from this process: NVIDIA's
    container runtime exposes NVDEC only with the 'video' driver
    capability, and without it libnvcuvid loads but every
    ``cuvidGetDecoderCaps`` returns CUDA_ERROR_OUT_OF_MEMORY."""


def _error(msg, code):
    """The NvdecError for a binding call that failed with ``code``:
    NvdecNotExposed only where ``cuvidGetDecoderCaps`` itself returned
    CUDA_ERROR_OUT_OF_MEMORY and NVIDIA_DRIVER_CAPABILITIES is set without
    'video' (or 'all'); any other failure, an unsupported format
    included, is a plain NvdecError."""
    env = os.environ.get('NVIDIA_DRIVER_CAPABILITIES')
    if (code == CUDA_ERROR_OUT_OF_MEMORY and 'cuvidGetDecoderCaps' in msg
            and env is not None
            and not {'video', 'all'} & set(env.split(','))):
        return NvdecNotExposed(
            f'{msg}: NVDEC is not exposed to this process '
            f'(NVIDIA_DRIVER_CAPABILITIES={env} lacks \'video\')', code)
    return NvdecError(msg, code)


def build():
    """Compile the binding if this source has no library yet; its path."""
    return _gxx.build(SOURCE, 'bsvd_nvdec', GXX_FLAGS, LIBS)


def _err():
    return ctypes.create_string_buffer(_ERRLEN)


def lib():
    """The binding, with ``libnvcuvid.so.1`` and ``libcuda.so.1`` loaded
    (built on first call). NvdecError where a library is missing."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            handle.bsvd_nvdec_load.argtypes = [ctypes.c_char_p, _P, _I]
            handle.bsvd_nvdec_caps.argtypes = [_I, _I, _P, _P, _I]
            handle.bsvd_nvdec_open.argtypes = [_P, _I]
            handle.bsvd_nvdec_open.restype = _P
            handle.bsvd_nvdec_close.argtypes = [_P]
            handle.bsvd_nvdec_close.restype = None
            handle.bsvd_nvdec_decode.argtypes = (
                [_P, _P, _P, _P, _I, _LL, _I, ctypes.c_ulonglong]
                + [_I] * 6 + [_P, _P, _P, _P, _I])
            handle.bsvd_nvdec_parse.argtypes = (
                [_P, _P, _P, _I, _LL] + [_I] * 7
                + [_P, _P, _I, _P, _P, _P, _P, _I])
            _lib = handle
        err = _err()
        if _lib.bsvd_nvdec_load(NVCUVID.encode(), err, _ERRLEN):
            raise NvdecError(err.value.decode())
    return _lib


def require(device):
    """``device`` with its card's index; NotImplementedError unless it is
    a CUDA device (NVDEC is on the card)."""
    device = torch.device(device)
    if device.type != 'cuda':
        raise NotImplementedError(
            f'NVDEC decodes on the card; device {device} has none (the '
            f'train loader decodes mp4 on the host with data/h264_decode)')
    if device.index is None:          # the caller's card, not thread 0's
        device = torch.device('cuda', torch.cuda.current_device())
    return device


def _current(device):
    device = require(device)
    torch.cuda.init()
    torch.cuda.set_device(device)     # makes the primary context current
    return device


def caps(device='cuda', chroma_format_idc=1, bit_depth=8):
    """What NVDEC decodes of H.264 at this chroma format and bit depth:
    dict(supported, max_width, max_height, max_mb_count, nvdecs,
    output_formats). NvdecError (naming ``cuvidGetDecoderCaps``) where it
    decodes none, NvdecNotExposed where the engine is hidden."""
    _current(device)
    out = (ctypes.c_uint * 6)()
    err = _err()
    code = lib().bsvd_nvdec_caps(chroma_format_idc, bit_depth - 8, out, err,
                                 _ERRLEN)
    if code:
        raise _error(err.value.decode(), code)
    return dict(zip(('supported', 'max_width', 'max_height', 'max_mb_count',
                     'nvdecs', 'output_formats'), list(out)))


def _frame_args(track):
    """(H, W, crop left, crop top, coded W, coded H) of a track."""
    (h, w), (coded_h, coded_w) = track.hw, track.coded_hw
    left, _, top, _ = track.crop
    return h, w, left, top, coded_w, coded_h


def parse(track, start, count):
    """libnvcuvid's H.264 parser alone (on the CPU: no decoder, no
    context) on the access units ``Decoder.decode(track, start, count)``
    feeds it: its sequence header checked against the SPS as the decoder
    checks it, then dict(decoded: the pictures it hands to decode, shown:
    the timestamps (display indices) of the pictures it displays, in its
    order, window: whether it displays every frame of the window,
    min_surfaces: the stream's ``min_num_decode_surfaces``). The binding's
    parser structs are held to libnvcuvid by it where NVDEC itself is not
    exposed. NvdecError where the parser or the check refuses."""
    data, offsets, ts = track.window(start, count)
    got = np.zeros(count, np.uint8)
    shown = np.zeros(len(ts) + 8, np.int64)
    n_shown, decoded, surfaces = _I(0), _LL(0), ctypes.c_uint(0)
    err = _err()
    code = lib().bsvd_nvdec_parse(
        data, offsets.ctypes.data, ts.ctypes.data, len(ts), start, count,
        *_frame_args(track), got.ctypes.data, shown.ctypes.data, len(shown),
        ctypes.addressof(n_shown), ctypes.addressof(decoded),
        ctypes.addressof(surfaces), err, _ERRLEN)
    if code:
        raise NvdecError(f'{track.path}@{start}: {err.value.decode()}', code)
    return {'decoded': decoded.value,
            'shown': shown[:min(n_shown.value, len(shown))].tolist(),
            'window': bool(got.all()), 'min_surfaces': surfaces.value}


class Decoder:
    """One NVDEC decoder on ``device`` (module docstring); use it from the
    thread that made it, and ``close()`` it there."""

    def __init__(self, device='cuda'):
        self.device = _current(device)
        err = _err()
        self._handle = lib().bsvd_nvdec_open(err, _ERRLEN)
        if not self._handle:
            raise NvdecError(err.value.decode())

    def decode(self, track, start, count):
        """Display frames ``start .. start + count - 1`` of ``track`` (an
        ``mp4_demux.Track``) -> (count, H * 3 / 2, W) uint8 NV12 on the
        device. IOError where the clip cannot give them."""
        global frames_decoded
        data, offsets, ts = track.window(start, count)
        h, w, left, top, coded_w, coded_h = _frame_args(track)
        out = torch.empty((count, h * 3 // 2, w), dtype=torch.uint8,
                          device=self.device)
        got = np.zeros(count, np.uint8)
        decoded = _LL(0)
        err = _err()
        code = lib().bsvd_nvdec_decode(
            self._handle, data, offsets.ctypes.data, ts.ctypes.data,
            len(ts), start, count, out.data_ptr(), h, w, left, top, coded_w,
            coded_h, torch.cuda.current_stream(self.device).cuda_stream,
            got.ctypes.data, ctypes.addressof(decoded), err, _ERRLEN)
        with _lock:
            frames_decoded += decoded.value
        if code:
            raise _error(f'{track.path}@{start}: {err.value.decode()}', code)
        if not got.all():
            raise IOError(f'decode failed at {track.path}@{start}: NVDEC '
                          f'gave {int(got.sum())} of {count} frames')
        return out

    def close(self):
        if self._handle:
            lib().bsvd_nvdec_close(self._handle)
            self._handle = None
