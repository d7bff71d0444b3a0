"""NV12 -> RGB for the train loader's mp4 windows: ``nv12_to_rgb``, the
wrapper of the hand-written kernel ``csrc/nv12_rgb.cu``, and its plain
version ``nv12_to_rgb_plain``.

Both compute what cv2's FFmpeg backend gives for an H.264 4:2:0 frame
after ``cvtColor(BGR2RGB)`` (the JAX package's mp4 route,
bsvd_tpu/data/video_train_loader.py:114-127): swscale's BT.601
limited-range conversion in 16-bit fixed point, each product floored,
chroma from the sample of the pixel's 2 x 2 block (the rule and how it
was found: the kernel's header comment). Integer arithmetic, so the two
agree bit for bit.

Input: NV12 frames (T, H * 3 / 2, W) uint8 (the luma rows, then Cb Cr
interleaved rows), and a window (y0, x0, ch, cw) of the whole frame.
Output: (T, ch, cw, 3) uint8 RGB. CPU tensors take the plain version;
CUDA tensors launch the kernel or raise. ``nv12_to_rgb.launches``
counts the launches (the loader's worker threads launch it: the count
takes a lock).
"""

import threading

import torch

from bsvd_tpu_torch.ops import _build

# swscale's BT.601 limited-range coefficients, roundToInt16(c * 2^13)
Y_GAIN, Y_OFFSET = 9539, 128
V_R, U_G, V_G, U_B = 13075, -3209, -6660, 16525
_count_lock = threading.Lock()


def _check(nv12, y0, x0, ch, cw):
    if nv12.dtype != torch.uint8 or nv12.dim() != 3:
        raise TypeError(f'nv12_to_rgb: NV12 frames (T, H*3/2, W) uint8, '
                        f'got {tuple(nv12.shape)} {nv12.dtype}')
    t, rows, w = nv12.shape
    h = rows * 2 // 3
    if rows != h + h // 2 or h % 2 or w % 2:
        raise ValueError(f'nv12_to_rgb: {rows} rows of width {w} are not '
                         f'an NV12 frame of even size')
    if not (0 <= y0 and 0 <= x0 and ch > 0 and cw > 0 and y0 + ch <= h
            and x0 + cw <= w):
        raise ValueError(f'nv12_to_rgb: window ({y0}, {x0}, {ch}, {cw}) '
                         f'outside the {h} x {w} frame')
    return t, h, w


def nv12_to_rgb_plain(nv12, y0, x0, ch, cw):
    """The plain version (module docstring)."""
    _, h, _ = _check(nv12, y0, x0, ch, cw)
    y = nv12[:, y0:y0 + ch, x0:x0 + cw].to(torch.int32)
    rows = h + torch.arange(y0, y0 + ch, device=nv12.device) // 2
    cols = (torch.arange(x0, x0 + cw, device=nv12.device) // 2) * 2
    uv = nv12[:, rows][:, :, torch.stack([cols, cols + 1], -1)].to(
        torch.int32)
    u = 8 * (uv[..., 0] - 128)
    v = 8 * (uv[..., 1] - 128)
    yy = ((8 * y - Y_OFFSET) * Y_GAIN) >> 16
    rgb = torch.stack([yy + ((v * V_R) >> 16),
                       yy + ((u * U_G) >> 16) + ((v * V_G) >> 16),
                       yy + ((u * U_B) >> 16)], dim=-1)
    return rgb.clamp_(0, 255).to(torch.uint8)


def nv12_to_rgb(nv12, y0, x0, ch, cw):
    """(T, H*3/2, W) uint8 NV12 -> (T, ch, cw, 3) uint8 RGB of the window
    at (y0, x0); the kernel on a CUDA tensor, the plain version on a CPU
    one."""
    t, h, w = _check(nv12, y0, x0, ch, cw)
    if nv12.device.type == 'cpu':
        return nv12_to_rgb_plain(nv12, y0, x0, ch, cw)
    if nv12.device.type != 'cuda':
        raise RuntimeError(f'nv12_to_rgb: no kernel for device {nv12.device}')
    nv12 = nv12.contiguous()
    out = torch.empty((t, ch, cw, 3), dtype=torch.uint8, device=nv12.device)
    err = _build.lib().bsvd_nv12_rgb(nv12.data_ptr(), out.data_ptr(), t, h,
                                     w, y0, x0, ch, cw,
                                     _build.stream_ptr(nv12))
    _build.check(err, 'nv12_to_rgb')
    with _count_lock:
        nv12_to_rgb.launches += 1
    return out


nv12_to_rgb.launches = 0


def window_bytes(t, y0, x0, ch, cw):
    """Bytes the conversion of one window must move: its luma and the
    chroma pairs it covers read once, the RGB written once."""
    rows = (y0 + ch - 1) // 2 - y0 // 2 + 1
    pairs = (x0 + cw - 1) // 2 - x0 // 2 + 1
    return t * (ch * cw + rows * pairs * 2 + ch * cw * 3)
