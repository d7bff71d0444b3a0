"""The cv2 image operations the port's face, degradation and metric modules
call, on torch tensors, on the tensor's device (counterparts of the
``cv2.*`` calls in the JAX package's ``utils/face_util.py``,
``utils/img_process_util.py``, ``data/degradations.py``,
``metrics/niqe.py`` and ``scripts/data_preparation/
prepare_hifacegan_dataset.py``).

Images are ``(H, W)`` or ``(H, W, C)`` tensors, uint8 or float32, as cv2
takes numpy arrays; sizes are cv2's ``(width, height)``. The arithmetic is
cv2 5.0's, found against cv2 5.0 (opencv-python, x86-64, AVX2 dispatch):

- ``resize`` INTER_LINEAR on uint8: 11-bit coefficients, the row pass in
  integers, the column pass as cv2's SIMD does it: ``((S0 >> 4) * b0 >>
  16) + ((S1 >> 4) * b1 >> 16) + 2 >> 2`` (not INTER_LINEAR_EXACT). Column
  positions are clamped, row fractions are not (the rows are). A downscale
  by exactly 2 on both axes is INTER_AREA, as in cv2.
- ``resize`` INTER_AREA on uint8: an integer factor sums its blocks
  (factor 2 rounds ``(s + 2) >> 2``, others ``rint(s * float32(1 /
  area))``); a fractional one accumulates cv2's area table in float32,
  row pass then column pass, and rounds half to even. Upscaling by
  INTER_AREA is not ported (no caller).
- ``resize`` INTER_CUBIC: cv2 5.0 sends uint8 cubic resizes to IPP
  (ippicv), whose rounding is its own. The port computes Keys' cubic
  (a = -0.75, cv2's taps and clamped borders) in float64 and rounds half to
  even: within 1 LSB of cv2 on at most 0.01% of pixels (measured 4e-6 to
  2e-5 at 64-128 -> 512; the tests hold 0.1%). With
  ``cv2.ipp.setUseIPP(False)`` cv2 takes its own fixed-point path instead,
  which the port does not copy.
- ``warp_affine`` (INTER_LINEAR, BORDER_CONSTANT): the matrix is inverted in
  float64 as cv2 inverts it; the source position is
  ``fma(M0, x, float32(float32(M1 * y) + M2))`` in float32 and the sample
  three fused lerps ``fma(a, p01 - p00, p00)``, ``fma(b, v1 - v0, v0)``;
  uint8 rounds half to even. Bit-equal on uint8; on float32 but for the
  last ``W % 16`` columns of a row, which cv2 computes apart (within
  5e-6 on [0, 1] data).
- ``gaussian_blur``: cv2's kernel (its 1-9 tap tables for sigma <= 0, else
  exp in float64). uint8 takes cv2's fixed-point path: the kernel in
  1/256ths by error diffusion, rows then columns in integers, ``(v + 2^15)
  >> 16``; bit-equal. float32: the row pass as fused multiply-adds left to
  right, the column pass on symmetric pairs; from 7 taps equal to cv2 but
  for the last ``W * C % 8`` values of a row, and at 3 or 5 taps (cv2's
  small-kernel path) within 1.2e-7.
- ``filter2d`` (ddepth -1, anchor at ``k // 2``, BORDER_REFLECT_101): a
  float32 sum of fused multiply-adds over the kernel's nonzero taps in row
  order, rounded half to even for uint8; bit-equal up to 11 x 11. From
  12 x 12 (a kernel area of 130 or more) cv2 filters through a DFT: the
  port stays direct and differs by 1 LSB on at most 0.1% of pixels
  (measured 0.002% with 12-20 tap motion kernels).
- ``erode``: the minimum over a rectangle of ones, anchor at its centre,
  the border never the minimum; an empty kernel is cv2's 3 x 3.
- ``cvt_color``: RGB <-> BGR, and BGR -> GRAY of float32 (0.114 / 0.587
  / 0.299 in fused multiply-adds, within 1.2e-7).

A fused multiply-add is computed exactly in float64 and rounded to float32
(``_fma``), so the CPU and the card give the same bits. The tables
(positions, coefficients) depend on sizes and matrices only and are made
on the host; the pixels never leave the tensor's device.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

INTER_LINEAR = 1
INTER_CUBIC = 2
INTER_AREA = 3
COLOR_BGR2RGB = 4
COLOR_RGB2BGR = 4
COLOR_BGR2GRAY = 6

_F32 = np.float32


def _fma(a, b, c):
    """float32 fma(a, b, c): the product and sum in float64, one rounding
    to float32 (the float64 sum is exact for the operands used here)."""
    a = a.double() if torch.is_tensor(a) else float(a)
    b = b.double() if torch.is_tensor(b) else float(b)
    c = c.double() if torch.is_tensor(c) else float(c)
    return (a * b + c).float()


def _hwc(img):
    """(H, W, C) view of an (H, W) or (H, W, C) tensor, and whether it was
    2-D."""
    if not torch.is_tensor(img):
        raise TypeError(f'cv2_ops takes torch tensors, got {type(img)}')
    if img.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f'cv2_ops takes uint8 or float32, got {img.dtype}')
    if img.ndim == 2:
        return img[..., None], True
    if img.ndim != 3:
        raise ValueError(f'cv2_ops takes (H, W) or (H, W, C), got '
                         f'{tuple(img.shape)}')
    return img, False


def _out(x, squeeze):
    return x[..., 0] if squeeze else x


def _to_u8(x):
    """rint (half to even) and saturate to uint8."""
    return torch.round(x).clamp_(0, 255).to(torch.uint8)


def _reflect101(n, lo, hi):
    """Source indices of positions lo..hi-1 of an axis of length n under
    BORDER_REFLECT_101 (repeated reflection for short axes)."""
    i = np.arange(lo, hi)
    if n == 1:
        return np.zeros_like(i)
    period = 2 * (n - 1)
    i = np.mod(i, period)
    return np.where(i >= n, period - i, i)


def _idx(a, device):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.long,
                           device=device)


# ----------------------------------------------------------------- resize
def _linear_tables(ssize, dsize, clamp):
    """cv2's INTER_LINEAR positions and 11-bit coefficients of one axis.
    ``clamp`` is cv2's column rule (a position outside the source takes
    its edge pixel with weight 1); rows keep their fraction and clamp the
    row indices only."""
    scale = 1.0 / (dsize / ssize)
    f = ((np.arange(dsize) + 0.5) * scale - 0.5).astype(_F32)
    s = np.floor(f).astype(np.int64)
    f = (f - s).astype(_F32)
    if clamp:
        lo = s < 0
        f[lo], s[lo] = 0, 0
        hi = s >= ssize - 1
        f[hi], s[hi] = 0, ssize - 1
    a1 = np.rint(f * _F32(2048)).astype(np.int64)
    a0 = np.rint((_F32(1) - f) * _F32(2048)).astype(np.int64)
    return np.clip(s, 0, ssize - 1), np.clip(s + 1, 0, ssize - 1), a0, a1


def _resize_linear(x, dw, dh):
    h, w, c = x.shape
    dev = x.device
    xs0, xs1, xa0, xa1 = _linear_tables(w, dw, True)
    ys0, ys1, ya0, ya1 = _linear_tables(h, dh, False)
    s = x.long()
    hrow = (s[:, _idx(xs0, dev)] * _idx(xa0, dev)[None, :, None]
            + s[:, _idx(xs1, dev)] * _idx(xa1, dev)[None, :, None])
    r0, r1 = hrow[_idx(ys0, dev)], hrow[_idx(ys1, dev)]
    b0 = _idx(ya0, dev)[:, None, None]
    b1 = _idx(ya1, dev)[:, None, None]
    v = ((((r0 >> 4) * b0) >> 16) + (((r1 >> 4) * b1) >> 16) + 2) >> 2
    return v.clamp_(0, 255).to(torch.uint8)


def _area_table(ssize, dsize):
    """cv2's computeResizeAreaTab for one axis, as (dsize, T) source
    indices and float32 weights (padded with weight 0)."""
    scale = 1.0 / (dsize / ssize)
    rows = []
    for d in range(dsize):
        fs1 = d * scale
        fs2 = fs1 + scale
        cell = min(scale, ssize - fs1)
        s2 = min(math.floor(fs2), ssize - 1)
        s1 = min(math.ceil(fs1), s2)
        row = []
        if s1 - fs1 > 1e-3:
            row.append((s1 - 1, (s1 - fs1) / cell))
        row += [(s, 1.0 / cell) for s in range(s1, s2)]
        if fs2 - s2 > 1e-3:
            row.append((s2, min(min(fs2 - s2, 1.0), cell) / cell))
        rows.append(row)
    t = max(len(r) for r in rows)
    idx = np.zeros((dsize, t), np.int64)
    wt = np.zeros((dsize, t), _F32)
    for d, row in enumerate(rows):
        for k, (s, a) in enumerate(row):
            idx[d, k], wt[d, k] = s, a
    return idx, wt


def _resize_area(x, dw, dh):
    h, w, c = x.shape
    dev = x.device
    kx, ky = w / dw, h / dh
    if kx == int(kx) and ky == int(ky):         # cv2's resizeAreaFast
        kx, ky = int(kx), int(ky)
        s = x[:dh * ky, :dw * kx].reshape(dh, ky, dw, kx, c).long().sum(
            (1, 3))
        if kx == ky == 2:
            return ((s + 2) >> 2).clamp_(0, 255).to(torch.uint8)
        return _to_u8(s.float() * float(_F32(1.0 / (kx * ky))))
    xi, xa = _area_table(w, dw)
    yi, ya = _area_table(h, dh)
    xf = x.float()
    buf = torch.zeros((h, dw, c), dtype=torch.float32, device=dev)
    for k in range(xi.shape[1]):
        buf = buf + xf[:, _idx(xi[:, k], dev)] * torch.as_tensor(
            xa[:, k], device=dev)[None, :, None]
    out = None
    for k in range(yi.shape[1]):
        term = buf[_idx(yi[:, k], dev)] * torch.as_tensor(
            ya[:, k], device=dev)[:, None, None]
        out = term if out is None else out + term
    return _to_u8(out)


def _cubic_table(ssize, dsize):
    f = (np.arange(dsize) + 0.5) * (ssize / dsize) - 0.5
    s = np.floor(f).astype(np.int64)
    t = f - s
    a = -0.75
    c0 = ((a * (t + 1) - 5 * a) * (t + 1) + 8 * a) * (t + 1) - 4 * a
    c1 = ((a + 2) * t - (a + 3)) * t * t + 1
    c2 = ((a + 2) * (1 - t) - (a + 3)) * (1 - t) * (1 - t) + 1
    c3 = 1 - c0 - c1 - c2
    idx = np.clip(s[:, None] + np.arange(-1, 3)[None], 0, ssize - 1)
    return idx, np.stack([c0, c1, c2, c3], -1)


def _resize_cubic(x, dw, dh):
    h, w, c = x.shape
    dev = x.device
    xi, xc = _cubic_table(w, dw)
    yi, yc = _cubic_table(h, dh)
    s = x.double()
    xc = torch.as_tensor(xc, device=dev)
    yc = torch.as_tensor(yc, device=dev)
    hrow = sum(s[:, _idx(xi[:, k], dev)] * xc[None, :, k, None]
               for k in range(4))
    v = sum(hrow[_idx(yi[:, k], dev)] * yc[:, k, None, None]
            for k in range(4))
    return _to_u8(v)


def resize(img, dsize, interpolation=INTER_LINEAR):
    """cv2.resize(img, dsize=(width, height), interpolation=...) of a uint8
    image for INTER_LINEAR, INTER_AREA (downscaling) and INTER_CUBIC."""
    x, squeeze = _hwc(img)
    if x.dtype != torch.uint8:
        raise TypeError(f'resize: uint8 images (its callers\' dtype), got '
                        f'{x.dtype}')
    dw, dh = int(dsize[0]), int(dsize[1])
    h, w = x.shape[:2]
    if dw <= 0 or dh <= 0:
        raise ValueError(f'resize: dsize {dsize}')
    if (dw, dh) == (w, h):
        return img.clone()
    if interpolation == INTER_LINEAR:
        if w == 2 * dw and h == 2 * dh:
            out = _resize_area(x, dw, dh)
        else:
            out = _resize_linear(x, dw, dh)
    elif interpolation == INTER_AREA:
        if dw > w or dh > h:
            raise NotImplementedError(
                'resize: INTER_AREA upscaling (cv2 emulates it with a '
                'linear variant) is not ported')
        out = _resize_area(x, dw, dh)
    elif interpolation == INTER_CUBIC:
        out = _resize_cubic(x, dw, dh)
    else:
        raise NotImplementedError(f'resize: interpolation {interpolation}')
    return _out(out, squeeze)


# ------------------------------------------------------------ warp_affine
def _invert_affine(m):
    """cv2's invertAffineTransform as warpAffine does it, in float64."""
    m = np.asarray(m, np.float64).reshape(6).copy()
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0], m[1], m[3], m[4] = a11, -m[1] * d, -m[3] * d, a22
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    return m


def warp_affine(img, M, dsize):
    """cv2.warpAffine(img, M, dsize=(width, height)): INTER_LINEAR, a
    constant 0 border, ``M`` the forward (2, 3) matrix (inverted as cv2
    inverts it)."""
    x, squeeze = _hwc(img)
    m = _invert_affine(M)
    mf = [float(_F32(v)) for v in m]
    dw, dh = int(dsize[0]), int(dsize[1])
    h, w, c = x.shape
    dev = x.device
    xs = torch.arange(dw, device=dev, dtype=torch.float32)[None, :]
    ys = torch.arange(dh, device=dev, dtype=torch.float32)[:, None]
    sx = _fma(mf[0], xs, ys * mf[1] + mf[2])
    sy = _fma(mf[3], xs, ys * mf[4] + mf[5])
    fx, fy = torch.floor(sx), torch.floor(sy)
    a = (sx - fx)[..., None]
    b = (sy - fy)[..., None]
    ix, iy = fx.long(), fy.long()
    flat = x.reshape(h * w, c).float()

    def tap(yy, xx):
        ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        v = flat[(yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).reshape(-1)]
        return v.reshape(dh, dw, c) * ok[..., None]

    p00, p01 = tap(iy, ix), tap(iy, ix + 1)
    p10, p11 = tap(iy + 1, ix), tap(iy + 1, ix + 1)
    v0 = _fma(a, p01 - p00, p00)
    v1 = _fma(a, p11 - p10, p10)
    v = _fma(b, v1 - v0, v0)
    return _out(_to_u8(v) if x.dtype == torch.uint8 else v, squeeze)


def get_rotation_matrix_2d(center, angle, scale):
    """cv2.getRotationMatrix2D: (2, 3) float64; the centre is a float32
    point, as cv2's Point2f."""
    cx, cy = float(_F32(center[0])), float(_F32(center[1]))
    ang = angle * math.pi / 180
    alpha = math.cos(ang) * scale
    beta = math.sin(ang) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


# ------------------------------------------------------------------ erode
def erode(img, kernel):
    """cv2.erode(img, kernel) with a (rows, cols) array of ones: the minimum
    over the kernel's rectangle, anchor at (cols // 2, rows // 2), the
    image's border never the minimum. An empty kernel is cv2's 3 x 3."""
    k = np.asarray(kernel)
    if k.size and not np.all(k != 0):
        raise NotImplementedError('erode: only rectangles of ones')
    kh, kw = k.shape if k.size else (3, 3)
    x, squeeze = _hwc(img)
    if kh == kw == 1:
        return img.clone()
    ax, ay = kw // 2, kh // 2
    y = -x.float().permute(2, 0, 1)[None]
    y = F.pad(y, (ax, kw - 1 - ax, ay, kh - 1 - ay), value=-math.inf)
    out = (-F.max_pool2d(y, (kh, kw), stride=1))[0].permute(1, 2, 0)
    out = out.to(x.dtype) if x.dtype == torch.uint8 else out.contiguous()
    return _out(out, squeeze)


# --------------------------------------------------------------- gaussian
_SMALL_GAUSSIAN = {
    1: [1.0],
    3: [0.25, 0.5, 0.25],
    5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
    7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125],
    9: [4 / 256, 13 / 256, 30 / 256, 51 / 256, 60 / 256, 51 / 256,
        30 / 256, 13 / 256, 4 / 256],
}


def get_gaussian_kernel(ksize, sigma):
    """cv2.getGaussianKernel(ksize, sigma): (ksize, 1) float64, sum 1. For
    sigma <= 0, cv2's tables up to 9 taps, else sigma = 0.3 * ((ksize - 1)
    * 0.5 - 1) + 0.8. (cv2 takes exp in software float64; libm's may
    differ by 1 ulp.)"""
    n = int(ksize)
    if sigma <= 0 and n in _SMALL_GAUSSIAN:
        return np.array(_SMALL_GAUSSIAN[n], np.float64)[:, None]
    sx = sigma if sigma > 0 else n * 0.15 + 0.35
    scale2x = -0.125 / (sx * sx)
    n2 = (n - 1) // 2
    vals = [math.exp(float((1 - n + 2 * i) ** 2) * scale2x)
            for i in range(n2)]
    total = 2 * sum(vals) + 1.0 + (1.0 if n % 2 == 0 else 0.0)
    mul = 1.0 / total
    out = np.zeros(n, np.float64)
    for i, v in enumerate(vals):
        out[i] = out[n - 1 - i] = v * mul
    out[n2] = mul
    if n % 2 == 0:
        out[n2 + 1] = mul
    return out[:, None]


def _gaussian_fixed(kernel):
    """cv2's 8-bit fraction kernel: error diffusion from the ends, the
    centre takes what makes the sum 256."""
    k = kernel.ravel()
    n = len(k)
    out = np.zeros(n, np.int64)
    err, total = 0.0, 0
    for i in range(n // 2):
        adj = k[i] * 256.0 + err
        v = int(np.rint(adj))
        err = adj - v
        out[i] = out[n - 1 - i] = v
        total += v
    out[n // 2] = 256 - 2 * total
    return out


def _taps(x, axis, n, k):
    """Views of ``x`` padded by BORDER_REFLECT_101 for the k taps of a
    centred kernel along ``axis`` (0 rows, 1 columns)."""
    r = k // 2
    idx = _idx(_reflect101(n, -r, n + r), x.device)
    p = x[idx] if axis == 0 else x[:, idx]
    return [(p[j:j + n] if axis == 0 else p[:, j:j + n]) for j in range(k)]


def gaussian_blur(img, ksize, sigma_x, sigma_y=0):
    """cv2.GaussianBlur(img, ksize=(kw, kh), sigmaX, sigmaY) with
    BORDER_REFLECT_101."""
    x, squeeze = _hwc(img)
    kw, kh = int(ksize[0]), int(ksize[1])
    if sigma_y <= 0:
        sigma_y = sigma_x
    if kw <= 0 or kh <= 0 or kw % 2 == 0 or kh % 2 == 0:
        raise ValueError(f'gaussian_blur: ksize {ksize} must be odd and '
                         f'positive')
    if kw == kh == 1:
        return img.clone()
    sigma_x, sigma_y = max(sigma_x, 0.0), max(sigma_y, 0.0)
    gx = get_gaussian_kernel(kw, sigma_x)
    gy = get_gaussian_kernel(kh, sigma_y)
    h, w = x.shape[:2]
    if x.dtype == torch.uint8:
        fx, fy = _gaussian_fixed(gx), _gaussian_fixed(gy)
        s = x.long()
        hrow = sum(t * int(fx[j]) for j, t in enumerate(_taps(s, 1, w, kw)))
        v = sum(t * int(fy[j]) for j, t in enumerate(_taps(hrow, 0, h, kh)))
        out = ((v + (1 << 15)) >> 16).clamp_(0, 255).to(torch.uint8)
        return _out(out, squeeze)
    fx = gx.ravel().astype(_F32)
    fy = gy.ravel().astype(_F32)
    acc = None
    for j, t in enumerate(_taps(x, 1, w, kw)):
        acc = t * float(fx[j]) if acc is None else _fma(t, float(fx[j]), acc)
    taps = _taps(acc, 0, h, kh)
    r = kh // 2
    out = taps[r] * float(fy[r])
    for j in range(1, r + 1):
        out = _fma(taps[r + j] + taps[r - j], float(fy[r + j]), out)
    return _out(out, squeeze)


# ---------------------------------------------------------------- filter2d
def filter2d(img, ddepth, kernel):
    """cv2.filter2D(img, -1, kernel): correlation with a float kernel,
    anchor (cols // 2, rows // 2), BORDER_REFLECT_101, delta 0."""
    if ddepth != -1:
        raise NotImplementedError(f'filter2d: ddepth {ddepth}')
    x, squeeze = _hwc(img)
    k = kernel.detach().float().cpu().numpy() if torch.is_tensor(kernel) \
        else np.asarray(kernel, _F32)
    k = k.astype(_F32)
    kh, kw = k.shape
    ay, ax = kh // 2, kw // 2
    h, w = x.shape[:2]
    dev = x.device
    yi = _idx(_reflect101(h, -ay, h + kh - 1 - ay), dev)
    xi = _idx(_reflect101(w, -ax, w + kw - 1 - ax), dev)
    p = x.float()[yi][:, xi]
    acc = None
    for i in range(kh):
        for j in range(kw):
            if k[i, j] == 0:
                continue
            t = p[i:i + h, j:j + w]
            acc = (t * float(k[i, j]) if acc is None
                   else _fma(t, float(k[i, j]), acc))
    if acc is None:
        acc = torch.zeros(x.shape, dtype=torch.float32, device=dev)
    return _out(_to_u8(acc) if x.dtype == torch.uint8 else acc, squeeze)


# --------------------------------------------------------------- cvtColor
def cvt_color(img, code):
    """cv2.cvtColor for COLOR_BGR2RGB / COLOR_RGB2BGR (4, any dtype) and
    COLOR_BGR2GRAY (6) of a float32 image."""
    x, _ = _hwc(img)
    if code == COLOR_BGR2RGB:
        return x.flip(-1).contiguous()
    if code != COLOR_BGR2GRAY or x.dtype != torch.float32 or x.shape[-1] != 3:
        raise NotImplementedError(f'cvt_color: code {code} of '
                                  f'{tuple(x.shape)} {x.dtype}')
    b, g, r = x.unbind(-1)
    return _fma(r, float(_F32(0.299)),
                _fma(g, float(_F32(0.587)), b * float(_F32(0.114))))
