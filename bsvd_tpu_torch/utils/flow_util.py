"""Optical-flow files and pictures (counterpart of bsvd_tpu/utils/
flow_util.py, BasicSR's flow_util): ``.flo`` files, flows quantised into
8-bit images (dx over dy, or side by side), and the colour-wheel picture
of a flow. numpy only; the quantised images go through the port's own
readers and writers (``img_util.imfrombytes(..., 'unchanged')`` and
``img_util.imwrite``: PNG or JPEG by the name), where the JAX package
calls cv2."""

import os

import numpy as np

from bsvd_tpu_torch.utils import img_util


def flowread(flow_path, quantize=False, concat_axis=0, *args, **kwargs):
    """A ``.flo`` file, or with ``quantize`` a quantised dx / dy image
    (split along ``concat_axis``; ``dequantize_flow``'s arguments follow)
    -> (H, W, 2) float32."""
    if quantize:
        assert concat_axis in (0, 1)
        with open(flow_path, 'rb') as f:
            cat_flow = img_util.imfrombytes(f.read(), 'unchanged')
        if cat_flow.ndim != 2:
            raise IOError(f'{flow_path} is not a valid quantized flow image')
        assert cat_flow.shape[concat_axis] % 2 == 0
        dx, dy = np.split(cat_flow, 2, axis=concat_axis)
        return dequantize_flow(dx, dy, *args, **kwargs)
    with open(str(flow_path), 'rb') as f:
        header = f.read(4).decode('utf-8')
        if header != 'PIEH':
            raise IOError(f'Invalid flow file: {flow_path}, header does not '
                          'contain PIEH')
        w = np.fromfile(f, np.int32, 1).squeeze()
        h = np.fromfile(f, np.int32, 1).squeeze()
        flow = np.fromfile(f, np.float32, int(w) * int(h) * 2)
        return flow.reshape((int(h), int(w), 2))


def flowwrite(flow, filename, quantize=False, concat_axis=0, *args,
              **kwargs):
    """Write an (H, W, 2) flow as ``.flo``, or with ``quantize`` as a
    uint8 image of dx and dy joined along ``concat_axis``
    (``quantize_flow``'s arguments follow)."""
    if not quantize:
        os.makedirs(os.path.dirname(os.path.abspath(filename)),
                    exist_ok=True)
        with open(filename, 'wb') as f:
            f.write('PIEH'.encode('utf-8'))
            np.array([flow.shape[1], flow.shape[0]], dtype=np.int32).tofile(f)
            flow.astype(np.float32).tofile(f)
    else:
        assert concat_axis in (0, 1)
        dx, dy = quantize_flow(flow, *args, **kwargs)
        img_util.imwrite(np.concatenate((dx, dy), axis=concat_axis),
                         filename)


def quantize_flow(flow, max_val=0.02, norm=True):
    """(dx, dy) uint8 in [0, 255] of an (H, W, 2) flow clipped to
    +-``max_val`` (divided by the width and height first with
    ``norm``)."""
    h, w, _ = flow.shape
    dx = flow[..., 0]
    dy = flow[..., 1]
    if norm:
        dx = dx / w
        dy = dy / h
    return tuple(_quantize(d, -max_val, max_val, 255, np.uint8)
                 for d in (dx, dy))


def dequantize_flow(dx, dy, max_val=0.02, denorm=True):
    """The (H, W, 2) flow of quantised dx and dy (times the width and
    height with ``denorm``)."""
    assert dx.shape == dy.shape
    dx = _dequantize(dx, -max_val, max_val, 255)
    dy = _dequantize(dy, -max_val, max_val, 255)
    if denorm:
        dx *= dx.shape[1]
        dy *= dx.shape[0]
    return np.dstack((dx, dy))


def _check_levels(min_val, max_val, levels):
    if not (isinstance(levels, int) and levels > 1):
        raise ValueError(f'levels must be a positive integer, but got '
                         f'{levels}')
    if min_val >= max_val:
        raise ValueError(f'min_val ({min_val}) must be smaller than max_val '
                         f'({max_val})')


def _quantize(arr, min_val, max_val, levels, dtype=np.int64):
    _check_levels(min_val, max_val, levels)
    arr = np.clip(arr, min_val, max_val) - min_val
    return np.minimum(np.floor(levels * arr / (max_val - min_val)).astype(
        dtype), levels - 1)


def _dequantize(arr, min_val, max_val, levels):
    _check_levels(min_val, max_val, levels)
    return (arr + 0.5) * (max_val - min_val) / levels + min_val


def _make_color_wheel():
    """The Middlebury colour wheel: (55, 3) RGB in [0, 1]."""
    segments = ((15, 0, 1, True), (6, 1, 0, False), (4, 1, 2, True),
                (11, 2, 1, False), (13, 2, 0, True), (6, 0, 2, False))
    rows = []
    for n, full, ramp, rising in segments:
        seg = np.zeros((n, 3))
        seg[:, full] = 255
        step = np.floor(255 * np.arange(n) / n)
        seg[:, ramp] = step if rising else 255 - step
        rows.append(seg)
    return np.concatenate(rows) / 255.


def flow2rgb(flow, max_flow=None):
    """(H, W, 2) flow -> (H, W, 3) float32 RGB on the colour wheel: hue
    the direction, saturation the magnitude over ``max_flow`` (the
    largest by default); beyond it, the colour darkened to 3/4."""
    u, v = flow[..., 0], flow[..., 1]
    mag = np.sqrt(u**2 + v**2)
    if max_flow is None:
        max_flow = max(np.max(mag), 1e-8)
    u, v = u / max_flow, v / max_flow
    mag = np.sqrt(u**2 + v**2)
    ang = np.arctan2(-v, -u) / np.pi
    wheel = _make_color_wheel()
    ncols = wheel.shape[0]
    fk = (ang + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(int)
    k1 = (k0 + 1) % ncols
    f = (fk - k0)[..., None]
    col = (1 - f) * wheel[k0] + f * wheel[k1]
    small = (mag <= 1)[..., None]
    col = np.where(small, 1 - mag[..., None] * (1 - col), col * 0.75)
    return col.astype(np.float32)
