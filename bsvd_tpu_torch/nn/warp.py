"""Flow warping and resizing on NCHW tensors (counterpart of
bsvd_tpu/nn/warp.py, itself BasicSR's arch_util flow_warp /
resize_flow): ``grid_sample`` at absolute pixel coordinates, ``flow_warp``
by a flow in pixels, ``interpolate_bilinear`` and ``resize_flow``.

The JAX package samples with gathers in XLA; the port takes
``F.grid_sample`` (bilinear, with ``align_corners=True``: coordinate 0 is
the first pixel's centre, W - 1 the last's, as in the JAX package) and
``F.interpolate``. The coordinates are normalised to [-1, 1] and
unnormalised again inside ``F.grid_sample``, which moves them by a few
ulps: a bilinear sample is continuous in its coordinate, so the result
moves by as little. Nearest sampling is not continuous (a point at x.5
may round either way after the round trip), so it gathers at
``torch.round`` of the coordinates itself, half to even as ``jnp.round``
does. An axis of one pixel has no [-1, 1] scale: with 'zeros' padding it
gains a row or column of zeros first (which is what the JAX package's
per-corner zero mask gives), otherwise every point reads its one pixel.
"""

import torch
import torch.nn.functional as F

PADDING_MODES = ('zeros', 'border', 'reflection')


def _reflect(v, vmax):
    """torch's 'reflection' with align_corners=True: reflect about 0 and
    vmax (the JAX package's rule)."""
    period = 2 * vmax if vmax > 0 else 1
    v = torch.remainder(torch.abs(v), period)
    return torch.where(v > vmax, period - v, v)


def _nearest(img, coords, padding_mode):
    h, w = img.shape[-2:]
    x, y = coords[..., 0], coords[..., 1]
    if padding_mode == 'reflection':
        x, y = _reflect(x, w - 1), _reflect(y, h - 1)
    ix = torch.round(x).long()
    iy = torch.round(y).long()
    valid = (ix >= 0) & (ix <= w - 1) & (iy >= 0) & (iy <= h - 1)
    flat = (iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)).flatten(1)
    n, c = img.shape[:2]
    out = torch.gather(img.reshape(n, c, h * w), 2,
                       flat[:, None].expand(n, c, flat.shape[1]))
    out = out.reshape(n, c, *coords.shape[1:3])
    if padding_mode == 'zeros':
        out = out * valid[:, None].to(img.dtype)
    return out


def grid_sample(img, coords, interp_mode='bilinear', padding_mode='zeros'):
    """Sample ``img`` (N, C, H, W) at absolute pixel coordinates ``coords``
    (N, Ho, Wo, 2), (x, y) -> (N, C, Ho, Wo); ``padding_mode`` 'zeros',
    'border' or 'reflection', ``interp_mode`` 'bilinear' or 'nearest'."""
    if padding_mode not in PADDING_MODES:
        raise ValueError(f'padding_mode {padding_mode!r}: {PADDING_MODES}')
    if interp_mode == 'nearest':
        return _nearest(img, coords, padding_mode)
    if interp_mode != 'bilinear':
        raise ValueError(f'interp_mode {interp_mode!r}: bilinear or nearest')
    coords = coords.to(img.dtype)
    if padding_mode == 'zeros' and 1 in img.shape[-2:]:
        img = F.pad(img, (0, int(img.shape[-1] == 1),
                          0, int(img.shape[-2] == 1)))
    h, w = img.shape[-2:]
    scale = coords.new_tensor([2.0 / (w - 1) if w > 1 else 0.0,
                               2.0 / (h - 1) if h > 1 else 0.0])
    return F.grid_sample(img, coords * scale - 1.0, mode='bilinear',
                         padding_mode=padding_mode, align_corners=True)


def flow_warp(x, flow, interp_mode='bilinear', padding_mode='zeros'):
    """Warp ``x`` (N, C, H, W) by ``flow`` (N, H, W, 2), (dx, dy) in
    pixels: output pixel (i, j) samples x at (j + dx, i + dy)."""
    h, w = x.shape[-2:]
    gy, gx = torch.meshgrid(
        torch.arange(h, dtype=x.dtype, device=x.device),
        torch.arange(w, dtype=x.dtype, device=x.device), indexing='ij')
    coords = torch.stack([gx, gy], dim=-1)[None] + flow.to(x.dtype)
    return grid_sample(x, coords, interp_mode, padding_mode)


def interpolate_bilinear(x, out_h, out_w, align_corners=False):
    """``F.interpolate(mode='bilinear')`` of (N, C, H, W) to (out_h,
    out_w), either corner mode (the JAX package's bilinear resize)."""
    return F.interpolate(x, size=(int(out_h), int(out_w)), mode='bilinear',
                         align_corners=align_corners)


def resize_flow(flow, size_type, sizes, interp_mode='bilinear',
                align_corners=False):
    """Resize a (N, 2, H, W) flow (BasicSR's layout) by ``sizes`` as a
    'ratio' or to a 'shape', its (dx, dy) scaled by the width and height
    ratios; bilinear whatever ``interp_mode`` says, as in the JAX
    package."""
    h, w = flow.shape[-2:]
    if size_type == 'ratio':
        out_h, out_w = int(h * sizes[0]), int(w * sizes[1])
    elif size_type == 'shape':
        out_h, out_w = sizes[0], sizes[1]
    else:
        raise ValueError(f'Size type should be ratio or shape, but got '
                         f'{size_type}.')
    del interp_mode
    ratio = flow.new_tensor([out_w / w, out_h / h]).view(1, 2, 1, 1)
    return interpolate_bilinear(flow * ratio, out_h, out_w, align_corners)
