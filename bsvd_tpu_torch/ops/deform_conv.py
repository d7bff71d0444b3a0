"""Modulated deformable convolution (DCNv2) in plain PyTorch, NCHW
(counterpart of bsvd_tpu/ops/deform_conv.py, which replaces BasicSR's
DCNv2 CUDA extension by XLA; it has no Pallas kernel, so neither has the
port).

Deformable conv is bilinear-sampled im2col plus one product: for each
kernel tap k and deformable group g, the group's channels are sampled at
``p + p_k + offset_k(p)`` (bilinear, zero padding), scaled by the
modulation mask, and contracted with the weights. The channel layouts are
the CUDA kernel's (and the JAX package's), so converted checkpoints
behave the same:

- offset (N, dg*2*kh*kw, H', W'): per group, (dy_k, dx_k) interleaved
  over the taps in row-major (kh, kw) order;
- mask (N, dg*kh*kw, H', W'), already sigmoided (None: DCNv1).

All taps and groups are sampled at once (taps and output pixels folded
into one axis, groups into the batch axis, as in the JAX package) by an
explicit four-corner gather at the pixel coordinates, the JAX package's
rule: corners at ``floor`` and ``floor + 1``, each outside the image
reading zero. Not ``F.grid_sample``: its [-1, 1] round trip moves an
integer coordinate (every sample of a zero offset, as a fresh pack has)
by an ulp to either side of the pixel, so the offset's gradient there
would take the left or the right slope at random, where the JAX package
and BasicSR's kernel take the right one.
"""

import torch
import torch.nn.functional as F
from torch import nn


def _bilinear_zeros(img, h, w, cy, cx, weight):
    """``img`` (B, H*W, C), an H x W image's pixels as rows, sampled at
    pixel coordinates ``cy`` / ``cx`` (B, P), each sample times ``weight``
    (B, P) -> (B, P, C); a corner outside the image reads zero. The four
    corners are one gather (its backward one scatter-add)."""
    b, p = cy.shape
    y0, x0 = torch.floor(cy), torch.floor(cx)
    wy1, wx1 = cy - y0, cx - x0
    ys = torch.stack([y0, y0, y0 + 1, y0 + 1], 1)              # (B, 4, P)
    xs = torch.stack([x0, x0 + 1, x0, x0 + 1], 1)
    wys = torch.stack([1 - wy1, 1 - wy1, wy1, wy1], 1)
    wxs = torch.stack([1 - wx1, wx1, 1 - wx1, wx1], 1)
    valid = (ys >= 0) & (ys <= h - 1) & (xs >= 0) & (xs <= w - 1)
    idx = (ys.clamp(0, h - 1) * w + xs.clamp(0, w - 1)).long().view(b, -1)
    vals = torch.gather(img, 1, idx[..., None].expand(-1, -1, img.shape[-1]))
    wts = wys * wxs * valid * weight[:, None]
    return (vals.view(b, 4, p, -1) * wts[..., None]).sum(1)


def modulated_deform_conv(x, offset, mask, weight, bias=None, stride=1,
                          padding=1, dilation=1, deformable_groups=1):
    """DCNv2 of ``x`` (N, C, H, W) by ``weight`` (Cout, C, kh, kw) ->
    (N, Cout, H', W'), H' x W' the offset's."""
    n, c, h, w = x.shape
    cout, _, kh, kw = weight.shape
    dg = deformable_groups
    k = kh * kw
    ho, wo = offset.shape[-2:]
    cg = c // dg
    dt = x.dtype
    # (N, dg, K, 2, Ho, Wo) -> (N, dg, Ho, Wo, K, 2), (dy, dx) last
    off = offset.to(dt).view(n, dg, k, 2, ho, wo).permute(0, 1, 4, 5, 2, 3)
    gy = torch.arange(ho, dtype=dt, device=x.device) * stride - padding
    gx = torch.arange(wo, dtype=dt, device=x.device) * stride - padding
    taps = torch.arange(k, device=x.device)
    tap_y = (taps // kw).to(dt) * dilation
    tap_x = (taps % kw).to(dt) * dilation
    cy = gy.view(ho, 1, 1) + tap_y + off[..., 0]          # (N, dg, Ho, Wo, K)
    cx = gx.view(1, wo, 1) + tap_x + off[..., 1]
    if mask is None:
        scale = torch.ones_like(cy)
    else:
        scale = mask.to(dt).view(n, dg, k, ho, wo).permute(0, 1, 3, 4, 2)
    img = x.reshape(n, dg, cg, h * w).transpose(2, 3).reshape(
        n * dg, h * w, cg)
    sampled = _bilinear_zeros(img, h, w, cy.reshape(n * dg, -1),
                              cx.reshape(n * dg, -1),
                              scale.reshape(n * dg, -1))
    # channels [g0 .., g1 ..] as the weight's input channels
    y = torch.einsum('nghwkc,ogck->nohw',
                     sampled.view(n, dg, ho, wo, k, cg),
                     weight.to(dt).view(cout, dg, cg, k))
    if bias is not None:
        y = y + bias.to(dt).view(1, -1, 1, 1)
    return y


def dcn_v2_pack_apply(x, feat, weight, bias, offset_weight, offset_bias,
                      deformable_groups=1, stride=1, padding=1, dilation=1):
    """DCNv2Pack (BasicSR arch_util): the offsets and masks predicted from
    another feature map ``feat`` by the ``conv_offset`` conv, the mask
    sigmoided, then ``modulated_deform_conv`` of ``x``."""
    out = F.conv2d(feat, offset_weight, offset_bias, stride, padding)
    o1, o2, mask = torch.chunk(out, 3, dim=1)
    return modulated_deform_conv(x, torch.cat([o1, o2], 1),
                                 torch.sigmoid(mask), weight, bias, stride,
                                 padding, dilation, deformable_groups)


class DCNv2Pack(nn.Module):
    """BasicSR's DCNv2Pack: ``weight`` / ``bias`` of the deformable conv
    and ``conv_offset`` (3 x dg x kh x kw outputs), called as
    ``(x, feat)``. ``conv_offset`` starts at zero, as BasicSR's
    ``init_weights`` (and the JAX init) set it: a fresh pack is a plain
    conv."""

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1,
                 padding=1, dilation=1, deformable_groups=1):
        super().__init__()
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.deformable_groups = deformable_groups
        k = kernel_size
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               k, k))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.conv_offset = nn.Conv2d(in_channels,
                                     deformable_groups * 3 * k * k, k,
                                     stride, padding)
        nn.init.zeros_(self.conv_offset.weight)
        nn.init.zeros_(self.conv_offset.bias)

    def forward(self, x, feat):
        return dcn_v2_pack_apply(x, feat, self.weight, self.bias,
                                 self.conv_offset.weight,
                                 self.conv_offset.bias,
                                 self.deformable_groups, self.stride,
                                 self.padding, self.dilation)
