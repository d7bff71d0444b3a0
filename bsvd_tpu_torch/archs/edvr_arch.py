"""EDVR, video restoration with PCD (pyramid, cascading, deformable)
alignment and TSA (temporal and spatial attention) fusion, as
``nn.Module``s (counterpart of bsvd_tpu/archs/edvr_arch.py, BasicSR's
edvr_arch). BasicSR's names (``pcd_align.offset_conv1.l3``,
``pcd_align.dcn_pack.l1.conv_offset``, ``fusion.spatial_attn_l2``,
``predeblur.resblock_l1.0.conv1``, ``feature_extraction.0.conv1``, ...),
so a BasicSR ``.pth`` loads with ``load_state_dict`` and a JAX tree
through ``convert.torch_generic.from_jax_tree``.

Plain PyTorch on NCHW tensors, the deformable convolutions those of
``ops/deform_conv`` (the JAX package computes all of it in XLA, outside
any Pallas kernel). The pyramid's x2 upsamples are bilinear without
corner alignment; TSA's pools are 3 x 3 stride 2 with -inf padding (max)
and a divisor of 9 (average, ``count_include_pad``), as torch's; the
average pool's input is made contiguous first (see ``_avg_pool_3s2``).

Initialisation follows the JAX package's families on a seeded
``torch.Generator``: kaiming-normal convs with uniform biases, the
residual blocks' scaled by 0.1 with zero biases, every DCN pack's
``conv_offset`` zero (so a fresh pack is a plain conv).
"""

import torch
import torch.nn.functional as F
from torch import nn

from bsvd_tpu_torch.archs.sr_archs import (ResidualBlockNoBN, _conv, _Init,
                                           bilinear_resize, lrelu)
from bsvd_tpu_torch.ops.deform_conv import DCNv2Pack
from bsvd_tpu_torch.utils.registry import ARCH_REGISTRY


def _up2(x):
    return F.interpolate(x, scale_factor=2, mode='bilinear',
                         align_corners=False)


def _max_pool_3s2(x):
    return F.max_pool2d(x, 3, 2, 1)


def _avg_pool_3s2(x):
    # contiguous first: on the card (PyTorch 2.11, CUDA 12.8) the backward
    # of F.avg_pool2d(3, 2, 1) of a channels-last tensor is wrong (90% of
    # max|ref| off; its forward is right), and TSA's pools meet one
    return F.avg_pool2d(x.contiguous(), 3, 2, 1)


def _blocks(num_feat, n):
    return nn.Sequential(*[ResidualBlockNoBN(num_feat) for _ in range(n)])


def init_families(module, seed):
    """The JAX package's init families on ``module``: kaiming convs, 0.1
    residual blocks, DCN packs kaiming with a zero ``conv_offset``."""
    init = _Init(seed)
    init.all_kaiming(module)
    for m in module.modules():
        if isinstance(m, ResidualBlockNoBN):
            init.all_kaiming(m, 0.1, zero_bias=True)
        elif isinstance(m, DCNv2Pack):
            init.kaiming(m)
            nn.init.zeros_(m.conv_offset.weight)
            nn.init.zeros_(m.conv_offset.bias)


class PCDAlignment(nn.Module):
    """Aligns a neighbour's three-level feature pyramid to the
    reference's; levels l3 (coarsest) .. l1, then a cascading pack."""

    def __init__(self, num_feat=64, deformable_groups=8):
        super().__init__()
        self.deformable_groups = deformable_groups
        self.offset_conv1 = nn.ModuleDict()
        self.offset_conv2 = nn.ModuleDict()
        self.offset_conv3 = nn.ModuleDict()
        self.dcn_pack = nn.ModuleDict()
        self.feat_conv = nn.ModuleDict()
        for i in range(3, 0, -1):
            lv = f'l{i}'
            self.offset_conv1[lv] = _conv(num_feat * 2, num_feat)
            if i == 3:
                self.offset_conv2[lv] = _conv(num_feat, num_feat)
            else:
                self.offset_conv2[lv] = _conv(num_feat * 2, num_feat)
                self.offset_conv3[lv] = _conv(num_feat, num_feat)
            self.dcn_pack[lv] = DCNv2Pack(
                num_feat, num_feat, deformable_groups=deformable_groups)
            if i < 3:
                self.feat_conv[lv] = _conv(num_feat * 2, num_feat)
        self.cas_offset_conv1 = _conv(num_feat * 2, num_feat)
        self.cas_offset_conv2 = _conv(num_feat, num_feat)
        self.cas_dcnpack = DCNv2Pack(num_feat, num_feat,
                                     deformable_groups=deformable_groups)

    def forward(self, nbr_feat_l, ref_feat_l):
        """Lists of (N, C, H / 2^l, W / 2^l), index 0 the full size."""
        upsampled_offset = upsampled_feat = feat = None
        for i in range(3, 0, -1):
            lv = f'l{i}'
            offset = torch.cat([nbr_feat_l[i - 1], ref_feat_l[i - 1]], 1)
            offset = lrelu(self.offset_conv1[lv](offset))
            if i == 3:
                offset = lrelu(self.offset_conv2[lv](offset))
            else:
                offset = lrelu(self.offset_conv2[lv](
                    torch.cat([offset, upsampled_offset], 1)))
                offset = lrelu(self.offset_conv3[lv](offset))
            feat = self.dcn_pack[lv](nbr_feat_l[i - 1], offset)
            if i < 3:
                feat = self.feat_conv[lv](torch.cat([feat, upsampled_feat],
                                                    1))
            if i > 1:
                feat = lrelu(feat)
                upsampled_offset = _up2(offset) * 2
                upsampled_feat = _up2(feat)
        offset = torch.cat([feat, ref_feat_l[0]], 1)
        offset = lrelu(self.cas_offset_conv2(lrelu(
            self.cas_offset_conv1(offset))))
        return lrelu(self.cas_dcnpack(feat, offset))


class TSAFusion(nn.Module):
    """Temporal attention (each frame's correlation with the centre's),
    then spatial attention on a two-level pyramid."""

    def __init__(self, num_feat=64, num_frame=5, center_frame_idx=2):
        super().__init__()
        self.center_frame_idx = center_frame_idx
        self.temporal_attn1 = _conv(num_feat, num_feat)
        self.temporal_attn2 = _conv(num_feat, num_feat)
        self.feat_fusion = _conv(num_frame * num_feat, num_feat, 1)
        self.spatial_attn1 = _conv(num_frame * num_feat, num_feat, 1)
        self.spatial_attn2 = _conv(num_feat * 2, num_feat, 1)
        self.spatial_attn3 = _conv(num_feat, num_feat)
        self.spatial_attn4 = _conv(num_feat, num_feat, 1)
        self.spatial_attn5 = _conv(num_feat, num_feat)
        self.spatial_attn_l1 = _conv(num_feat, num_feat, 1)
        self.spatial_attn_l2 = _conv(num_feat * 2, num_feat)
        self.spatial_attn_l3 = _conv(num_feat, num_feat)
        self.spatial_attn_add1 = _conv(num_feat, num_feat, 1)
        self.spatial_attn_add2 = _conv(num_feat, num_feat, 1)

    def forward(self, aligned_feat):
        """(N, T, C, H, W) -> (N, C, H, W)."""
        n, t, c, h, w = aligned_feat.shape
        emb_ref = self.temporal_attn1(aligned_feat[:, self.center_frame_idx])
        emb = self.temporal_attn2(aligned_feat.reshape(-1, c, h, w))
        emb = emb.view(n, t, -1, h, w)
        corr = torch.sum(emb * emb_ref[:, None], 2)            # (N, T, H, W)
        corr_prob = torch.sigmoid(corr)[:, :, None]
        # frame-major channels
        flat = (aligned_feat * corr_prob).reshape(n, t * c, h, w)
        feat = lrelu(self.feat_fusion(flat))

        attn = lrelu(self.spatial_attn1(flat))
        attn = lrelu(self.spatial_attn2(torch.cat(
            [_max_pool_3s2(attn), _avg_pool_3s2(attn)], 1)))
        attn_level = lrelu(self.spatial_attn_l1(attn))
        attn_level = lrelu(self.spatial_attn_l2(torch.cat(
            [_max_pool_3s2(attn_level), _avg_pool_3s2(attn_level)], 1)))
        attn_level = _up2(lrelu(self.spatial_attn_l3(attn_level)))
        attn = lrelu(self.spatial_attn3(attn)) + attn_level
        attn = _up2(lrelu(self.spatial_attn4(attn)))
        attn = self.spatial_attn5(attn)
        attn_add = self.spatial_attn_add2(lrelu(self.spatial_attn_add1(attn)))
        return feat * torch.sigmoid(attn) * 2 + attn_add


class PredeblurModule(nn.Module):
    """The pre-deblur feature pyramid; with ``hr_in`` two stride-2 convs
    first bring a high-resolution input down x4."""

    def __init__(self, num_in_ch=3, num_feat=64, hr_in=False):
        super().__init__()
        self.hr_in = hr_in
        self.conv_first = _conv(num_in_ch, num_feat)
        if hr_in:
            self.stride_conv_hr1 = nn.Conv2d(num_feat, num_feat, 3, 2, 1)
            self.stride_conv_hr2 = nn.Conv2d(num_feat, num_feat, 3, 2, 1)
        self.stride_conv_l2 = nn.Conv2d(num_feat, num_feat, 3, 2, 1)
        self.stride_conv_l3 = nn.Conv2d(num_feat, num_feat, 3, 2, 1)
        self.resblock_l3 = ResidualBlockNoBN(num_feat)
        self.resblock_l2_1 = ResidualBlockNoBN(num_feat)
        self.resblock_l2_2 = ResidualBlockNoBN(num_feat)
        self.resblock_l1 = nn.ModuleList(ResidualBlockNoBN(num_feat)
                                         for _ in range(5))

    def forward(self, x):
        feat_l1 = lrelu(self.conv_first(x))
        if self.hr_in:
            feat_l1 = lrelu(self.stride_conv_hr1(feat_l1))
            feat_l1 = lrelu(self.stride_conv_hr2(feat_l1))
        feat_l2 = lrelu(self.stride_conv_l2(feat_l1))
        feat_l3 = lrelu(self.stride_conv_l3(feat_l2))
        feat_l3 = _up2(self.resblock_l3(feat_l3))
        feat_l2 = self.resblock_l2_1(feat_l2) + feat_l3
        feat_l2 = _up2(self.resblock_l2_2(feat_l2))
        for i in range(2):
            feat_l1 = self.resblock_l1[i](feat_l1)
        feat_l1 = feat_l1 + feat_l2
        for i in range(2, 5):
            feat_l1 = self.resblock_l1[i](feat_l1)
        return feat_l1


def feature_pyramid(net, feat_l1, n, t):
    """``net``'s l2 / l3 stride-2 convs on the (N*T, C, H, W) level-1
    features -> three (N, T, C, h, w) levels."""
    feat_l2 = lrelu(net.conv_l2_2(lrelu(net.conv_l2_1(feat_l1))))
    feat_l3 = lrelu(net.conv_l3_2(lrelu(net.conv_l3_1(feat_l2))))
    return [f.view(n, t, *f.shape[1:]) for f in (feat_l1, feat_l2, feat_l3)]


def align_all(pcd_align, levels, center):
    """Every frame's pyramid aligned to the centre frame's ->
    (N, T, C, H, W)."""
    ref = [f[:, center] for f in levels]
    return torch.stack([pcd_align([f[:, i] for f in levels], ref)
                        for i in range(levels[0].shape[1])], 1)


def _stride_convs(num_feat):
    return {'conv_l2_1': nn.Conv2d(num_feat, num_feat, 3, 2, 1),
            'conv_l2_2': _conv(num_feat, num_feat),
            'conv_l3_1': nn.Conv2d(num_feat, num_feat, 3, 2, 1),
            'conv_l3_2': _conv(num_feat, num_feat)}


@ARCH_REGISTRY.register()
class EDVR(nn.Module):
    """(N, T, C, H, W) frames -> (N, C_out, 4H, 4W), the centre frame
    restored (with ``hr_in``, (N, C_out, H, W): the input is high
    resolution and comes down x4 in the pre-deblur module)."""

    def __init__(self, num_in_ch=3, num_out_ch=3, num_feat=64, num_frame=5,
                 deformable_groups=8, num_extract_block=5,
                 num_reconstruct_block=10, center_frame_idx=None,
                 hr_in=False, with_predeblur=False, with_tsa=True, seed=0):
        super().__init__()
        self.center_frame_idx = (num_frame // 2 if center_frame_idx is None
                                 else center_frame_idx)
        self.hr_in = hr_in
        self.with_predeblur = with_predeblur
        self.with_tsa = with_tsa
        if with_predeblur:
            self.predeblur = PredeblurModule(num_in_ch, num_feat, hr_in)
            self.conv_1x1 = _conv(num_feat, num_feat, 1)
        else:
            self.conv_first = _conv(num_in_ch, num_feat)
        self.feature_extraction = _blocks(num_feat, num_extract_block)
        for name, conv in _stride_convs(num_feat).items():
            setattr(self, name, conv)
        self.pcd_align = PCDAlignment(num_feat, deformable_groups)
        if with_tsa:
            self.fusion = TSAFusion(num_feat, num_frame,
                                    self.center_frame_idx)
        else:
            self.fusion = _conv(num_frame * num_feat, num_feat, 1)
        self.reconstruction = _blocks(num_feat, num_reconstruct_block)
        self.upconv1 = _conv(num_feat, num_feat * 4)
        self.upconv2 = _conv(num_feat, 64 * 4)
        self.conv_hr = _conv(64, 64)
        self.conv_last = _conv(64, num_out_ch)
        init_families(self, seed)

    def load(self, path, param_key='params'):
        from bsvd_tpu_torch.convert.torch_generic import load_torch_generic
        return load_torch_generic(path, self, param_key)

    def forward(self, x):
        n, t, c, h, w = x.shape
        if self.hr_in:
            assert h % 16 == 0 and w % 16 == 0, (
                'The height and width must be multiple of 16.')
        else:
            assert h % 4 == 0 and w % 4 == 0, (
                'The height and width must be multiple of 4.')
        x_center = x[:, self.center_frame_idx]
        flat = x.reshape(n * t, c, h, w)
        if self.with_predeblur:
            feat_l1 = self.conv_1x1(self.predeblur(flat))
        else:
            feat_l1 = lrelu(self.conv_first(flat))
        feat_l1 = self.feature_extraction(feat_l1)
        levels = feature_pyramid(self, feat_l1, n, t)
        aligned = align_all(self.pcd_align, levels, self.center_frame_idx)
        if self.with_tsa:
            feat = self.fusion(aligned)
        else:
            feat = self.fusion(aligned.flatten(1, 2))
        out = self.reconstruction(feat)
        out = lrelu(F.pixel_shuffle(self.upconv1(out), 2))
        out = lrelu(F.pixel_shuffle(self.upconv2(out), 2))
        out = self.conv_last(lrelu(self.conv_hr(out)))
        base = x_center if self.hr_in else bilinear_resize(x_center, 4)
        return out + base
