"""BasicVSR, bidirectional recurrent video SR, as an ``nn.Module``
(counterpart of bsvd_tpu/archs/basicvsr_arch.py:19-128, BasicSR's
basicvsr_arch): SpyNet flows between neighbouring frames, a backward
branch over frames t-1 .. 0 and a forward branch over 0 .. t-1, each
warping its propagated feature by the flow and refining it with a
``ConvResidualBlocks`` trunk, then fusion and a x4 pixel-shuffle
upsampler over the bilinear x4 of the frame. BasicSR's names
(``spynet.*``, ``backward_trunk.main.*``, ``forward_trunk.main.*``,
``fusion``, ``upconv1/2``, ``conv_hr``, ``conv_last``), so a BasicSR
``.pth`` loads with ``load_state_dict``.

Plain PyTorch on NCHW tensors, the branches Python loops over frames:
the JAX package runs them as ``lax.scan`` in XLA, outside any Pallas
kernel. The JAX package warps the zero feature that starts each branch
by a zero flow; the port starts from the zero feature unwarped, as
BasicSR does: a bilinear sample of zeros is zero, so both give the same
bits.

``IconVSR`` (counterpart of bsvd_tpu/archs/basicvsr_arch.py:128-295) adds
EDVR features of key frames (every ``keyframe_stride``-th and the last):
``EDVRFeatureExtractor`` (EDVR's pyramid, PCD alignment and TSA fusion on
a window of ``2 * temporal_padding + 1`` frames of the clip, mirrored at
its ends) fused into both branches, the forward branch also taking the
backward branch's feature. Inputs are reflect-padded to multiples of 4
and the output cropped back.
"""

import torch
import torch.nn.functional as F
from torch import nn

from bsvd_tpu_torch.archs.edvr_arch import (PCDAlignment, TSAFusion,
                                            _blocks, _stride_convs,
                                            align_all, feature_pyramid,
                                            init_families)
from bsvd_tpu_torch.archs.spynet_arch import SpyNet
from bsvd_tpu_torch.archs.sr_archs import (ResidualBlockNoBN, _conv, _Init,
                                           bilinear_resize, lrelu)
from bsvd_tpu_torch.nn.warp import flow_warp
from bsvd_tpu_torch.utils.registry import ARCH_REGISTRY


class ConvResidualBlocks(nn.Module):
    """conv 3x3, leaky ReLU 0.1, ``num_block`` residual blocks without
    BN (``main.0``, ``main.2.<i>.conv1/conv2``)."""

    def __init__(self, num_in_ch=3, num_out_ch=64, num_block=15):
        super().__init__()
        self.main = nn.Sequential(
            _conv(num_in_ch, num_out_ch), nn.LeakyReLU(0.1),
            nn.Sequential(*[ResidualBlockNoBN(num_out_ch)
                            for _ in range(num_block)]))

    def forward(self, x):
        return self.main(x)


@ARCH_REGISTRY.register()
class BasicVSR(nn.Module):
    """(N, T, 3, H, W) LQ frames in [0, 1] -> (N, T, 3, 4H, 4W)."""

    def __init__(self, num_feat=64, num_block=15, spynet_path=None, seed=0):
        super().__init__()
        self.num_feat = num_feat
        self.spynet = SpyNet(seed=seed + 1)
        self.backward_trunk = ConvResidualBlocks(num_feat + 3, num_feat,
                                                 num_block)
        self.forward_trunk = ConvResidualBlocks(num_feat + 3, num_feat,
                                                num_block)
        self.fusion = nn.Conv2d(num_feat * 2, num_feat, 1, 1, 0)
        self.upconv1 = _conv(num_feat, num_feat * 4)
        self.upconv2 = _conv(num_feat, 64 * 4)
        self.conv_hr = _conv(64, 64)
        self.conv_last = _conv(64, 3)
        init = _Init(seed)
        for name, m in self.named_children():
            if name != 'spynet':
                init.all_kaiming(m)
        for trunk in (self.backward_trunk, self.forward_trunk):
            for block in trunk.main[2]:
                init.all_kaiming(block, 0.1, zero_bias=True)
        if spynet_path:
            self.spynet.load(spynet_path)

    def get_flow(self, x):
        """Flows between neighbours: backward (frame i+1 onto i) and
        forward (frame i onto i+1), each (N, T-1, H, W, 2)."""
        n, t, c, h, w = x.shape
        x1 = x[:, :-1].reshape(-1, c, h, w)
        x2 = x[:, 1:].reshape(-1, c, h, w)
        flows_backward = self.spynet(x1, x2).view(n, t - 1, 2, h, w)
        flows_forward = self.spynet(x2, x1).view(n, t - 1, 2, h, w)
        return (flows_backward.permute(0, 1, 3, 4, 2),
                flows_forward.permute(0, 1, 3, 4, 2))

    def forward(self, x):
        n, t, _, h, w = x.shape
        flows_backward, flows_forward = self.get_flow(x)

        back_feats = [None] * t
        feat = x.new_zeros(n, self.num_feat, h, w)
        for i in range(t - 1, -1, -1):
            if i < t - 1:
                feat = flow_warp(feat, flows_backward[:, i])
            feat = self.backward_trunk(torch.cat([x[:, i], feat], 1))
            back_feats[i] = feat

        outs = []
        feat = torch.zeros_like(feat)
        for i in range(t):
            x_i = x[:, i]
            if i > 0:
                feat = flow_warp(feat, flows_forward[:, i - 1])
            feat = self.forward_trunk(torch.cat([x_i, feat], 1))
            out = lrelu(self.fusion(torch.cat([back_feats[i], feat], 1)))
            outs.append(self.upsample(out, x_i))
        return torch.stack(outs, dim=1)

    def upsample(self, feat, x_i):
        """The x4 pixel-shuffle reconstruction of one frame's feature,
        plus the frame's bilinear x4."""
        out = lrelu(F.pixel_shuffle(self.upconv1(feat), 2))
        out = lrelu(F.pixel_shuffle(self.upconv2(out), 2))
        out = self.conv_last(lrelu(self.conv_hr(out)))
        return out + bilinear_resize(x_i, 4)


class EDVRFeatureExtractor(nn.Module):
    """EDVR's front on a window: (N, T, 3, H, W) -> the centre frame's
    fused features (N, C, H, W)."""

    def __init__(self, num_input_frame, num_feat=64, deformable_groups=8):
        super().__init__()
        self.center_frame_idx = num_input_frame // 2
        self.conv_first = _conv(3, num_feat)
        self.feature_extraction = _blocks(num_feat, 5)
        for name, conv in _stride_convs(num_feat).items():
            setattr(self, name, conv)
        self.pcd_align = PCDAlignment(num_feat, deformable_groups)
        self.fusion = TSAFusion(num_feat, num_input_frame,
                                self.center_frame_idx)

    def forward(self, x):
        n, t, c, h, w = x.shape
        feat_l1 = self.feature_extraction(lrelu(self.conv_first(
            x.reshape(n * t, c, h, w))))
        levels = feature_pyramid(self, feat_l1, n, t)
        return self.fusion(align_all(self.pcd_align, levels,
                                     self.center_frame_idx))


# the frames mirrored before and after the clip, by temporal padding
_MIRROR = {2: ([4, 3], [-4, -5]), 3: ([6, 5, 4], [-5, -6, -7])}


@ARCH_REGISTRY.register()
class IconVSR(nn.Module):
    """(N, T, 3, H, W) LQ frames in [0, 1] -> (N, T, 3, 4H, 4W); T at
    least 2 * temporal_padding + 1."""

    def __init__(self, num_feat=64, num_block=15, keyframe_stride=5,
                 temporal_padding=2, spynet_path=None, edvr_path=None,
                 seed=0):
        super().__init__()
        if temporal_padding not in _MIRROR:
            raise ValueError(f'temporal_padding {temporal_padding} not '
                             f'supported (2 or 3)')
        self.num_feat = num_feat
        self.keyframe_stride = keyframe_stride
        self.temporal_padding = temporal_padding
        self.spynet = SpyNet(seed=seed + 1)
        self.edvr = EDVRFeatureExtractor(temporal_padding * 2 + 1, num_feat)
        self.backward_fusion = _conv(2 * num_feat, num_feat)
        self.backward_trunk = ConvResidualBlocks(num_feat + 3, num_feat,
                                                 num_block)
        self.forward_fusion = _conv(2 * num_feat, num_feat)
        self.forward_trunk = ConvResidualBlocks(2 * num_feat + 3, num_feat,
                                                num_block)
        self.upconv1 = _conv(num_feat, num_feat * 4)
        self.upconv2 = _conv(num_feat, 64 * 4)
        self.conv_hr = _conv(64, 64)
        self.conv_last = _conv(64, 3)
        init_families(self.edvr, seed + 2)
        init = _Init(seed)
        for name, m in self.named_children():
            if name not in ('spynet', 'edvr'):
                init.all_kaiming(m)
        for trunk in (self.backward_trunk, self.forward_trunk):
            for block in trunk.main[2]:
                init.all_kaiming(block, 0.1, zero_bias=True)
        if spynet_path:
            self.spynet.load(spynet_path)
        if edvr_path:
            from bsvd_tpu_torch.convert.torch_generic import \
                load_torch_generic
            load_torch_generic(edvr_path, self.edvr, 'params')

    get_flow = BasicVSR.get_flow
    upsample = BasicVSR.upsample

    def load(self, path, param_key='params'):
        from bsvd_tpu_torch.convert.torch_generic import load_torch_generic
        return load_torch_generic(path, self, param_key)

    def _keyframe_feats(self, x, keyframe_idx):
        before, after = _MIRROR[self.temporal_padding]
        padded = torch.cat([x[:, before], x, x[:, after]], 1)
        nf = 2 * self.temporal_padding + 1
        return {i: self.edvr(padded[:, i:i + nf]) for i in keyframe_idx}

    def forward(self, x):
        n, t, c, h_in, w_in = x.shape
        pad_h, pad_w = (4 - h_in % 4) % 4, (4 - w_in % 4) % 4
        if pad_h or pad_w:
            x = F.pad(x.reshape(n * t, c, h_in, w_in), (0, pad_w, 0, pad_h),
                      mode='reflect').view(n, t, c, h_in + pad_h,
                                           w_in + pad_w)
        h, w = x.shape[-2:]
        keyframe_idx = list(range(0, t, self.keyframe_stride))
        if keyframe_idx[-1] != t - 1:
            keyframe_idx.append(t - 1)
        flows_backward, flows_forward = self.get_flow(x)
        feats_keyframe = self._keyframe_feats(x, keyframe_idx)

        back_feats = [None] * t
        feat = x.new_zeros(n, self.num_feat, h, w)
        for i in range(t - 1, -1, -1):
            if i < t - 1:
                feat = flow_warp(feat, flows_backward[:, i])
            if i in feats_keyframe:
                feat = self.backward_fusion(torch.cat(
                    [feat, feats_keyframe[i]], 1))
            feat = self.backward_trunk(torch.cat([x[:, i], feat], 1))
            back_feats[i] = feat

        outs = []
        feat = torch.zeros_like(feat)
        for i in range(t):
            x_i = x[:, i]
            if i > 0:
                feat = flow_warp(feat, flows_forward[:, i - 1])
            if i in feats_keyframe:
                feat = self.forward_fusion(torch.cat(
                    [feat, feats_keyframe[i]], 1))
            feat = self.forward_trunk(torch.cat([x_i, back_feats[i], feat],
                                                1))
            outs.append(self.upsample(feat, x_i))
        return torch.stack(outs, dim=1)[..., :4 * h_in, :4 * w_in]
