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

``IconVSR`` needs EDVR's PCD alignment and deformable convolution, which
are not ported yet (ROADMAP Queue 1 item 3a): it raises.
"""

import torch
import torch.nn.functional as F
from torch import nn

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
            out = lrelu(F.pixel_shuffle(self.upconv1(out), 2))
            out = lrelu(F.pixel_shuffle(self.upconv2(out), 2))
            out = self.conv_last(lrelu(self.conv_hr(out)))
            outs.append(out + bilinear_resize(x_i, 4))
        return torch.stack(outs, dim=1)


@ARCH_REGISTRY.register()
class IconVSR(nn.Module):
    """BasicVSR with EDVR keyframe features: not ported yet."""

    def __init__(self, *args, **kwargs):
        super().__init__()
        raise NotImplementedError(
            'IconVSR needs EDVR (edvr_arch) and ops/deform_conv, which are '
            'not ported yet (ROADMAP.md Queue 1 item 3a)')
