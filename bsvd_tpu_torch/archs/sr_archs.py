"""The zoo's single-image SR nets as ``nn.Module``s (counterpart of
bsvd_tpu/archs/sr_archs.py: MSRResNet, EDSR, RRDBNet, RCAN, RIDNet and
their blocks), with BasicSR's parameter names (``conv_first``,
``body.0.conv1``, ``upconv1``, ``upsample.0``, ``body.0.rdb1.conv1``,
``body.0.residual_group.0.rcab.3.attention.1``, ...), so a BasicSR
``.pth`` loads with ``load_state_dict`` and a JAX tree through
``convert.torch_generic.from_jax_tree``.

Layout is NCHW. Every layer is a plain PyTorch op (``F.conv2d``,
``F.pixel_shuffle``, ``F.interpolate``): the JAX package computes them in
XLA, not in a Pallas kernel.

Initialisation follows the JAX package's families on a seeded
``torch.Generator`` (not its values): kaiming-normal convs with uniform
biases, scaled by 0.1 with zero biases for the MSRResNet / RRDB blocks,
torch's default uniform for EDSR's and RIDNet's ``pytorch_init`` blocks.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from bsvd_tpu_torch.utils.registry import ARCH_REGISTRY


def lrelu(x, slope=0.1):
    """Leaky ReLU at the JAX package's default slope of 0.1."""
    return F.leaky_relu(x, slope)


def bilinear_resize(x, scale):
    """``F.interpolate(mode='bilinear', align_corners=False)`` by an integer
    factor (the JAX package's ``jax.image.resize`` bilinear upscale)."""
    return F.interpolate(x, scale_factor=scale, mode='bilinear',
                         align_corners=False)


def pixel_unshuffle(x, scale):
    """Inverse pixel shuffle with torch's channel order, NCHW."""
    return F.pixel_unshuffle(x, scale)


# ---------------------------------------------------------------------------
# initialisation (the JAX package's families)
# ---------------------------------------------------------------------------

class _Init:
    """The JAX init families on one seeded CPU generator."""

    def __init__(self, seed):
        self.gen = torch.Generator().manual_seed(int(seed))

    def kaiming(self, conv, scale=1.0, zero_bias=False):
        """Kaiming-normal weight (fan_in, relu gain), torch's uniform bias;
        ``scale`` multiplies the weight (the 0.1 family zeroes the bias)."""
        w = getattr(conv, 'weight_orig', None)
        w = conv.weight if w is None else w
        fan_in = w.shape[1] * w.shape[2] * w.shape[3]
        with torch.no_grad():
            w.copy_(torch.randn(w.shape, generator=self.gen)
                    * (math.sqrt(2.0 / fan_in) * scale))
            if conv.bias is not None:
                if zero_bias:
                    conv.bias.zero_()
                else:
                    self.uniform(conv.bias, 1 / math.sqrt(fan_in))

    def torch_default(self, conv):
        """torch's default conv init (kaiming_uniform, a = sqrt(5))."""
        fan_in = conv.weight[0].numel()
        self.uniform(conv.weight, math.sqrt(6.0 / (6 * fan_in)))
        if conv.bias is not None:
            self.uniform(conv.bias, 1 / math.sqrt(fan_in))

    def uniform(self, t, bound):
        with torch.no_grad():
            t.copy_((torch.rand(t.shape, generator=self.gen) * 2 - 1)
                     * bound)

    def all_kaiming(self, module, scale=1.0, zero_bias=False):
        for m in module.modules():
            if isinstance(m, nn.Conv2d):
                self.kaiming(m, scale, zero_bias)


def _conv(cin, cout, k=3, bias=True, padding=None, dilation=1):
    pad = (k // 2) * dilation if padding is None else padding
    return nn.Conv2d(cin, cout, k, 1, pad, dilation=dilation, bias=bias)


class ResidualBlockNoBN(nn.Module):
    """x + conv2(relu(conv1(x))) * res_scale (BasicSR arch_util)."""

    def __init__(self, num_feat=64, res_scale=1.0):
        super().__init__()
        self.res_scale = res_scale
        self.conv1 = _conv(num_feat, num_feat)
        self.conv2 = _conv(num_feat, num_feat)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(x))) * self.res_scale


class Upsample(nn.Sequential):
    """conv + pixel shuffle, log2(scale) times for 2^n, once for 3
    (children '0', '2', ... are the convs, as in BasicSR)."""

    def __init__(self, scale, num_feat):
        layers = []
        if scale & (scale - 1) == 0:
            for _ in range(int(math.log2(scale))):
                layers += [_conv(num_feat, 4 * num_feat), nn.PixelShuffle(2)]
        elif scale == 3:
            layers += [_conv(num_feat, 9 * num_feat), nn.PixelShuffle(3)]
        else:
            raise ValueError(f'scale {scale} not supported (2^n and 3)')
        super().__init__(*layers)


# ---------------------------------------------------------------------------
# MSRResNet
# ---------------------------------------------------------------------------

@ARCH_REGISTRY.register()
class MSRResNet(nn.Module):
    """Modified SRResNet: conv, ``num_block`` residual blocks without BN,
    pixel-shuffle upsampling, plus the bilinear upscale of the input."""

    def __init__(self, num_in_ch=3, num_out_ch=3, num_feat=64, num_block=16,
                 upscale=4, seed=0):
        super().__init__()
        self.upscale = upscale
        self.conv_first = _conv(num_in_ch, num_feat)
        self.body = nn.Sequential(*[ResidualBlockNoBN(num_feat)
                                    for _ in range(num_block)])
        if upscale in (2, 3):
            self.upconv1 = _conv(num_feat, num_feat * upscale * upscale)
        elif upscale == 4:
            self.upconv1 = _conv(num_feat, num_feat * 4)
            self.upconv2 = _conv(num_feat, num_feat * 4)
        else:
            raise ValueError(f'upscale {upscale} not supported (2, 3, 4)')
        self.conv_hr = _conv(num_feat, num_feat)
        self.conv_last = _conv(num_feat, num_out_ch)
        _Init(seed).all_kaiming(self, 0.1, zero_bias=True)

    def forward(self, x):
        out = self.body(lrelu(self.conv_first(x)))
        if self.upscale == 4:
            out = lrelu(F.pixel_shuffle(self.upconv1(out), 2))
            out = lrelu(F.pixel_shuffle(self.upconv2(out), 2))
        else:
            out = lrelu(F.pixel_shuffle(self.upconv1(out), self.upscale))
        out = self.conv_last(lrelu(self.conv_hr(out)))
        return out + bilinear_resize(x, self.upscale)


# ---------------------------------------------------------------------------
# EDSR
# ---------------------------------------------------------------------------

def _mean(rgb_mean, x):
    return torch.tensor(rgb_mean, dtype=x.dtype, device=x.device).view(
        1, -1, 1, 1)


@ARCH_REGISTRY.register()
class EDSR(nn.Module):
    """EDSR: mean shift and ``img_range`` scaling around conv, residual
    blocks (``res_scale``), conv_after_body, Upsample, conv_last."""

    def __init__(self, num_in_ch=3, num_out_ch=3, num_feat=64, num_block=16,
                 upscale=4, res_scale=1, img_range=255.,
                 rgb_mean=(0.4488, 0.4371, 0.4040), seed=0):
        super().__init__()
        self.img_range = img_range
        self.rgb_mean = tuple(rgb_mean)
        self.conv_first = _conv(num_in_ch, num_feat)
        self.body = nn.Sequential(*[ResidualBlockNoBN(num_feat, res_scale)
                                    for _ in range(num_block)])
        self.conv_after_body = _conv(num_feat, num_feat)
        self.upsample = Upsample(upscale, num_feat)
        self.conv_last = _conv(num_feat, num_out_ch)
        init = _Init(seed)
        init.all_kaiming(self)
        for blk in self.body:
            init.torch_default(blk.conv1)
            init.torch_default(blk.conv2)

    def forward(self, x):
        mean = _mean(self.rgb_mean, x)
        x = (x - mean) * self.img_range
        feat = self.conv_first(x)
        res = self.conv_after_body(self.body(feat)) + feat
        out = self.conv_last(self.upsample(res))
        return out / self.img_range + mean


# ---------------------------------------------------------------------------
# RRDBNet (ESRGAN)
# ---------------------------------------------------------------------------

class ResidualDenseBlock(nn.Module):
    """Five densely connected convs (leaky ReLU 0.2), residual x 0.2."""

    def __init__(self, num_feat=64, num_grow_ch=32):
        super().__init__()
        for i in range(4):
            setattr(self, f'conv{i + 1}',
                    _conv(num_feat + i * num_grow_ch, num_grow_ch))
        self.conv5 = _conv(num_feat + 4 * num_grow_ch, num_feat)

    def forward(self, x):
        feats = [x]
        for i in range(4):
            conv = getattr(self, f'conv{i + 1}')
            feats.append(lrelu(conv(torch.cat(feats, 1)), 0.2))
        return self.conv5(torch.cat(feats, 1)) * 0.2 + x


class RRDB(nn.Module):
    """Three residual dense blocks, residual x 0.2."""

    def __init__(self, num_feat, num_grow_ch=32):
        super().__init__()
        self.rdb1 = ResidualDenseBlock(num_feat, num_grow_ch)
        self.rdb2 = ResidualDenseBlock(num_feat, num_grow_ch)
        self.rdb3 = ResidualDenseBlock(num_feat, num_grow_ch)

    def forward(self, x):
        return self.rdb3(self.rdb2(self.rdb1(x))) * 0.2 + x


@ARCH_REGISTRY.register()
class RRDBNet(nn.Module):
    """ESRGAN's generator: RRDB trunk, two nearest x2 upsamplings; scale 2
    and 1 fold the input by pixel_unshuffle first."""

    def __init__(self, num_in_ch=3, num_out_ch=3, scale=4, num_feat=64,
                 num_block=23, num_grow_ch=32, seed=0):
        super().__init__()
        self.scale = scale
        if scale == 2:
            num_in_ch *= 4
        elif scale == 1:
            num_in_ch *= 16
        self.conv_first = _conv(num_in_ch, num_feat)
        self.body = nn.Sequential(*[RRDB(num_feat, num_grow_ch)
                                    for _ in range(num_block)])
        self.conv_body = _conv(num_feat, num_feat)
        self.conv_up1 = _conv(num_feat, num_feat)
        self.conv_up2 = _conv(num_feat, num_feat)
        self.conv_hr = _conv(num_feat, num_feat)
        self.conv_last = _conv(num_feat, num_out_ch)
        init = _Init(seed)
        init.all_kaiming(self)
        for blk in self.body:
            init.all_kaiming(blk, 0.1, zero_bias=True)

    def forward(self, x):
        if self.scale == 2:
            x = pixel_unshuffle(x, 2)
        elif self.scale == 1:
            x = pixel_unshuffle(x, 4)
        feat = self.conv_first(x)
        feat = feat + self.conv_body(self.body(feat))
        feat = lrelu(self.conv_up1(F.interpolate(feat, scale_factor=2,
                                                 mode='nearest')), 0.2)
        feat = lrelu(self.conv_up2(F.interpolate(feat, scale_factor=2,
                                                 mode='nearest')), 0.2)
        return self.conv_last(lrelu(self.conv_hr(feat), 0.2))


# ---------------------------------------------------------------------------
# RCAN
# ---------------------------------------------------------------------------

class ChannelAttention(nn.Module):
    """x * sigmoid(conv(relu(conv(mean over H, W)))); children 'attention.1'
    and 'attention.3' as BasicSR's Sequential names them."""

    def __init__(self, num_feat, squeeze_factor=16):
        super().__init__()
        self.attention = nn.Sequential(
            nn.AdaptiveAvgPool2d(1),
            nn.Conv2d(num_feat, num_feat // squeeze_factor, 1),
            nn.ReLU(inplace=False),
            nn.Conv2d(num_feat // squeeze_factor, num_feat, 1),
            nn.Sigmoid())

    def forward(self, x):
        y = x.mean(dim=(2, 3), keepdim=True)
        a = self.attention
        return x * torch.sigmoid(a[3](F.relu(a[1](y))))


class RCAB(nn.Module):
    """conv, relu, conv, channel attention (``rcab.0`` / ``.2`` / ``.3``),
    times res_scale, plus x."""

    def __init__(self, num_feat, squeeze_factor=16, res_scale=1):
        super().__init__()
        self.res_scale = res_scale
        self.rcab = nn.Sequential(
            _conv(num_feat, num_feat), nn.ReLU(inplace=False),
            _conv(num_feat, num_feat),
            ChannelAttention(num_feat, squeeze_factor))

    def forward(self, x):
        r = self.rcab
        res = r[3](r[2](F.relu(r[0](x)))) * self.res_scale
        return res + x


class ResidualGroup(nn.Module):
    """``num_block`` RCABs and a conv, plus x."""

    def __init__(self, num_feat, num_block, squeeze_factor=16, res_scale=1):
        super().__init__()
        self.residual_group = nn.Sequential(*[
            RCAB(num_feat, squeeze_factor, res_scale)
            for _ in range(num_block)])
        self.conv = _conv(num_feat, num_feat)

    def forward(self, x):
        return self.conv(self.residual_group(x)) + x


@ARCH_REGISTRY.register()
class RCAN(nn.Module):
    """Residual channel attention network: residual groups of RCABs inside
    EDSR's mean shift, conv_after_body and Upsample."""

    def __init__(self, num_in_ch=3, num_out_ch=3, num_feat=64, num_group=10,
                 num_block=16, squeeze_factor=16, upscale=4, res_scale=1,
                 img_range=255., rgb_mean=(0.4488, 0.4371, 0.4040), seed=0):
        super().__init__()
        self.img_range = img_range
        self.rgb_mean = tuple(rgb_mean)
        self.conv_first = _conv(num_in_ch, num_feat)
        self.body = nn.Sequential(*[
            ResidualGroup(num_feat, num_block, squeeze_factor, res_scale)
            for _ in range(num_group)])
        self.conv_after_body = _conv(num_feat, num_feat)
        self.upsample = Upsample(upscale, num_feat)
        self.conv_last = _conv(num_feat, num_out_ch)
        _Init(seed).all_kaiming(self)

    def forward(self, x):
        mean = _mean(self.rgb_mean, x)
        x = (x - mean) * self.img_range
        feat = self.conv_first(x)
        res = self.conv_after_body(self.body(feat)) + feat
        out = self.conv_last(self.upsample(res))
        return out / self.img_range + mean


# ---------------------------------------------------------------------------
# RIDNet
# ---------------------------------------------------------------------------

class MeanShift(nn.Conv2d):
    """A fixed 1x1 conv: x / std + sign * img_range * mean / std per
    channel (its weight and bias are buffers of the state dict, as
    BasicSR's are parameters that never train)."""

    def __init__(self, img_range, rgb_mean, rgb_std, sign=-1):
        super().__init__(3, 3, 1)
        std = torch.tensor(rgb_std, dtype=torch.float32)
        with torch.no_grad():
            self.weight.copy_(torch.eye(3).view(3, 3, 1, 1)
                              / std.view(3, 1, 1, 1))
            self.bias.copy_(sign * img_range
                            * torch.tensor(rgb_mean, dtype=torch.float32)
                            / std)
        self.weight.requires_grad_(False)
        self.bias.requires_grad_(False)


class EAM(nn.Module):
    """RIDNet's enhancement attention module: a dilated merge-and-run
    unit, a residual block, an enhanced residual block, channel attention
    (BasicSR's names: merge.dilation1.0, block1.conv1, block2.body.0,
    ca.attention.1, ...)."""

    def __init__(self, in_channels, mid_channels, out_channels):
        super().__init__()
        self.merge = nn.Module()
        self.merge.dilation1 = nn.Sequential(
            _conv(in_channels, mid_channels), nn.ReLU(),
            _conv(mid_channels, mid_channels, dilation=2))
        self.merge.dilation2 = nn.Sequential(
            _conv(in_channels, mid_channels, dilation=3), nn.ReLU(),
            _conv(mid_channels, mid_channels, dilation=4))
        self.merge.aggregation = nn.Sequential(
            _conv(mid_channels * 2, mid_channels))
        self.block1 = ResidualBlockNoBN(mid_channels)
        self.block2 = nn.Module()
        self.block2.body = nn.Sequential(
            _conv(mid_channels, out_channels), nn.ReLU(),
            _conv(out_channels, out_channels), nn.ReLU(),
            nn.Conv2d(out_channels, out_channels, 1))
        self.ca = ChannelAttention(out_channels, 16)

    def forward(self, x):
        m = self.merge
        d1 = F.relu(m.dilation1[2](F.relu(m.dilation1[0](x))))
        d2 = F.relu(m.dilation2[2](F.relu(m.dilation2[0](x))))
        out = F.relu(m.aggregation[0](torch.cat([d1, d2], 1))) + x
        out = F.relu(self.block1(out))
        b = self.block2.body
        out = F.relu(b[4](F.relu(b[2](F.relu(b[0](out))))) + out)
        return self.ca(out)


@ARCH_REGISTRY.register()
class RIDNet(nn.Module):
    """Real image denoising network: mean shift, head conv, EAMs, tail
    conv, mean shift back, plus the input."""

    def __init__(self, in_channels=3, mid_channels=64, out_channels=3,
                 num_block=4, img_range=255.,
                 rgb_mean=(0.4488, 0.4371, 0.4040), rgb_std=(1.0, 1.0, 1.0),
                 seed=0):
        super().__init__()
        self.sub_mean = MeanShift(img_range, rgb_mean, rgb_std, -1)
        self.add_mean = MeanShift(img_range, rgb_mean, rgb_std, 1)
        self.head = _conv(in_channels, mid_channels)
        self.body = nn.Sequential(*[EAM(mid_channels, mid_channels,
                                        mid_channels)
                                    for _ in range(num_block)])
        self.tail = _conv(mid_channels, out_channels)
        init = _Init(seed)
        for m in self.modules():
            if isinstance(m, nn.Conv2d) and not isinstance(m, MeanShift):
                init.kaiming(m)
        for eam in self.body:
            init.torch_default(eam.block1.conv1)
            init.torch_default(eam.block1.conv2)

    def forward(self, x):
        res = F.relu(self.head(self.sub_mean(x)))
        res = self.add_mean(self.tail(self.body(res)))
        return x + res
