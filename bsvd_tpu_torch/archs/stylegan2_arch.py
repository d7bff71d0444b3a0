"""StyleGAN2 generator and discriminator (counterpart of
bsvd_tpu/archs/stylegan2_arch.py) as ``nn.Module``s with BasicSR's
parameter names (``style_mlp.1``, ``constant_input.weight``,
``style_convs.0.modulated_conv.weight`` (1, out, in, k, k),
``style_convs.0.activate.bias``, ``to_rgbs.0.bias`` (1, 3, 1, 1),
``noises.noise0``; ``conv_body.1.conv2.1.weight``, ``final_linear.0``), so
a BasicSR state dict loads strictly. ``convert_stylegan2_state`` /
``stylegan2_state_from_tree`` carry such a state dict to the JAX
package's tree and back (the JAX tree names a conv layer's conv ``conv``
and its activation's bias ``act_bias``, and keeps NHWC constant input,
noise and to-RGB bias); ``convert.torch_generic`` uses them for these
modules.

NCHW, plain PyTorch, the filters of ``ops/stylegan_ops``. The JAX
functions' rules kept here:

- the modulated conv's weight is ``scale * w * style``, demodulated with
  eps 1e-8; the upsample branch is a batch-grouped ``conv_transpose2d``
  (stride 2, no padding) followed by the blur, the downsample branch
  blurs then convolves with stride 2;
- the blur's pads (``_smooth_pad``) and the to-RGB skip's upsample pad;
- two styles mix at ``inject_index``, by default ``num_latent // 2``
  (BasicSR draws it at random);
- noise comes from the stored buffers when ``randomize_noise`` is false,
  else it is drawn per layer at (b, 1, res, res) from ``generator``;
- the minibatch stddev groups samples as ``reshape(group, -1, ...)`` with
  ``group = min(b, stddev_group)``, biased variance + 1e-8;
- the final flatten is channel-major;
- weights are drawn N(0, 1) (the equalised layers scale them at run
  time), the modulation bias starts at 1, and the mapping net's weights
  are drawn at lr_mul 1, as the JAX init draws them.
"""

import math
import re

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from bsvd_tpu_torch.convert.torch_generic import (_np, state_dict_to_tree,
                                                  tree_to_state_dict)
from bsvd_tpu_torch.ops.stylegan_ops import (fused_leaky_relu,
                                             make_resample_kernel, upfirdn2d)
from bsvd_tpu_torch.utils.registry import ARCH_REGISTRY


def _channels(mult, narrow):
    return {'4': int(512 * narrow), '8': int(512 * narrow),
            '16': int(512 * narrow), '32': int(512 * narrow),
            '64': int(256 * mult * narrow), '128': int(128 * mult * narrow),
            '256': int(64 * mult * narrow), '512': int(32 * mult * narrow),
            '1024': int(16 * mult * narrow)}


def _smooth_pad(resample_kernel, up, down, kernel_size):
    """The blur kernel and pad around a kernel_size conv that up- or
    downsamples by 2."""
    k = make_resample_kernel(resample_kernel)
    if up > 1:
        k = k * (up ** 2)
        pad = (k.shape[0] - up) - (kernel_size - 1)
        return k, ((pad + 1) // 2 + up - 1, pad // 2 + 1)
    pad = (k.shape[0] - down) + (kernel_size - 1)
    return k, ((pad + 1) // 2, pad // 2)


# ---------------------------------------------------------------------------
# equalised layers
# ---------------------------------------------------------------------------

class NormStyleCode(nn.Module):
    def forward(self, x):
        return x * torch.rsqrt(x.square().mean(dim=1, keepdim=True) + 1e-8)


class EqualLinear(nn.Module):
    """x @ (W * lr_mul / sqrt(in)) + b * lr_mul, fused with bias + lrelu
    x sqrt(2) for ``activation='fused_lrelu'``."""

    def __init__(self, in_channels, out_channels, bias_init_val=0.,
                 lr_mul=1., activation=None):
        super().__init__()
        self.scale = (1 / math.sqrt(in_channels)) * lr_mul
        self.lr_mul = lr_mul
        self.activation = activation
        self.weight = nn.Parameter(torch.randn(out_channels, in_channels))
        self.bias = nn.Parameter(torch.full((out_channels,),
                                            float(bias_init_val)))

    def forward(self, x):
        out = F.linear(x, self.weight * self.scale)
        if self.activation == 'fused_lrelu':
            return fused_leaky_relu(out, self.bias * self.lr_mul)
        return out + self.bias * self.lr_mul


class EqualConv2d(nn.Module):
    """conv by W / sqrt(in * k * k), without a bias (the discriminator's
    convs carry theirs in the activation, or none)."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.scale = 1 / math.sqrt(in_channels * kernel_size ** 2)
        self.weight = nn.Parameter(torch.randn(out_channels, in_channels,
                                               kernel_size, kernel_size))

    def forward(self, x):
        return F.conv2d(x, self.weight * self.scale, None, self.stride,
                        self.padding)


class FusedLeakyReLU(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return fused_leaky_relu(x, self.bias)


class UpFirDnSmooth(nn.Module):
    """The blur before a stride-2 conv (down) or after a transposed one
    (up); its kernel is a non-persistent buffer."""

    def __init__(self, resample_kernel, up, down, kernel_size):
        super().__init__()
        k, self.pad = _smooth_pad(resample_kernel, up, down, kernel_size)
        self.register_buffer('kernel', k, persistent=False)

    def forward(self, x):
        return upfirdn2d(x, self.kernel, pad=self.pad)


# ---------------------------------------------------------------------------
# modulated conv
# ---------------------------------------------------------------------------

class ModulatedConv2d(nn.Module):
    """A conv whose (1, out, in, k, k) weight is scaled per sample by the
    style's modulation (and demodulated), run as one grouped conv over the
    batch."""

    def __init__(self, in_channels, out_channels, kernel_size,
                 num_style_feat, demodulate=True, sample_mode=None,
                 resample_kernel=(1, 3, 3, 1), eps=1e-8):
        super().__init__()
        self.demodulate, self.sample_mode, self.eps = (demodulate,
                                                       sample_mode, eps)
        self.scale = 1 / math.sqrt(in_channels * kernel_size ** 2)
        self.modulation = EqualLinear(num_style_feat, in_channels,
                                      bias_init_val=1)
        self.weight = nn.Parameter(torch.randn(1, out_channels, in_channels,
                                               kernel_size, kernel_size))
        if sample_mode == 'upsample':
            self.smooth = UpFirDnSmooth(resample_kernel, 2, 1, kernel_size)
        elif sample_mode == 'downsample':
            self.smooth = UpFirDnSmooth(resample_kernel, 1, 2, kernel_size)

    def forward(self, x, style):
        b, cin, h, w = x.shape
        _, cout, _, k, _ = self.weight.shape
        s = self.modulation(style).view(b, 1, cin, 1, 1)
        wgt = self.scale * self.weight * s                # (b, out, in, k, k)
        if self.demodulate:
            demod = torch.rsqrt(wgt.square().sum(dim=(2, 3, 4)) + self.eps)
            wgt = wgt * demod.view(b, cout, 1, 1, 1)
        if self.sample_mode == 'upsample':
            wgt = wgt.transpose(1, 2).reshape(b * cin, cout, k, k)
            out = F.conv_transpose2d(x.reshape(1, b * cin, h, w), wgt,
                                     stride=2, groups=b)
            return self.smooth(out.view(b, cout, *out.shape[2:]))
        wgt = wgt.reshape(b * cout, cin, k, k)
        if self.sample_mode == 'downsample':
            x = self.smooth(x)
            out = F.conv2d(x.reshape(1, b * cin, *x.shape[2:]), wgt,
                           stride=2, groups=b)
        else:
            out = F.conv2d(x.reshape(1, b * cin, h, w), wgt,
                           padding=k // 2, groups=b)
        return out.view(b, cout, *out.shape[2:])


class StyleConv(nn.Module):
    """Modulated conv + noise x strength (``weight``) + fused lrelu."""

    def __init__(self, in_channels, out_channels, kernel_size,
                 num_style_feat, demodulate=True, sample_mode=None,
                 resample_kernel=(1, 3, 3, 1)):
        super().__init__()
        self.modulated_conv = ModulatedConv2d(
            in_channels, out_channels, kernel_size, num_style_feat,
            demodulate, sample_mode, resample_kernel)
        self.weight = nn.Parameter(torch.zeros(1))
        self.activate = FusedLeakyReLU(out_channels)

    def forward(self, x, style, noise):
        out = self.modulated_conv(x, style) + self.weight * noise
        return self.activate(out)


class ToRGB(nn.Module):
    """1x1 modulated conv to RGB (no demodulation) + bias, plus the
    upsampled skip."""

    def __init__(self, in_channels, num_style_feat, upsample=True,
                 resample_kernel=(1, 3, 3, 1)):
        super().__init__()
        self.upsample = upsample
        self.modulated_conv = ModulatedConv2d(in_channels, 3, 1,
                                              num_style_feat,
                                              demodulate=False)
        self.bias = nn.Parameter(torch.zeros(1, 3, 1, 1))
        if upsample:
            k = make_resample_kernel(resample_kernel) * 4
            pad = k.shape[0] - 2
            self.skip_pad = ((pad + 1) // 2 + 1, pad // 2)
            self.register_buffer('kernel', k, persistent=False)

    def forward(self, x, style, skip=None):
        out = self.modulated_conv(x, style) + self.bias
        if skip is not None:
            if self.upsample:
                skip = upfirdn2d(skip, self.kernel, up=2, pad=self.skip_pad)
            out = out + skip
        return out


class ConstantInput(nn.Module):
    def __init__(self, num_channel, size=4):
        super().__init__()
        self.weight = nn.Parameter(torch.randn(1, num_channel, size, size))

    def forward(self, batch):
        return self.weight.repeat(batch, 1, 1, 1)


def _draw_normal(module, gen):
    """Every weight but the noise strengths drawn N(0, 1) from ``gen``;
    biases and strengths keep their starts (0, the modulations' 1)."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith('weight') and p.ndim > 1:
                p.copy_(torch.randn(p.shape, generator=gen))


# ---------------------------------------------------------------------------
# generator
# ---------------------------------------------------------------------------

@ARCH_REGISTRY.register()
class StyleGAN2Generator(nn.Module):
    """styles (a list of (B, num_style_feat) codes, or latents with
    ``input_is_latent``) -> ((B, 3, out_size, out_size), latent)."""

    def __init__(self, out_size, num_style_feat=512, num_mlp=8,
                 channel_multiplier=2, resample_kernel=(1, 3, 3, 1),
                 lr_mlp=0.01, narrow=1, seed=0):
        super().__init__()
        self.out_size = out_size
        self.num_style_feat = num_style_feat
        self.lr_mlp = lr_mlp
        rk = tuple(resample_kernel)
        channels = _channels(channel_multiplier, narrow)
        self.log_size = int(math.log2(out_size))
        self.num_layers = (self.log_size - 2) * 2 + 1
        self.num_latent = self.log_size * 2 - 2
        self.style_mlp = nn.Sequential(NormStyleCode(), *[
            EqualLinear(num_style_feat, num_style_feat, 0, lr_mlp,
                        'fused_lrelu') for _ in range(num_mlp)])
        self.constant_input = ConstantInput(channels['4'], 4)
        self.style_conv1 = StyleConv(channels['4'], channels['4'], 3,
                                     num_style_feat, True, None, rk)
        self.to_rgb1 = ToRGB(channels['4'], num_style_feat, False, rk)
        self.style_convs = nn.ModuleList()
        self.to_rgbs = nn.ModuleList()
        self.noises = nn.Module()
        cin = channels['4']
        for i in range(3, self.log_size + 1):
            cout = channels[f'{2 ** i}']
            self.style_convs.append(StyleConv(cin, cout, 3, num_style_feat,
                                              True, 'upsample', rk))
            self.style_convs.append(StyleConv(cout, cout, 3, num_style_feat,
                                              True, None, rk))
            self.to_rgbs.append(ToRGB(cout, num_style_feat, True, rk))
            cin = cout
        gen = torch.Generator().manual_seed(int(seed))
        _draw_normal(self, gen)
        for i in range(self.num_layers):
            res = 2 ** ((i + 5) // 2)
            self.noises.register_buffer(
                f'noise{i}', torch.randn(1, 1, res, res, generator=gen))

    def make_noise(self, batch, generator=None):
        """One (batch, 1, res, res) normal draw per layer, from
        ``generator`` (on the module's device)."""
        return [torch.randn(batch, 1, 2 ** ((i + 5) // 2),
                            2 ** ((i + 5) // 2), generator=generator,
                            device=self.constant_input.weight.device)
                for i in range(self.num_layers)]

    def get_latent(self, x):
        return self.style_mlp(x)

    def mean_latent(self, num_latent, generator=None):
        z = torch.randn(num_latent, self.num_style_feat, generator=generator,
                        device=self.constant_input.weight.device)
        return self.get_latent(z).mean(0, keepdim=True)

    def forward(self, styles, input_is_latent=False, noise=None,
                randomize_noise=True, generator=None, truncation=1,
                truncation_latent=None, inject_index=None):
        if not input_is_latent:
            styles = [self.style_mlp(s) for s in styles]
        b = styles[0].shape[0]
        if noise is None:
            if randomize_noise:
                noise = self.make_noise(b, generator)
            else:
                noise = [getattr(self.noises, f'noise{i}')
                         for i in range(self.num_layers)]
        if truncation < 1:
            styles = [truncation_latent + truncation * (s - truncation_latent)
                      for s in styles]
        if len(styles) == 1:
            s = styles[0]
            latent = (s[:, None].repeat(1, self.num_latent, 1) if s.ndim < 3
                      else s)
        else:
            if inject_index is None:
                inject_index = self.num_latent // 2
            latent = torch.cat([
                styles[0][:, None].repeat(1, inject_index, 1),
                styles[1][:, None].repeat(1, self.num_latent - inject_index,
                                          1)], dim=1)
        out = self.constant_input(b)
        out = self.style_conv1(out, latent[:, 0], noise[0])
        skip = self.to_rgb1(out, latent[:, 1])
        i = 1
        for pi, to_rgb in enumerate(self.to_rgbs):
            out = self.style_convs[2 * pi](out, latent[:, i],
                                           noise[2 * pi + 1])
            out = self.style_convs[2 * pi + 1](out, latent[:, i + 1],
                                               noise[2 * pi + 2])
            skip = to_rgb(out, latent[:, i + 2], skip)
            i += 2
        return skip, latent


# ---------------------------------------------------------------------------
# discriminator
# ---------------------------------------------------------------------------

class ConvLayer(nn.Sequential):
    """[blur,] EqualConv2d[, FusedLeakyReLU] (BasicSR's Sequential: the
    conv is child 1 when it downsamples, else 0)."""

    def __init__(self, in_channels, out_channels, kernel_size,
                 downsample=False, resample_kernel=(1, 3, 3, 1),
                 activate=True):
        layers = []
        if downsample:
            layers.append(UpFirDnSmooth(resample_kernel, 1, 2, kernel_size))
            stride, padding = 2, 0
        else:
            stride, padding = 1, kernel_size // 2
        layers.append(EqualConv2d(in_channels, out_channels, kernel_size,
                                  stride, padding))
        if activate:
            layers.append(FusedLeakyReLU(out_channels))
        super().__init__(*layers)


class ResBlock(nn.Module):
    def __init__(self, in_channels, out_channels,
                 resample_kernel=(1, 3, 3, 1)):
        super().__init__()
        self.conv1 = ConvLayer(in_channels, in_channels, 3)
        self.conv2 = ConvLayer(in_channels, out_channels, 3, True,
                               resample_kernel)
        self.skip = ConvLayer(in_channels, out_channels, 1, True,
                              resample_kernel, activate=False)

    def forward(self, x):
        return (self.conv2(self.conv1(x)) + self.skip(x)) / math.sqrt(2)


@ARCH_REGISTRY.register()
class StyleGAN2Discriminator(nn.Module):
    """(B, 3, out_size, out_size) -> (B, 1) logits."""

    def __init__(self, out_size, channel_multiplier=2,
                 resample_kernel=(1, 3, 3, 1), stddev_group=4, narrow=1,
                 seed=0):
        super().__init__()
        self.stddev_group = stddev_group
        rk = tuple(resample_kernel)
        channels = _channels(channel_multiplier, narrow)
        log_size = int(math.log2(out_size))
        body = [ConvLayer(3, channels[f'{out_size}'], 1)]
        cin = channels[f'{out_size}']
        for i in range(log_size, 2, -1):
            cout = channels[f'{2 ** (i - 1)}']
            body.append(ResBlock(cin, cout, rk))
            cin = cout
        self.conv_body = nn.Sequential(*body)
        self.final_conv = ConvLayer(cin + 1, channels['4'], 3)
        self.final_linear = nn.Sequential(
            EqualLinear(channels['4'] * 4 * 4, channels['4'],
                        activation='fused_lrelu'),
            EqualLinear(channels['4'], 1))
        _draw_normal(self, torch.Generator().manual_seed(int(seed)))

    def forward(self, x):
        out = self.conv_body(x)
        b, c, h, w = out.shape
        group = min(b, self.stddev_group)
        stddev = torch.sqrt(out.view(group, -1, c, h, w).var(
            dim=0, unbiased=False) + 1e-8)
        stddev = stddev.mean(dim=(1, 2, 3)).view(-1, 1, 1, 1)
        out = torch.cat([out, stddev.repeat(group, 1, h, w)], dim=1)
        out = self.final_conv(out)
        return self.final_linear(out.reshape(b, -1))


# ---------------------------------------------------------------------------
# BasicSR state dict <-> the JAX package's tree
# ---------------------------------------------------------------------------

# a ConvLayer's children in the state dict, and its leaves in the JAX tree
_SD_LAYER = re.compile(r'^(conv_body\.\d+(?:\.(?:conv1|conv2|skip))?'
                       r'|final_conv)\.(\d+)\.(weight|bias)$')
_TREE_LAYER = re.compile(r'^(conv_body\.\d+(?:\.(?:conv1|conv2|skip))?'
                         r'|final_conv)\.(conv\.weight|conv\.bias|act_bias)$')


def _nhwc(v):
    return np.transpose(v, (0, 2, 3, 1))


def _nchw(v):
    return np.transpose(v, (0, 3, 1, 2))


def convert_stylegan2_state(state):
    """A StyleGAN2 generator's or discriminator's state dict (BasicSR
    names; a ``module.`` prefix is stripped) -> the JAX package's tree:
    constant input, noise buffers and to-RGB bias to NHWC, noise
    strengths to ``w``, 5-D modulated weights kept, a conv layer's
    children to ``conv`` / ``act_bias``; the rest by
    ``state_dict_to_tree``'s rules."""
    fixed, layers = {}, {}
    for key, val in state.items():
        key = key[len('module.'):] if key.startswith('module.') else key
        v = _np(val)
        m = _SD_LAYER.match(key)
        if m:
            layers.setdefault(m.group(1), {})[int(m.group(2)),
                                               m.group(3)] = v
        elif key.endswith('constant_input.weight'):
            fixed[key[:-len('weight')] + 'w'] = _nhwc(v)
        elif key.startswith('noises.') or '.noises.' in key:
            fixed[key] = _nhwc(v)
        elif key.endswith('.bias') and v.ndim == 4:        # to-RGB bias
            fixed[key] = _nhwc(v)
        elif key.endswith('.weight') and v.ndim in (0, 1) and v.size == 1:
            fixed[key[:-len('weight')] + 'w'] = v.reshape(1)
        else:
            fixed[key] = v
    for path, leaves in layers.items():
        conv = next(i for i, leaf in leaves if leaf == 'weight')
        for (i, leaf), v in leaves.items():
            if i == conv:
                fixed[f'{path}.conv.{leaf}'] = v
            elif i == conv + 1 and leaf == 'bias':
                fixed[f'{path}.act_bias'] = v
            else:
                raise KeyError(f'{path}.{i}.{leaf}: not a StyleGAN2 conv '
                               f'layer entry')
    return state_dict_to_tree(fixed)


def stylegan2_state_from_tree(tree):
    """The inverse of ``convert_stylegan2_state``: {BasicSR key: numpy
    array}."""
    out = {}
    for key, v in tree_to_state_dict(tree).items():
        m = _TREE_LAYER.match(key)
        if key == 'constant_input.weight':
            v = _nchw(np.asarray(tree['constant_input']['w']))
        elif key.startswith('noises.') or (key.endswith('.bias')
                                           and v.ndim == 4):
            v = _nchw(v)
        if m:
            path, leaf = m.groups()
            conv = 1 if path.endswith(('.conv2', '.skip')) else 0
            key = (f'{path}.{conv}.{leaf[len("conv."):]}'
                   if leaf.startswith('conv.') else f'{path}.{conv + 1}.bias')
        out[key] = v
    return out


for _cls in (StyleGAN2Generator, StyleGAN2Discriminator):
    _cls.tree_from_state = staticmethod(convert_stylegan2_state)
    _cls.state_from_tree = staticmethod(stylegan2_state_from_tree)
