"""HiFaceGAN: the SPADE face-renovation generator with its LIP encoder, and
the pix2pixHD-style multiscale discriminator (counterpart of
bsvd_tpu/archs/hifacegan_arch.py), as ``nn.Module``s with BasicSR's
parameter names (``lip_encoder.model.3.logit.0``, ``head_0.norm_0.
mlp_shared.0``, ``ups.3.conv_s``, ``to_rgbs.3``; the discriminator's
``discriminator_0.model1.0.0.weight_orig`` / ``weight_u``), so a BasicSR
state dict loads strictly and a JAX tree through ``convert.torch_generic``.

Layout is NCHW and every layer is plain PyTorch (the JAX package computes
them in XLA, not in a Pallas kernel). The JAX functions' rules kept here:

- ``nearest_resize`` picks rows ``arange(oh) * h // oh`` in integers (not
  ``F.interpolate``'s float scale, which can pick another row for sizes
  that are not powers of two);
- instance norm uses the biased variance and eps 1e-5, with no affine
  except in the LIP logit;
- the LIP pooling and the multiscale downscale are ``avg_pool2d(3, 2, 1)``
  without the padding in the count;
- the discriminator's 4 x 4 convs pad by 2 and have stride 2 except in
  the last hidden layer; instance norm follows every hidden layer but the
  first.

Spectral norm on the discriminator's convs comes in the JAX package's two
modes, chosen as there by the weights and not by ``norm_d`` (accepted and
unused): the discriminator is built with ``SNConv2d``s, a raw weight and
a persistent power-iteration ``u`` (one step in every forward;
``forward_stats`` returns the new vectors and ``update_state`` stores
them, when the engine says so); ``load_state_dict`` of a state whose
convs carry a ``weight`` with sigma folded in (a converted checkpoint, a
tree without ``u``) makes those convs plain ones, and a state with
``weight_orig`` / ``weight_u`` makes them spectral again.
"""

import torch
import torch.nn.functional as F
from torch import nn

from bsvd_tpu_torch.archs.discriminator_arch import SNConv2d
from bsvd_tpu_torch.archs.sr_archs import _Init
from bsvd_tpu_torch.utils.registry import ARCH_REGISTRY

IN_EPS = 1e-5


def lrelu2(x):
    return F.leaky_relu(x, 0.2)


def nearest_resize(x, oh, ow):
    """Nearest resize of (N, C, H, W) to (oh, ow) by the integer rule
    ``arange(o) * size // o``."""
    h, w = x.shape[-2:]
    iy = torch.arange(oh, device=x.device) * h // oh
    ix = torch.arange(ow, device=x.device) * w // ow
    return x[:, :, iy][:, :, :, ix]


def instance_norm(x, eps=IN_EPS):
    """Per-sample, per-channel normalisation over H, W (biased variance)."""
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = x.var(dim=(2, 3), unbiased=False, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


def avg_pool_excl(x, k=3, s=2, p=1):
    """``avg_pool2d`` with the padding left out of the count, on a
    contiguous copy: on the card (PyTorch 2.11, CUDA 12.8) the backward
    of a padded F.avg_pool2d of a channels-last tensor is wrong."""
    return F.avg_pool2d(x.contiguous(), k, s, p, count_include_pad=False)


def lip2d(x, logit, k=3, s=2, p=1):
    """Local importance pooling: pooled x * exp(logit) over pooled
    exp(logit)."""
    weight = logit.exp()
    return avg_pool_excl(x * weight, k, s, p) / avg_pool_excl(weight, k, s, p)


def _conv(cin, cout, k=3, bias=True, padding=1):
    return nn.Conv2d(cin, cout, k, 1, padding, bias=bias)


# ---------------------------------------------------------------------------
# SPADE
# ---------------------------------------------------------------------------

class SPADE(nn.Module):
    """Instance norm modulated by gamma / beta convs of the resized
    segmentation map (here the LQ image)."""

    def __init__(self, norm_nc, label_nc, ks=3):
        super().__init__()
        nhidden = 128 if norm_nc > 128 else norm_nc
        self.mlp_shared = nn.Sequential(_conv(label_nc, nhidden, ks),
                                        nn.ReLU())
        self.mlp_gamma = _conv(nhidden, norm_nc, ks, bias=False)
        self.mlp_beta = _conv(nhidden, norm_nc, ks, bias=False)

    def forward(self, x, segmap):
        seg = nearest_resize(segmap, x.shape[2], x.shape[3])
        actv = self.mlp_shared(seg)
        return instance_norm(x) * self.mlp_gamma(actv) + self.mlp_beta(actv)


class SPADEResnetBlock(nn.Module):
    """Two SPADE -> lrelu -> conv steps, and a SPADE -> 1x1 conv shortcut
    where the width changes."""

    def __init__(self, fin, fout, semantic_nc=3):
        super().__init__()
        fmiddle = min(fin, fout)
        self.learned_shortcut = fin != fout
        self.conv_0 = _conv(fin, fmiddle)
        self.conv_1 = _conv(fmiddle, fout)
        if self.learned_shortcut:
            self.conv_s = _conv(fin, fout, 1, bias=False, padding=0)
        self.norm_0 = SPADE(fin, semantic_nc)
        self.norm_1 = SPADE(fmiddle, semantic_nc)
        if self.learned_shortcut:
            self.norm_s = SPADE(fin, semantic_nc)

    def forward(self, x, seg):
        x_s = (self.conv_s(self.norm_s(x, seg)) if self.learned_shortcut
               else x)
        dx = self.conv_0(lrelu2(self.norm_0(x, seg)))
        dx = self.conv_1(lrelu2(self.norm_1(dx, seg)))
        return x_s + dx


# ---------------------------------------------------------------------------
# LIP encoder
# ---------------------------------------------------------------------------

class SimplifiedLIP(nn.Module):
    """LIP pooling whose logit is conv -> affine instance norm -> 12 x
    sigmoid (``logit.0`` the conv, ``logit.1`` the norm's weight / bias)."""

    def __init__(self, channels):
        super().__init__()
        self.logit = nn.Sequential(
            _conv(channels, channels, bias=False),
            nn.InstanceNorm2d(channels, affine=True))

    def forward(self, x):
        conv, norm = self.logit
        h = instance_norm(conv(x)) * norm.weight.view(1, -1, 1, 1) \
            + norm.bias.view(1, -1, 1, 1)
        return lip2d(x, 12.0 * torch.sigmoid(h))


class LIPEncoder(nn.Module):
    """conv -> norm -> relu, then ``n_2xdown`` x (LIP, conv, norm, relu
    but after the last); the BasicSR Sequential's indices: conv 0, the
    LIP of block i at 3 + 4i, its conv at 4 + 4i."""

    def __init__(self, input_nc, ngf, n_2xdown):
        super().__init__()
        self.n_2xdown = n_2xdown
        model = {'0': _conv(input_nc, ngf, bias=False)}
        cur = 1
        for i in range(n_2xdown):
            nxt = min(cur * 2, 16)
            model[str(3 + 4 * i)] = SimplifiedLIP(ngf * cur)
            model[str(4 + 4 * i)] = _conv(ngf * cur, ngf * nxt)
            cur = nxt
        self.model = nn.ModuleDict(model)

    def forward(self, x):
        m = self.model
        x = F.relu(instance_norm(m['0'](x)))
        for i in range(self.n_2xdown):
            x = m[str(3 + 4 * i)](x)
            x = instance_norm(m[str(4 + 4 * i)](x))
            if i < self.n_2xdown - 1:
                x = F.relu(x)
        return x


# ---------------------------------------------------------------------------
# generator
# ---------------------------------------------------------------------------

@ARCH_REGISTRY.register()
class HiFaceGAN(nn.Module):
    """LQ (N, 3, H, W) -> (N, 3, H, W) tanh output; H and W multiples of
    32. ``phase`` is 4 (the full net) when ``is_train`` is false, else
    ``init_train_phase + 1``; the other options are accepted and unused,
    as in the JAX package."""

    def __init__(self, num_in_ch=3, num_feat=64, use_vae=False, z_dim=256,
                 crop_size=512, norm_g='spectralspadesyncbatch3x3',
                 is_train=True, init_train_phase=3, seed=0):
        super().__init__()
        del use_vae, z_dim, crop_size, norm_g
        nf = num_feat
        self.scale_ratio = 5
        self.phase = (init_train_phase + 1) if is_train else 4
        self.lip_encoder = LIPEncoder(num_in_ch, nf, self.scale_ratio)
        self.head_0 = SPADEResnetBlock(16 * nf, 16 * nf, num_in_ch)
        self.g_middle_0 = SPADEResnetBlock(16 * nf, 16 * nf, num_in_ch)
        self.g_middle_1 = SPADEResnetBlock(16 * nf, 16 * nf, num_in_ch)
        self.ups = nn.ModuleList([
            SPADEResnetBlock(16 * nf, 8 * nf, num_in_ch),
            SPADEResnetBlock(8 * nf, 4 * nf, num_in_ch),
            SPADEResnetBlock(4 * nf, 2 * nf, num_in_ch),
            SPADEResnetBlock(2 * nf, nf, num_in_ch)])
        self.to_rgbs = nn.ModuleList([_conv((8 >> i) * nf, 3)
                                      for i in range(4)])
        _Init(seed).all_kaiming(self)

    def forward(self, x):
        seg = x
        h = self.lip_encoder(x)
        h = self.head_0(h, seg)
        h = F.interpolate(h, scale_factor=2, mode='nearest')
        h = self.g_middle_0(h, seg)
        h = self.g_middle_1(h, seg)
        for i in range(self.phase):
            h = F.interpolate(h, scale_factor=2, mode='nearest')
            h = self.ups[i](h, seg)
        return torch.tanh(self.to_rgbs[self.phase - 1](lrelu2(h)))


# ---------------------------------------------------------------------------
# multiscale discriminator
# ---------------------------------------------------------------------------

class NLayerDiscriminator(nn.Module):
    """4 x 4 convs: ``model0`` (stride 2, lrelu), ``model1`` ..
    ``model{n-1}`` (conv without bias, instance norm, lrelu; stride 1 in
    the last), ``model{n}`` (1 channel); each layer's output a feature."""

    def __init__(self, input_nc, n_layers_d=4, num_feat=64,
                 spectral_norm=True):
        super().__init__()
        self.n_layers_d = n_layers_d
        # (cin, cout, stride, bias) of each conv, by state-dict path
        nf = num_feat
        specs = {'model0.0': (input_nc, nf, 2, True)}
        for n in range(1, n_layers_d):
            nf_prev, nf = nf, min(nf * 2, 512)
            stride = 1 if n == n_layers_d - 1 else 2
            specs[f'model{n}.0.0'] = (nf_prev, nf, stride, False)
        specs[f'model{n_layers_d}.0'] = (nf, 1, 1, True)
        self.specs = specs
        conv = [self._conv(spec, spectral_norm) for spec in specs.values()]
        self.model0 = nn.Sequential(conv[0])
        for n in range(1, n_layers_d):
            setattr(self, f'model{n}', nn.Sequential(nn.Sequential(conv[n])))
        setattr(self, f'model{n_layers_d}', nn.Sequential(conv[-1]))

    @staticmethod
    def _conv(spec, spectral_norm):
        cin, cout, stride, bias = spec
        if spectral_norm:
            return SNConv2d(cin, cout, 4, stride, 2, bias=bias)
        return nn.Conv2d(cin, cout, 4, stride, 2, bias=bias)

    def match_state(self, state, prefix=''):
        """Make each conv the kind that ``state`` holds: a spectral-norm
        conv where it has ``weight_orig`` (and ``u``), a plain conv where
        it has a ``weight`` with sigma folded in (the JAX package picks
        the same by whether the tree has ``u``)."""
        for path, conv in list(self.convs()):
            key = f'{prefix}{path}'
            if f'{key}.weight' in state:
                spectral = False
            elif f'{key}.weight_orig' in state:
                spectral = True
            else:
                continue
            if spectral != isinstance(conv, SNConv2d):
                like = next(conv.parameters())
                new = self._conv(self.specs[path], spectral).to(like)
                parent, name = path.rsplit('.', 1)
                setattr(self.get_submodule(parent), name, new)

    def convs(self):
        """(state-dict path, conv) of each layer, in order."""
        yield 'model0.0', self.model0[0]
        for n in range(1, self.n_layers_d):
            yield f'model{n}.0.0', getattr(self, f'model{n}')[0][0]
        yield (f'model{self.n_layers_d}.0',
               getattr(self, f'model{self.n_layers_d}')[0])

    def forward_stats(self, x, prefix=''):
        """(features of every layer, {path: (u, v)} of the spectral-norm
        convs' power iteration in this forward)."""
        us, feats, h = {}, [], x
        for n, (path, conv) in enumerate(self.convs()):
            if isinstance(conv, SNConv2d):
                h, us[prefix + path] = conv.forward_u(h)
            else:
                h = conv(h)
            if 0 < n < self.n_layers_d:
                h = instance_norm(h)
            if n < self.n_layers_d:
                h = lrelu2(h)
            feats.append(h)
        return feats, us


@ARCH_REGISTRY.register()
class HiFaceGANDiscriminator(nn.Module):
    """``num_d`` N-layer discriminators, each on the input average-pooled
    once more than the last; input channels ``num_in_ch`` (+
    ``num_out_ch`` when ``conditional_d``). Output: per discriminator the
    list of its features (``keep_features``) or its last."""

    def __init__(self, num_in_ch=3, num_out_ch=3, conditional_d=True,
                 num_d=2, n_layers_d=4, num_feat=64,
                 norm_d='spectralinstance', keep_features=True, seed=0):
        super().__init__()
        del norm_d
        self.num_d = num_d
        self.keep_features = keep_features
        input_nc = num_in_ch + (num_out_ch if conditional_d else 0)
        for i in range(num_d):
            self.add_module(f'discriminator_{i}', NLayerDiscriminator(
                input_nc, n_layers_d, num_feat))
        init = _Init(seed)
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, SNConv2d)):
                init.kaiming(m)
            if isinstance(m, SNConv2d):
                with torch.no_grad():
                    m.weight_u.copy_(torch.randn(m.weight_u.shape,
                                                 generator=init.gen))

    def forward_stats(self, x, train=False):
        """(outputs, {path: (u, v)}): the power iteration's new vectors of
        this forward (in either mode; not stored)."""
        del train
        result, us = [], {}
        for i in range(self.num_d):
            feats, u = getattr(self, f'discriminator_{i}').forward_stats(
                x, f'discriminator_{i}.')
            result.append(feats if self.keep_features else feats[-1])
            us.update(u)
            x = avg_pool_excl(x)
        return result, us

    def forward(self, x):
        return self.forward_stats(x)[0]

    def load_state_dict(self, state_dict, strict=True, assign=False):
        """As ``nn.Module``'s, each conv first made the kind the state
        holds (``NLayerDiscriminator.match_state``)."""
        for i in range(self.num_d):
            getattr(self, f'discriminator_{i}').match_state(
                state_dict, f'discriminator_{i}.')
        return super().load_state_dict(state_dict, strict, assign)

    def update_state(self, us):
        """Store a forward's power-iteration vectors (the JAX engine's
        ``sn_aux_fold``)."""
        for path, uv in us.items():
            self.get_submodule(path).store(uv)
