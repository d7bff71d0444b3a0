"""SwinIR, image restoration with a Swin Transformer (counterpart of
bsvd_tpu/archs/swinir_arch.py), as an ``nn.Module`` with BasicSR's
parameter names (``layers.N.residual_group.blocks.M.attn.qkv``,
``conv_after_body``, ``conv_before_upsample.0``, ``upsample.0``, ...), so a
released SwinIR ``.pth`` loads through ``convert.torch_generic
.load_torch_generic`` and a JAX tree through ``from_jax_tree``.

The function is the JAX package's, not torch SwinIR's where they part:

- a block whose image has ``min(h, w) <= window_size`` attends in one
  window of side ``min(h, w)`` with no shift, decided at run time from
  the image (torch SwinIR decides it once, from ``img_size``, at
  construction); the relative position index is then that of the shrunk
  window, into the full window's table;
- the relative position index and the SW-MSA mask are not buffers: they
  are computed from the shapes and cached per (h, w, window, shift,
  device), never rebuilt on the host per block. A released checkpoint's
  ``relative_position_index`` / ``attn_mask`` entries are ignored on load;
- ``forward`` pads H and W to window multiples by reflection, numpy's
  rule (reflected again where the pad reaches past the far side: a side
  of 3 padded by 5 reads 0 1 2 1 0 1 2 1), runs, and crops back.

Dropout and stochastic depth are identity, as in JAX. Everything is
plain PyTorch on the caller's device (the JAX package computes SwinIR in
XLA einsums, no Pallas kernel). Layout is NCHW at the module's edges and
(B, H*W, C) tokens inside.

Initialisation follows the JAX families on a seeded ``torch.Generator``
(not its values): linear weights and the bias tables truncated normal
(std 0.02, cut at 2 std), zero linear biases, unit LayerNorms,
kaiming-normal convs with torch's uniform bias.
"""

import functools
import itertools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from bsvd_tpu_torch.archs.sr_archs import Upsample, _conv, _Init, lrelu
from bsvd_tpu_torch.utils.registry import ARCH_REGISTRY

LN_EPS = 1e-5
# the RGB mean SwinIR subtracts (BasicSR's DIV2K mean)
RGB_MEAN = (0.4488, 0.4371, 0.4040)
# the upsamplers' width, fixed as in BasicSR and the JAX package
NUM_FEAT = 64


def window_partition(x, ws):
    """(B, H, W, C) -> (B * nW, ws, ws, C), windows in (b, row, col)
    order."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, c)


def window_reverse(windows, ws, h, w):
    """The inverse of ``window_partition``: -> (B, H, W, C)."""
    b = windows.shape[0] // ((h // ws) * (w // ws))
    x = windows.reshape(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


def relative_position_index_np(ws):
    """(ws*ws, ws*ws) int64 index into the (2ws-1)^2-row bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing='ij'))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0).copy()
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


@functools.lru_cache(maxsize=8)
def _relative_position_index(ws, device):
    return torch.as_tensor(relative_position_index_np(ws).reshape(-1),
                           device=device)


def attn_mask_np(h, w, ws, shift):
    """The SW-MSA mask, (nW, ws*ws, ws*ws) float32: -100 between tokens of
    different regions of the shifted image, else 0."""
    img_mask = np.zeros((1, h, w, 1))
    slices = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    for cnt, (hs, wsl) in enumerate(itertools.product(slices, slices)):
        img_mask[:, hs, wsl] = cnt
    mw = img_mask.reshape(1, h // ws, ws, w // ws, ws, 1).transpose(
        0, 1, 3, 2, 4, 5).reshape(-1, ws * ws)
    mask = mw[:, None, :] - mw[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


# a 680 x 1024 image's mask at window 8 holds 178 MB: a few sizes at most
@functools.lru_cache(maxsize=4)
def _attn_mask(h, w, ws, shift, device):
    return torch.as_tensor(attn_mask_np(h, w, ws, shift), device=device)


def reflect_index(n, pad):
    """Indices of a side of ``n`` padded at its end by ``pad`` with numpy's
    'reflect' (the edge not repeated, reflected again past the far
    side)."""
    idx = np.arange(n + pad)
    if n == 1:
        return np.zeros_like(idx)
    period = 2 * (n - 1)
    idx = idx % period
    return np.where(idx >= n, period - idx, idx)


def reflect_pad_end(x, ph, pw):
    """NCHW x padded by ``ph`` rows at the bottom and ``pw`` columns at the
    right, numpy's 'reflect' at any pad (``F.pad`` raises where a pad
    reaches the side)."""
    h, w = x.shape[2], x.shape[3]
    if ph:
        x = x[:, :, torch.as_tensor(reflect_index(h, ph), device=x.device)]
    if pw:
        x = x[:, :, :, torch.as_tensor(reflect_index(w, pw),
                                       device=x.device)]
    return x


class WindowAttention(nn.Module):
    """Multi-head self-attention within windows, with a relative position
    bias and, for shifted windows, the SW-MSA mask added per window."""

    def __init__(self, dim, window_size, num_heads):
        super().__init__()
        self.num_heads = num_heads
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, ws, mask=None):
        """x: (B_, N, C) windows of side ``ws``; mask: (nW, N, N) or
        None."""
        b_, n, c = x.shape
        nh = self.num_heads
        hd = c // nh
        qkv = self.qkv(x).reshape(b_, n, 3, nh, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = (q * hd ** -0.5) @ k.transpose(-2, -1)       # (B_, nH, N, N)
        idx = _relative_position_index(ws, x.device)
        bias = self.relative_position_bias_table[idx].reshape(n, n, nh)
        attn = attn + bias.permute(2, 0, 1)[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.reshape(b_ // nw, nw, nh, n, n)
                    + mask[None, :, None].to(attn.dtype))
            attn = attn.reshape(-1, nh, n, n)
        attn = torch.softmax(attn, dim=-1)
        return self.proj((attn @ v).transpose(1, 2).reshape(b_, n, c))


class Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate='none'))


class SwinTransformerBlock(nn.Module):
    """LN -> (shifted) window attention -> residual, LN -> MLP ->
    residual."""

    def __init__(self, dim, num_heads, window_size, shift_size, mlp_ratio):
        super().__init__()
        self.window_size = window_size
        self.shift_size = shift_size
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttention(dim, window_size, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x, x_size):
        h, w = x_size
        b, _, c = x.shape
        ws, shift = self.window_size, self.shift_size
        if min(h, w) <= ws:
            shift, ws = 0, min(h, w)
        shortcut = x
        x = self.norm1(x).reshape(b, h, w, c)
        if shift > 0:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
        xw = window_partition(x, ws).reshape(-1, ws * ws, c)
        mask = _attn_mask(h, w, ws, shift, x.device) if shift > 0 else None
        aw = self.attn(xw, ws, mask)
        x = window_reverse(aw.reshape(-1, ws, ws, c), ws, h, w)
        if shift > 0:
            x = torch.roll(x, (shift, shift), dims=(1, 2))
        x = shortcut + x.reshape(b, h * w, c)
        return x + self.mlp(self.norm2(x))


class BasicLayer(nn.Module):
    def __init__(self, dim, depth, num_heads, window_size, mlp_ratio):
        super().__init__()
        self.blocks = nn.ModuleList([
            SwinTransformerBlock(dim, num_heads, window_size,
                                 0 if i % 2 == 0 else window_size // 2,
                                 mlp_ratio) for i in range(depth)])

    def forward(self, x, x_size):
        for blk in self.blocks:
            x = blk(x, x_size)
        return x


def _resi_conv(dim, resi_connection):
    """'1conv': one 3x3 conv; '3conv': 3x3 -> lrelu 0.2 -> 1x1 -> lrelu 0.2
    -> 3x3 through dim / 4 channels (children '0', '2', '4')."""
    if resi_connection == '1conv':
        return _conv(dim, dim)
    if resi_connection == '3conv':
        return nn.Sequential(_conv(dim, dim // 4), nn.LeakyReLU(0.2),
                             _conv(dim // 4, dim // 4, 1),
                             nn.LeakyReLU(0.2), _conv(dim // 4, dim))
    raise ValueError(f'resi_connection {resi_connection!r}: 1conv or 3conv')


def _tokens(img):
    b, c, h, w = img.shape
    return img.reshape(b, c, h * w).transpose(1, 2)


def _image(tokens, h, w):
    b, _, c = tokens.shape
    return tokens.transpose(1, 2).reshape(b, c, h, w)


class RSTB(nn.Module):
    """Residual Swin Transformer block: the blocks, then the residual
    conv on the image, plus the input."""

    def __init__(self, dim, depth, num_heads, window_size, mlp_ratio,
                 resi_connection):
        super().__init__()
        self.residual_group = BasicLayer(dim, depth, num_heads, window_size,
                                         mlp_ratio)
        self.conv = _resi_conv(dim, resi_connection)

    def forward(self, x, x_size):
        h, w = x_size
        y = self.residual_group(x, x_size)
        return _tokens(self.conv(_image(y, h, w))) + x


class _PatchNorm(nn.Module):
    """The patch embedding's LayerNorm (``patch_embed.norm``)."""

    def __init__(self, dim):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, x):
        return self.norm(x)


@ARCH_REGISTRY.register()
class SwinIR(nn.Module):
    """NCHW in [0, 1] -> NCHW at ``upscale`` (any H, W: padded to window
    multiples and cropped back). ``upsampler``: 'pixelshuffle' (classical
    SR), 'pixelshuffledirect' (lightweight SR), 'nearest+conv' (real SR,
    x4) or '' (denoising / JPEG, the input added back)."""

    def __init__(self, img_size=64, patch_size=1, in_chans=3, embed_dim=96,
                 depths=(6, 6, 6, 6), num_heads=(6, 6, 6, 6), window_size=7,
                 mlp_ratio=4., upscale=2, img_range=1., upsampler='',
                 resi_connection='1conv', seed=0, **kwargs):
        super().__init__()
        del img_size, patch_size, kwargs
        num_feat = NUM_FEAT
        self.in_chans = in_chans
        self.window_size = window_size
        self.upscale = upscale
        self.img_range = img_range
        self.upsampler = upsampler
        self.num_heads = tuple(num_heads)
        mean = RGB_MEAN if in_chans == 3 else (0.0,)
        self.register_buffer('mean', torch.tensor(mean).view(1, -1, 1, 1),
                             persistent=False)
        self.conv_first = _conv(in_chans, embed_dim)
        self.patch_embed = _PatchNorm(embed_dim)
        self.layers = nn.ModuleList([
            RSTB(embed_dim, depths[i], num_heads[i], window_size, mlp_ratio,
                 resi_connection) for i in range(len(depths))])
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.conv_after_body = _resi_conv(embed_dim, resi_connection)
        if upsampler == 'pixelshuffle':
            self.conv_before_upsample = nn.Sequential(
                _conv(embed_dim, num_feat), nn.LeakyReLU(0.01))
            self.upsample = Upsample(upscale, num_feat)
            self.conv_last = _conv(num_feat, in_chans)
        elif upsampler == 'pixelshuffledirect':
            self.upsample = nn.Sequential(
                _conv(embed_dim, in_chans * upscale * upscale),
                nn.PixelShuffle(upscale))
        elif upsampler == 'nearest+conv':
            self.conv_before_upsample = nn.Sequential(
                _conv(embed_dim, num_feat), nn.LeakyReLU(0.01))
            self.conv_up1 = _conv(num_feat, num_feat)
            self.conv_up2 = _conv(num_feat, num_feat)
            self.conv_hr = _conv(num_feat, num_feat)
            self.conv_last = _conv(num_feat, in_chans)
        elif upsampler == '':
            self.conv_last = _conv(embed_dim, in_chans)
        else:
            raise ValueError(f'upsampler {upsampler!r}')
        self._init_weights(seed)

    def _init_weights(self, seed):
        init = _Init(seed)
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                init.kaiming(m)
            elif isinstance(m, nn.Linear):
                self._trunc_normal(m.weight, init.gen)
                nn.init.zeros_(m.bias)
            elif isinstance(m, WindowAttention):
                self._trunc_normal(m.relative_position_bias_table, init.gen)

    @staticmethod
    def _trunc_normal(t, gen, std=0.02):
        with torch.no_grad():
            t.copy_(nn.init.trunc_normal_(torch.empty(t.shape), 0.0, std,
                                          -2 * std, 2 * std, generator=gen))

    def forward_features(self, x):
        h, w = x.shape[2], x.shape[3]
        tokens = self.patch_embed(_tokens(x))
        for layer in self.layers:
            tokens = layer(tokens, (h, w))
        return _image(self.norm(tokens), h, w)

    def _body(self, feat):
        return self.conv_after_body(self.forward_features(feat)) + feat

    def apply_padded(self, x):
        """The net on NCHW ``x`` whose H and W are window multiples."""
        mean = self.mean.to(x.dtype)
        x = (x - mean) * self.img_range
        if self.upsampler == 'pixelshuffle':
            feat = self.conv_before_upsample(self._body(self.conv_first(x)))
            out = self.conv_last(self.upsample(feat))
        elif self.upsampler == 'pixelshuffledirect':
            out = self.upsample(self._body(self.conv_first(x)))
        elif self.upsampler == 'nearest+conv':
            feat = self.conv_before_upsample(self._body(self.conv_first(x)))
            feat = lrelu(self.conv_up1(
                F.interpolate(feat, scale_factor=2, mode='nearest')), 0.2)
            feat = lrelu(self.conv_up2(
                F.interpolate(feat, scale_factor=2, mode='nearest')), 0.2)
            out = self.conv_last(lrelu(self.conv_hr(feat), 0.2))
        else:
            out = x + self.conv_last(self._body(self.conv_first(x)))
        return out / self.img_range + mean

    def forward(self, x):
        h, w = x.shape[2], x.shape[3]
        ws = self.window_size
        x = reflect_pad_end(x, (ws - h % ws) % ws, (ws - w % ws) % ws)
        y = self.apply_padded(x)
        return y[:, :, :h * self.upscale, :w * self.upscale]

