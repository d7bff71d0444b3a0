"""Differentiable JPEG on torch tensors (counterpart of
bsvd_tpu/utils/diffjpeg.py; BasicSR's diffjpeg, from mlomnitz/DiffJPEG).

RGB -> YCbCr -> 2x2 chroma mean -> 8x8 blocks -> DCT -> divide by the
quality-scaled tables -> round -> multiply back -> IDCT -> merge -> chroma
upsampled with the reference's layout (each value tiled 2 x 2 along the
row, then the rows reshaped: behaviour, copied as it is) -> RGB. The
image is zero-padded to multiples of 16 and cropped back. ``quality`` is
a number or one per sample, shape (N,).

``differentiable`` rounds with ``diff_round`` (round(x) + (x - round x)^3,
whose gradient through autograd is 3 (x - round x)^2: ``torch.round``'s
is 0, as ``jnp.round``'s) or else with ``torch.round``. Plain PyTorch on
the caller's device (JAX's is a tensordot in XLA, no Pallas kernel); the
constants are float32 values cast to the input's dtype.
"""

import functools
import itertools

import numpy as np
import torch

Y_TABLE = np.array(
    [[16, 11, 10, 16, 24, 40, 51, 61], [12, 12, 14, 19, 26, 58, 60, 55],
     [14, 13, 16, 24, 40, 57, 69, 56], [14, 17, 22, 29, 51, 87, 80, 62],
     [18, 22, 37, 56, 68, 109, 103, 77], [24, 35, 55, 64, 81, 104, 113, 92],
     [49, 64, 78, 87, 103, 121, 120, 101], [72, 92, 95, 98, 112, 100, 103, 99]],
    dtype=np.float32).T

C_TABLE = np.full((8, 8), 99, dtype=np.float32)
C_TABLE[:4, :4] = np.array([[17, 18, 24, 47], [18, 21, 26, 66],
                            [24, 26, 56, 99], [47, 66, 99, 99]],
                           dtype=np.float32).T

_DCT = np.zeros((8, 8, 8, 8), dtype=np.float32)
for _x, _y, _u, _v in itertools.product(range(8), repeat=4):
    _DCT[_x, _y, _u, _v] = (np.cos((2 * _x + 1) * _u * np.pi / 16) *
                            np.cos((2 * _y + 1) * _v * np.pi / 16))
_ALPHA = np.outer(np.array([1. / np.sqrt(2)] + [1] * 7),
                  np.array([1. / np.sqrt(2)] + [1] * 7)).astype(np.float32)
_IDCT = np.ascontiguousarray(np.transpose(_DCT, (2, 3, 0, 1)))
_CONSTS = {
    'dct': _DCT, 'idct': _IDCT, 'alpha': _ALPHA, 'alpha_dct': _ALPHA * 0.25,
    'rgb2ycc': np.array([[0.299, 0.587, 0.114], [-0.168736, -0.331264, 0.5],
                         [0.5, -0.418688, -0.081312]], np.float32).T,
    'ycc2rgb': np.array([[1., 0., 1.402], [1, -0.344136, -0.714136],
                         [1, 1.772, 0]], np.float32).T,
    'ycc_offset': np.array([0., 128., 128.], np.float32),
    'y': Y_TABLE, 'cb': C_TABLE, 'cr': C_TABLE}


@functools.lru_cache(maxsize=64)
def _const(name, device, dtype):
    """A constant on ``device`` in ``dtype``, copied there once (a copy
    from host memory each call would wait for the device)."""
    return torch.as_tensor(_CONSTS[name], device=device).to(dtype)


def _like(name, x):
    return _const(name, x.device, x.dtype)


def diff_round(x):
    return torch.round(x) + (x - torch.round(x)) ** 3


def quality_to_factor(quality):
    """JPEG quality (a number or a tensor) -> the tables' scale."""
    quality = torch.as_tensor(quality, dtype=torch.float32)
    q = torch.where(quality < 50, 5000. / quality, 200. - quality * 2)
    return q / 100.


def _rgb2ycbcr(img):
    return img @ _like('rgb2ycc', img) + _like('ycc_offset', img)


def _ycbcr2rgb(img):
    return (img - _like('ycc_offset', img)) @ _like('ycc2rgb', img)


def _block_split(img):
    b, h, w = img.shape
    x = img.reshape(b, h // 8, 8, w // 8, 8)
    return x.permute(0, 1, 3, 2, 4).reshape(b, -1, 8, 8)


def _block_merge(patches, h, w):
    b = patches.shape[0]
    x = patches.reshape(b, h // 8, w // 8, 8, 8)
    return x.permute(0, 1, 3, 2, 4).reshape(b, h, w)


def _dct(blocks):
    x = blocks - 128.
    return _like('alpha_dct', x) * torch.tensordot(x, _like('dct', x),
                                                    dims=2)


def _idct(blocks):
    x = blocks * _like('alpha', blocks)
    return 0.25 * torch.tensordot(x, _like('idct', x), dims=2) + 128.


def _chroma_subsample(ycc):
    """(B, H, W, 3) -> y (B, H, W), cb / cr (B, H/2, W/2) (2x2 mean)."""
    def pool(c):
        b, h, w = c.shape
        return c.reshape(b, h // 2, 2, w // 2, 2).mean(dim=(2, 4))
    return ycc[..., 0], pool(ycc[..., 1]), pool(ycc[..., 2])


def _chroma_upsample(y, cb, cr):
    def repeat(x, k=2):
        b, h, w = x.shape
        x = x[..., None].repeat(1, 1, k, k)        # (b, h, w*k, k)
        return x.reshape(b, h * k, w * k)          # reference layout quirk
    return torch.stack([y, repeat(cb), repeat(cr)], dim=-1)


def _tables(quality, x):
    """{component: its quantisation table x the quality's factor}, (N or 1,
    1, 8, 8), computed in float32 (as the JAX package does, also under
    x64) and cast to ``x``'s dtype."""
    factor = quality_to_factor(quality).to(x.device).reshape(-1, 1, 1, 1)
    return {name: (_const(name, x.device, torch.float32) * factor).to(x.dtype)
            for name in ('y', 'cb', 'cr')}


def compress(x, quality, rounding=diff_round):
    """The quantised DCT coefficients {'y', 'cb', 'cr'}: (N, blocks, 8, 8)
    of NHWC RGB ``x`` in [0, 1] whose H and W are multiples of 16."""
    q = _tables(quality, x)
    y, cb, cr = _chroma_subsample(_rgb2ycbcr(x * 255.))
    return {name: rounding(_dct(_block_split(comp)) / q[name])
            for name, comp in (('y', y), ('cb', cb), ('cr', cr))}


def decompress(comps, quality, h, w):
    """``compress``'s coefficients -> NHWC RGB in [0, 1], (N, h, w, 3)."""
    q = _tables(quality, comps['y'])
    out = {}
    for name in ('y', 'cb', 'cr'):
        deq = comps[name] * q[name]
        hh, ww = (h, w) if name == 'y' else (h // 2, w // 2)
        out[name] = _block_merge(_idct(deq), hh, ww)
    img = _ycbcr2rgb(_chroma_upsample(out['y'], out['cb'], out['cr']))
    return torch.clamp(img, 0., 255.) / 255.


def diff_jpeg(x, quality, differentiable=True):
    """JPEG round trip of NHWC RGB ``x`` in [0, 1], any H and W; ``quality``
    a number or (N,) in (0, 100]. Returns (N, H, W, 3) in [0, 1]."""
    rounding = diff_round if differentiable else torch.round
    _, h, w, _ = x.shape
    h_pad = (16 - h % 16) % 16
    w_pad = (16 - w % 16) % 16
    x = torch.nn.functional.pad(x, (0, 0, 0, w_pad, 0, h_pad))
    img = decompress(compress(x, quality, rounding), quality, h + h_pad,
                     w + w_pad)
    return img[:, :h, :w]


class DiffJPEG:
    """The reference's wrapper: NCHW in and out."""

    def __init__(self, differentiable=True):
        self.differentiable = differentiable

    def __call__(self, x, quality):
        y = diff_jpeg(x.permute(0, 2, 3, 1), quality, self.differentiable)
        return y.permute(0, 3, 1, 2)
