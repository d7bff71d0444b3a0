"""StyleGAN2's fused bias + LeakyReLU and up-pad-FIR-down filter in plain
PyTorch, NCHW (counterpart of bsvd_tpu/ops/stylegan_ops.py, which replaces
BasicSR's ``fused_act`` / ``upfirdn2d`` CUDA extensions by XLA; it has no
Pallas kernel, so neither has the port).

``upfirdn2d`` follows the JAX function's rules:

- the upsample puts ``up - 1`` zeros after every sample (BasicSR's
  zero-stuffing; the JAX version extends the high pad by ``up - 1`` for
  the same result);
- the FIR kernel is flipped (a true convolution, as ``upfirdn2d``);
- pads are ``(pad0, pad1)`` on both spatial dims or ``(pad_x0, pad_x1,
  pad_y0, pad_y1)``, and may be negative (a crop).

Every op is differentiable twice (R1 and path-length penalties take
``create_graph`` gradients through them).
"""

import torch
import torch.nn.functional as F


def fused_leaky_relu(x, bias=None, negative_slope=0.2, scale=2 ** 0.5):
    """(x + bias) -> LeakyReLU -> x scale; ``bias`` is per channel (dim
    1)."""
    if bias is not None:
        x = x + bias.to(x.dtype).view(1, -1, *([1] * (x.ndim - 2)))
    return F.leaky_relu(x, negative_slope) * scale


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def upfirdn2d(x, kernel, up=1, down=1, pad=(0, 0)):
    """Upsample (zero-stuff) -> pad -> FIR filter -> downsample of
    (N, C, H, W) by the 2-D ``kernel``; ``up`` / ``down`` an int or (y,
    x)."""
    up_y, up_x = _pair(up)
    down_y, down_x = _pair(down)
    if len(pad) == 2:
        pad_x0 = pad_y0 = pad[0]
        pad_x1 = pad_y1 = pad[1]
    else:
        pad_x0, pad_x1, pad_y0, pad_y1 = pad
    n, c, h, w = x.shape
    if up_y > 1 or up_x > 1:
        x = F.pad(x.reshape(n, c, h, 1, w, 1),
                  (0, up_x - 1, 0, 0, 0, up_y - 1))
        x = x.reshape(n, c, h * up_y, w * up_x)
    x = F.pad(x, (pad_x0, pad_x1, pad_y0, pad_y1))
    k = torch.as_tensor(kernel, dtype=x.dtype, device=x.device)
    # every channel an image of its own, through one 1-channel conv
    out = F.conv2d(x.reshape(n * c, 1, *x.shape[2:]),
                   k.flip(0, 1)[None, None], stride=(down_y, down_x))
    return out.reshape(n, c, *out.shape[2:])


def make_resample_kernel(k):
    """A 1-D list (outer product with itself) or 2-D kernel, normalised to
    sum 1, as a float32 tensor."""
    k = torch.as_tensor(k, dtype=torch.float32)
    if k.ndim == 1:
        k = k[None, :] * k[:, None]
    return k / k.sum()


def upsample(x, kernel, factor=2):
    k = kernel * (factor ** 2)
    p = kernel.shape[0] - factor
    return upfirdn2d(x, k, up=factor, down=1,
                     pad=((p + 1) // 2 + factor - 1, p // 2))


def downsample(x, kernel, factor=2):
    p = kernel.shape[0] - factor
    return upfirdn2d(x, kernel, up=1, down=factor,
                     pad=((p + 1) // 2, p // 2))
