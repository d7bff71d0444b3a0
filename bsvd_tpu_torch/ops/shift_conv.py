"""Temporal-shift conv sites (counterpart of bsvd_tpu/ops/shift_conv.py
``shift_conv`` / ``shift_conv_add2``): thin wrappers over K1 ``conv3x3``
with a shift, so they launch (and count) the same kernel."""

from bsvd_tpu_torch.ops.conv3x3 import conv3x3


def shift_conv(x, w, b, t_len, fold_div=8, act='relu6', causal=False):
    """Fused temporal shift + 3x3 conv + bias + act over (N*T, H, W, C)."""
    return conv3x3(x, w, b, t_len=t_len, shift='causal' if causal else 'tsm',
                   fold_div=fold_div, act=act)


def shift_conv_add2(x, x2, w, b, t_len, fold_div=8, act='relu6',
                    causal=False):
    """shift_conv of (x + x2), the sum taken as the tile is loaded."""
    return conv3x3(x, w, b, x2=x2, t_len=t_len,
                   shift='causal' if causal else 'tsm', fold_div=fold_div,
                   act=act)
