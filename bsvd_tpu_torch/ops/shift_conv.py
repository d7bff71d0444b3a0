"""Temporal-shift conv sites (counterpart of bsvd_tpu/ops/shift_conv.py
``shift_conv`` / ``shift_conv_add2`` / ``_shift_conv_fused_v1``): thin
wrappers over K1 ``conv3x3`` with a shift, so they launch (and count) the
same kernel. They are differentiable through K1's autograd Function, whose
backward is shift_conv.py's ``_sc_bwd`` / ``_sca_bwd`` (``act_mask`` is
re-exported from ``ops._pack``, where every backward shares it)."""

from bsvd_tpu_torch.ops._pack import act_mask  # noqa: F401
from bsvd_tpu_torch.ops.conv3x3 import conv3x3


def shift_conv_fused_v1(x, w, b, *, t_len, fold_div=8, act='relu6',
                        causal=False):
    """The entry of bsvd_tpu/ops/shift_conv.py ``_shift_conv_fused_v1``:
    temporal shift + 3x3 conv + bias + act with no second input. Its
    generation-1 TPU design (three serialized tile DMAs and a full-tile
    select) is Mosaic scheduling and is not ported: it launches K1, and
    ``shift_conv_fused_v1.launches`` counts the K1 launches made through
    it (``conv3x3.launches`` counts them too)."""
    y = conv3x3(x, w, b, t_len=t_len, shift='causal' if causal else 'tsm',
                fold_div=fold_div, act=act)
    if x.device.type == 'cuda':
        shift_conv_fused_v1.launches += 1
    return y


shift_conv_fused_v1.launches = 0


def shift_conv(x, w, b, t_len, fold_div=8, act='relu6', causal=False):
    """Fused temporal shift + 3x3 conv + bias + act over (N*T, H, W, C)."""
    return shift_conv_fused_v1(x, w, b, t_len=t_len, fold_div=fold_div,
                               act=act, causal=causal)


def shift_conv_add2(x, x2, w, b, t_len, fold_div=8, act='relu6',
                    causal=False):
    """shift_conv of (x + x2), the sum taken as the tile is loaded."""
    return conv3x3(x, w, b, x2=x2, t_len=t_len,
                   shift='causal' if causal else 'tsm', fold_div=fold_div,
                   act=act)
