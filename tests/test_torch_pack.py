"""Host-side layout and launch plans of the port's kernels, on the CPU: the
sub-pixel-major weight pack of K4 and the pixel-tile plan of K7."""

import pytest
import torch

from bsvd_tpu_torch.ops._pack import ConvWeights, ps_order
from bsvd_tpu_torch.ops.conv3x3 import dw_plan, dw_split_tiles
from torch_threads import one_torch_thread  # noqa: F401


def test_ps_order_maps_rows_to_sub_pixels():
    """Packed row s * c4 + k is torch channel k * 4 + s."""
    c4 = 6
    order = ps_order(4 * c4).tolist()
    assert sorted(order) == list(range(4 * c4))
    for s in range(4):
        for k in range(c4):
            assert order[s * c4 + k] == k * 4 + s


def test_ps_pack_is_renewed_after_an_in_place_update():
    """An optimizer step changes weight and bias in place: the next pack
    in either order holds the new values, each order under its own key."""
    g = torch.Generator().manual_seed(0)
    w = torch.randn((64, 8, 3, 3), generator=g)
    b = torch.randn((64,), generator=g)
    cw = ConvWeights(w, b)
    wp0, bp0 = cw.packed('cpu', torch.float32, order='ps')
    oc0, _ = cw.packed('cpu', torch.float32)
    assert wp0.shape == (128, 3, 3, 16) and oc0.shape == (64, 3, 3, 16)
    assert cw.packed('cpu', torch.float32, order='ps')[0] is wp0
    with torch.no_grad():
        w.mul_(2)
        b.add_(1)
    wp1, bp1 = cw.packed('cpu', torch.float32, order='ps')
    rows = ps_order(64)
    torch.testing.assert_close(wp1[:64, :, :, :8],
                               w[rows].permute(0, 2, 3, 1), rtol=0, atol=0)
    torch.testing.assert_close(bp1[:64], b[rows], rtol=0, atol=0)
    assert wp1[64:].abs().sum() == 0 and bp1[64:].abs().sum() == 0
    torch.testing.assert_close(wp1[:64], 2 * wp0[:64], rtol=0, atol=0)
    oc1, _ = cw.packed('cpu', torch.float32)
    torch.testing.assert_close(oc1[:, :, :, :8], w.permute(0, 2, 3, 1),
                               rtol=0, atol=0)
    with pytest.raises(ValueError):
        cw.packed('cpu', torch.float32, order='other')


# (frames, H, W, Ci, Co): the c64 train step's weight-gradient sites at
# batch 8 x 11, and ragged ones
_DW_SITES = [(88, 96, 96, 4, 64), (88, 96, 96, 64, 64), (88, 96, 96, 64, 3),
             (88, 48, 48, 128, 128), (88, 48, 48, 128, 256),
             (88, 24, 24, 256, 256), (88, 24, 24, 256, 512),
             (3, 13, 37, 20, 72), (2, 11, 13, 4, 64), (6, 9, 17, 64, 3),
             (1, 5, 7, 512, 512)]


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('site', _DW_SITES)
def test_dw_plan_covers_every_tile_once(site, dtype):
    """K7's splits together visit every pixel tile exactly once, and the
    tiles cover every pixel; the bf16 grid fits one block per SM."""
    nt, h, w, ci, co = site
    sms = 132
    cfg, cinp, coutp, tiles, splits = dw_plan(nt, h, w, ci, co, dtype, sms)
    th, tw = (8, 8) if dtype == torch.bfloat16 else (8, 16)
    assert tiles == nt * -(-h // th) * -(-w // tw)
    seen = [t for s in range(splits) for t in dw_split_tiles(s, splits,
                                                             tiles)]
    assert sorted(seen) == list(range(tiles))
    assert 1 <= splits <= tiles
    covered = set()
    per_frame = -(-h // th) * -(-w // tw)
    for t in range(per_frame):
        oy0, ox0 = (t // -(-w // tw)) * th, (t % -(-w // tw)) * tw
        covered |= {(y, x) for y in range(oy0, min(oy0 + th, h))
                    for x in range(ox0, min(ox0 + tw, w))}
    assert len(covered) == h * w
    assert cinp >= ci and coutp >= co
    if dtype == torch.bfloat16:
        cob, cib = {0: (64, 64), 1: (64, 16), 2: (16, 64)}[cfg]
        assert cinp % cib == 0 and coutp % cob == 0
        assert cfg == (1 if ci <= 16 else 2 if co <= 16 else 0)
        blocks = (coutp // cob) * (cinp // cib) * splits
        assert blocks <= max(sms, (coutp // cob) * (cinp // cib))


def test_oc_pack_pads_cout_to_its_multiple():
    """K3's pack (CoutP a multiple of 128, torch's channel order) is cached
    under its own key beside the 64-multiple pack of the other kernels;
    K4's order takes no multiple but 128."""
    g = torch.Generator().manual_seed(1)
    cw = ConvWeights(torch.randn((72, 20, 3, 3), generator=g),
                     torch.randn((72,), generator=g))
    w64, b64 = cw.packed('cpu', torch.float32)
    w128, b128 = cw.packed('cpu', torch.float32, cout_mult=128)
    assert w64.shape == (128, 3, 3, 32) and w128.shape == (128, 3, 3, 32)
    cw8 = ConvWeights(cw.w[:8], cw.b[:8])
    assert cw8.packed('cpu', torch.float32)[0].shape[0] == 64
    w8, b8 = cw8.packed('cpu', torch.float32, cout_mult=128)
    assert w8.shape == (128, 3, 3, 32) and b8.shape == (128,)
    torch.testing.assert_close(w8[:8, :, :, :20], cw8.w.permute(0, 2, 3, 1),
                               rtol=0, atol=0)
    assert w8[8:].abs().sum() == 0 and b8[8:].abs().sum() == 0
    assert cw.packed('cpu', torch.float32, cout_mult=128)[0] is w128
    torch.testing.assert_close(w128, w64, rtol=0, atol=0)
    # K4's order has one multiple: asking it for another raises
    assert cw8.packed('cpu', torch.float32, order='ps',
                      cout_mult=128)[0].shape[0] == 128
    with pytest.raises(ValueError, match='128'):
        cw8.packed('cpu', torch.float32, order='ps', cout_mult=64)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('cout', [3, 16, 24, 64])
def test_chain_w2_pack_narrow_head(cout, dtype):
    """K2's conv2 weights: K over the intermediate's 64 padded channels;
    bf16 packs CoutP to 16 where Cout <= 16 (the 3-channel head), else
    to 64, as the fp32 kernel always does; zero padded, the bias fp32 of
    CoutP entries."""
    from bsvd_tpu_torch.ops.conv_chain import packed_w2
    g = torch.Generator().manual_seed(1)
    w = torch.randn((cout, 20, 3, 3), generator=g)
    b = torch.randn((cout,), generator=g)
    wp, bp = packed_w2(ConvWeights(w, b), 'cpu', dtype)
    coutp = 16 if dtype == torch.bfloat16 and cout <= 16 else 64
    assert wp.shape == (coutp, 3, 3, 64) and wp.dtype == dtype
    assert bp.shape == (coutp,) and bp.dtype == torch.float32
    torch.testing.assert_close(wp[:cout, :, :, :20],
                               w.permute(0, 2, 3, 1).to(dtype),
                               rtol=0, atol=0)
    assert wp[cout:].abs().sum() == 0 and wp[..., 20:].abs().sum() == 0
    torch.testing.assert_close(bp[:cout], b, rtol=0, atol=0)
    assert bp[cout:].abs().sum() == 0


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('cout', [3, 200])
def test_chain_w2_pack_wide_intermediate(cout, dtype):
    """K2's conv2 weights behind a 130-channel intermediate: K padded to
    192 (three of the kernel's 64-channel conv1 blocks), CoutP to 16 for
    the bf16 head, else to 256 (four conv2 blocks)."""
    from bsvd_tpu_torch.ops.conv_chain import packed_w2
    g = torch.Generator().manual_seed(2)
    w = torch.randn((cout, 130, 3, 3), generator=g)
    wp, bp = packed_w2(ConvWeights(w, torch.zeros(cout)), 'cpu', dtype)
    coutp = (16 if dtype == torch.bfloat16 and cout <= 16
             else -(-cout // 64) * 64)
    assert wp.shape == (coutp, 3, 3, 192) and bp.shape == (coutp,)
    torch.testing.assert_close(wp[:cout, :, :, :130],
                               w.permute(0, 2, 3, 1).to(dtype),
                               rtol=0, atol=0)
    assert wp[cout:].abs().sum() == 0 and wp[..., 130:].abs().sum() == 0
