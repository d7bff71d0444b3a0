"""Seeded writer of random but valid H.264 CAVLC streams in mp4: the test
streams of the port's host decoder (bsvd_tpu_torch/data/h264_decode),
one stream family for each coding tool it decodes. Nothing here
reconstructs a picture: cv2's FFmpeg decode of the same file is the
reference the decoder is held to (tests/test_torch_h264.py).

``write_stream(path, family, seed)`` writes one clip of ``FAMILIES
[family]`` and returns its frame count. Every syntax element is drawn
from ``seed``; the writer keeps what a decoder would need to keep the
stream valid, and no more:

- the neighbours of each block (slice edges, ``constrained_intra_pred``):
  intra modes are drawn only where their neighbouring samples exist, and
  each mode is coded against its predicted mode;
- nC of every 4x4 block (the coeff_token table);
- the motion vector prediction (median, directional, P_Skip), so that
  every vector, P_Skip's included, stays within +-48 pixels;
- the reference marking (sliding window, MMCO 1-6) and the lists
  (modification, long-term), so that every ref_idx names a picture the
  DPB holds and the DPB never overflows;
- each macroblock's QP and the scaling matrices, so that levels stay
  small enough that no dequantised coefficient or transform
  intermediate leaves 16 bits (8.5.12.1);
- the picture order count of types 0, 1 and 2, so that FFmpeg's output
  order is the display order the mp4's ``ctts`` gives.

The IDR is the only sync sample (``stss``), as cv2's seek needs. It
reuses the bit writer, the NAL framing and the mp4 muxer of
``tools/make_video_fixtures``. No command line.
"""

from collections import Counter

import numpy as np

from tools.make_video_fixtures import BitWriter, mux, nal

BASELINE, MAIN, HIGH = 66, 77, 100

ZZ4 = [0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15]
ZZ8 = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
       12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
       35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
       58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63]
DEF4_ZZ = [[6, 13, 13, 20, 20, 20, 28, 28, 28, 28, 32, 32, 32, 37, 37, 42],
           [10, 14, 14, 20, 20, 20, 24, 24, 24, 24, 27, 27, 27, 30, 30, 34]]
DEF8_ZZ = [[6, 10, 10, 13, 11, 13, 16, 16, 16, 16, 18, 18, 18, 18, 18, 23,
            23, 23, 23, 23, 23, 25, 25, 25, 25, 25, 25, 25, 27, 27, 27, 27,
            27, 27, 27, 27, 29, 29, 29, 29, 29, 29, 29, 31, 31, 31, 31, 31,
            31, 33, 33, 33, 33, 33, 36, 36, 36, 36, 38, 38, 38, 40, 40, 42],
           [9, 13, 13, 15, 13, 15, 17, 17, 17, 17, 19, 19, 19, 19, 19, 21,
            21, 21, 21, 21, 21, 22, 22, 22, 22, 22, 22, 22, 24, 24, 24, 24,
            24, 24, 24, 24, 25, 25, 25, 25, 25, 25, 25, 27, 27, 27, 27, 27,
            27, 28, 28, 28, 28, 28, 30, 30, 30, 30, 32, 32, 32, 33, 33, 35]]
NORM4 = [[10, 13, 16], [11, 14, 18], [13, 16, 20], [14, 18, 23],
         [16, 20, 25], [18, 23, 29]]
NORM8 = [[20, 18, 32, 19, 25, 24], [22, 19, 35, 21, 28, 26],
         [26, 23, 42, 24, 33, 31], [28, 25, 45, 26, 35, 33],
         [32, 28, 51, 30, 40, 38], [36, 32, 58, 34, 46, 43]]
NORM8_POS = [0, 3, 4, 3, 3, 1, 5, 1, 4, 5, 2, 5, 3, 1, 5, 1]
CBP_INTRA = [47, 31, 15, 0, 23, 27, 29, 30, 7, 11, 13, 14, 39, 43, 45, 46,
             16, 3, 5, 10, 12, 19, 21, 26, 28, 35, 37, 42, 44, 1, 2, 4, 8,
             17, 18, 20, 24, 6, 9, 22, 25, 32, 33, 34, 36, 40, 38, 41]
CBP_INTER = [0, 16, 1, 2, 4, 8, 32, 3, 5, 10, 12, 15, 47, 7, 11, 13, 14, 6,
             9, 31, 35, 37, 42, 44, 33, 34, 36, 40, 39, 43, 45, 46, 17, 18,
             20, 24, 19, 21, 26, 28, 23, 27, 29, 30, 22, 25, 38, 41]
CODE_INTRA = {c: i for i, c in enumerate(CBP_INTRA)}
CODE_INTER = {c: i for i, c in enumerate(CBP_INTER)}
CT_LEN = [
    [1, 0, 0, 0, 6, 2, 0, 0, 8, 6, 3, 0, 9, 8, 7, 5, 10, 9, 8, 6, 11, 10, 9,
     7, 13, 11, 10, 8, 13, 13, 11, 9, 13, 13, 13, 10, 14, 14, 13, 11, 14, 14,
     14, 13, 15, 15, 14, 14, 15, 15, 15, 14, 16, 15, 15, 15, 16, 16, 16, 15,
     16, 16, 16, 16, 16, 16, 16, 16],
    [2, 0, 0, 0, 6, 2, 0, 0, 6, 5, 3, 0, 7, 6, 6, 4, 8, 6, 6, 4, 8, 7, 7, 5,
     9, 8, 8, 6, 11, 9, 9, 6, 11, 11, 11, 7, 12, 11, 11, 9, 12, 12, 12, 11,
     12, 12, 12, 11, 13, 13, 13, 12, 13, 13, 13, 13, 13, 14, 13, 13, 14, 14,
     14, 13, 14, 14, 14, 14],
    [4, 0, 0, 0, 6, 4, 0, 0, 6, 5, 4, 0, 6, 5, 5, 4, 7, 5, 5, 4, 7, 5, 5, 4,
     7, 6, 6, 4, 7, 6, 6, 4, 8, 7, 7, 5, 8, 8, 7, 6, 9, 8, 8, 7, 9, 9, 8, 8,
     9, 9, 9, 8, 10, 9, 9, 9, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10,
     10]]
CT_BITS = [
    [1, 0, 0, 0, 5, 1, 0, 0, 7, 4, 1, 0, 7, 6, 5, 3, 7, 6, 5, 3, 7, 6, 5, 4,
     15, 6, 5, 4, 11, 14, 5, 4, 8, 10, 13, 4, 15, 14, 9, 4, 11, 10, 13, 12,
     15, 14, 9, 12, 11, 10, 13, 8, 15, 1, 9, 12, 11, 14, 13, 8, 7, 10, 9, 12,
     4, 6, 5, 8],
    [3, 0, 0, 0, 11, 2, 0, 0, 7, 7, 3, 0, 7, 10, 9, 5, 7, 6, 5, 4, 4, 6, 5,
     6, 7, 6, 5, 8, 15, 6, 5, 4, 11, 14, 13, 4, 15, 10, 9, 4, 11, 14, 13, 12,
     8, 10, 9, 8, 15, 14, 13, 12, 11, 10, 9, 12, 7, 11, 6, 8, 9, 8, 10, 1, 7,
     6, 5, 4],
    [15, 0, 0, 0, 15, 14, 0, 0, 11, 15, 13, 0, 8, 12, 14, 12, 15, 10, 11, 11,
     11, 8, 9, 10, 9, 14, 13, 9, 8, 10, 9, 8, 15, 14, 13, 13, 11, 14, 10, 12,
     15, 10, 13, 12, 11, 14, 9, 12, 8, 10, 13, 8, 13, 7, 9, 12, 9, 12, 11,
     10, 5, 8, 7, 6, 1, 4, 3, 2]]
CDC_LEN = [2, 0, 0, 0, 6, 1, 0, 0, 6, 6, 3, 0, 6, 7, 7, 6, 6, 8, 8, 7]
CDC_BITS = [1, 0, 0, 0, 7, 1, 0, 0, 4, 6, 1, 0, 3, 3, 2, 5, 2, 3, 2, 0]
TZ_LEN = [[1, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 9],
          [3, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 6, 6, 6, 6],
          [4, 3, 3, 3, 4, 4, 3, 3, 4, 5, 5, 6, 5, 6],
          [5, 3, 4, 4, 3, 3, 3, 4, 3, 4, 5, 5, 5],
          [4, 4, 4, 3, 3, 3, 3, 3, 4, 5, 4, 5],
          [6, 5, 3, 3, 3, 3, 3, 3, 4, 3, 6],
          [6, 5, 3, 3, 3, 2, 3, 4, 3, 6],
          [6, 4, 5, 3, 2, 2, 3, 3, 6],
          [6, 6, 4, 2, 2, 3, 2, 5],
          [5, 5, 3, 2, 2, 2, 4],
          [4, 4, 3, 3, 1, 3],
          [4, 4, 2, 1, 3],
          [3, 3, 1, 2],
          [2, 2, 1],
          [1, 1]]
TZ_BITS = [[1, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 1],
           [7, 6, 5, 4, 3, 5, 4, 3, 2, 3, 2, 3, 2, 1, 0],
           [5, 7, 6, 5, 4, 3, 4, 3, 2, 3, 2, 1, 1, 0],
           [3, 7, 5, 4, 6, 5, 4, 3, 3, 2, 2, 1, 0],
           [5, 4, 3, 7, 6, 5, 4, 3, 2, 1, 1, 0],
           [1, 1, 7, 6, 5, 4, 3, 2, 1, 1, 0],
           [1, 1, 5, 4, 3, 3, 2, 1, 1, 0],
           [1, 1, 1, 3, 3, 2, 2, 1, 0],
           [1, 0, 1, 3, 2, 1, 1, 1],
           [1, 0, 1, 3, 2, 1, 1],
           [0, 1, 1, 2, 1, 3],
           [0, 1, 1, 1, 1],
           [0, 1, 1, 1],
           [0, 1, 1],
           [0, 1]]
TZC_LEN = [[1, 2, 3, 3], [1, 2, 2], [1, 1]]
TZC_BITS = [[1, 1, 1, 0], [1, 1, 0], [1, 0]]
RB_LEN = [[1, 1], [1, 2, 2], [2, 2, 2, 2], [2, 2, 2, 3, 3],
          [2, 2, 3, 3, 3, 3], [2, 3, 3, 3, 3, 3, 3],
          [3, 3, 3, 3, 3, 3, 3, 4, 5, 6, 7, 8, 9, 10, 11]]
RB_BITS = [[1, 0], [1, 1, 0], [3, 2, 1, 0], [3, 2, 1, 1, 0],
           [3, 2, 3, 2, 1, 0], [3, 0, 1, 3, 2, 5, 4],
           [7, 6, 5, 4, 3, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1]]

BLK_X = [(b >> 2 & 1) * 2 + (b & 1) for b in range(16)]
BLK_Y = [(b >> 3) * 2 + (b >> 1 & 1) for b in range(16)]
BLK_AT = [[0] * 4 for _ in range(4)]
for _b in range(16):
    BLK_AT[BLK_Y[_b]][BLK_X[_b]] = _b


def _raster(zz_values, scan):
    out = [0] * len(scan)
    for i, p in enumerate(scan):
        out[p] = zz_values[i]
    return out


DEF4 = [_raster(v, ZZ4) for v in DEF4_ZZ]
DEF8 = [_raster(v, ZZ8) for v in DEF8_ZZ]
FLAT4, FLAT8 = [16] * 16, [16] * 64
MV_MAX = 192            # +-48 pixels in quarter samples
COEF_BOUND = 8000       # sum |dequantised coefficient| of a block
DC_BOUND = 2000         # |a dequantised DC|

# Each family: the options of ``Stream`` (defaults there) that exercise one
# coding tool (module docstring).
FAMILIES = {
    'intra4x4': dict(
        profile=MAIN, size=(64, 96), mb_kinds={'I4': 8, 'I16': 1},
        p_kinds={'I4': 4, 'P': 3, 'SKIP': 1}, i_every=3),
    'intra8x8': dict(
        profile=HIGH, size=(64, 96), t8x8=True,
        mb_kinds={'I8': 8, 'I4': 1, 'I16': 1},
        p_kinds={'I8': 3, 'P': 4, 'SKIP': 1}, i_every=3),
    'intra16x16': dict(
        profile=MAIN, size=(64, 80), mb_kinds={'I16': 9, 'I4': 1},
        p_kinds={'I16': 4, 'P': 3, 'SKIP': 1}, i_every=3),
    'pcm': dict(
        profile=MAIN, size=(48, 64), mb_kinds={'PCM': 3, 'I4': 2, 'I16': 2},
        p_kinds={'PCM': 2, 'I4': 1, 'P': 3, 'SKIP': 2}),
    'p_partitions': dict(
        profile=MAIN, size=(80, 96), num_ref_frames=1,
        p_kinds={'P16x16': 2, 'P16x8': 2, 'P8x16': 2, 'P8x8': 4, 'I4': 1,
                 'SKIP': 1}),
    'skips': dict(
        profile=BASELINE, size=(64, 96),
        p_kinds={'SKIP': 8, 'P16x16': 2, 'I4': 1}, mv_small=True),
    'multiref': dict(
        profile=MAIN, size=(64, 96), num_ref_frames=4, max_refs=4,
        p_kinds={'P16x16': 2, 'P16x8': 1, 'P8x16': 1, 'P8x8': 2,
                 'P8x8ref0': 1, 'SKIP': 1}, modify=0.8, nonref=0.2),
    'long_term': dict(
        profile=MAIN, size=(64, 80), num_ref_frames=4, max_refs=4,
        p_kinds={'P16x16': 3, 'P8x8': 2, 'SKIP': 1, 'I4': 1},
        modify=0.6, mmco=0.8, idr_long=0.5),
    'weighted': dict(
        profile=MAIN, size=(64, 96), num_ref_frames=3, max_refs=3,
        weighted=True, modify=0.5,
        p_kinds={'P16x16': 3, 'P16x8': 1, 'P8x8': 2, 'SKIP': 2}),
    **{f'scaling_{where}': dict(
        profile=HIGH, size=(64, 96), t8x8=True, scaling=where,
        mb_kinds={'I8': 3, 'I4': 3, 'I16': 2},
        p_kinds={'P16x16': 2, 'P8x8': 2, 'I8': 1, 'I4': 1, 'I16': 1,
                 'SKIP': 1})
       for where in ('sps', 'pps', 'both')},
    'deblock': dict(
        profile=MAIN, size=(80, 96), slices=(1, 4), deblock=True,
        mb_kinds={'I4': 4, 'I16': 2, 'PCM': 1},
        p_kinds={'P16x16': 3, 'P8x8': 2, 'I4': 1, 'SKIP': 2, 'PCM': 1},
        num_ref_frames=2, max_refs=2, chroma_offsets=True, qp_jumps=True),
    'poc0_bframes': dict(
        profile=HIGH, size=(64, 80), poc_type=0, bframes=True,
        mb_kinds={'I4': 3, 'I16': 2, 'PCM': 1},
        b_kinds={'I4': 3, 'I16': 2, 'PCM': 1}),
    'poc1': dict(
        profile=MAIN, size=(64, 80), poc_type=1, bframes=True, nonref=0.3,
        b_kinds={'I4': 2, 'I16': 2}),
    'poc2': dict(profile=BASELINE, size=(64, 80), poc_type=2, nonref=0.4),
    'slices': dict(
        profile=MAIN, size=(96, 128), slices=(2, 5), slice_types=True,
        num_ref_frames=2, max_refs=2, modify=0.5),
    'cropping': dict(
        profile=HIGH, size=(90, 118), crop_lt=(0, 4), t8x8=True,
        mb_kinds={'I4': 2, 'I8': 2, 'I16': 2}),
    'constrained_intra': dict(
        profile=MAIN, size=(64, 96), cip=True,
        p_kinds={'I4': 3, 'I16': 2, 'PCM': 1, 'P16x16': 3, 'SKIP': 2}),
    'escapes': dict(
        profile=HIGH, size=(48, 64), qp=(0, 6), big_levels=True,
        mb_kinds={'I4': 3, 'I16': 1}, p_kinds={'P16x16': 3, 'I4': 1}),
    'frame_num_wrap': dict(
        profile=BASELINE, size=(48, 64), log2_max_frame_num=4, frames=20,
        second_idr=False, num_ref_frames=2, max_refs=2, modify=0.4,
        p_kinds={'P16x16': 2, 'SKIP': 3}),
    'high_qp_dense': dict(
        profile=HIGH, size=(48, 80), qp=(30, 51), t8x8=True, dense=True,
        mb_kinds={'I4': 2, 'I8': 2, 'I16': 2},
        p_kinds={'P16x16': 2, 'P8x8': 2, 'I4': 1}),
    'low_qp_dense': dict(
        profile=MAIN, size=(48, 64), qp=(8, 20), dense=True,
        mb_kinds={'I4': 2, 'I16': 2}, p_kinds={'P8x8': 2, 'I4': 1}),
}


class Stream:
    """One family's stream (module docstring)."""

    def __init__(self, rng, profile=MAIN, size=(64, 96), frames=12,
                 mb_kinds=None, p_kinds=None, b_kinds=None, i_every=0,
                 num_ref_frames=2, max_refs=1, t8x8=False, scaling=None,
                 weighted=False, cip=False, deblock=False, slices=(1, 2),
                 slice_types=False, poc_type=0, bframes=False, nonref=0.0,
                 modify=0.0, mmco=0.0, idr_long=0.0, qp=(16, 40),
                 big_levels=False, dense=False, mv_small=False,
                 chroma_offsets=False, qp_jumps=False, crop_lt=(0, 0),
                 log2_max_frame_num=None, second_idr=True):
        self.rng = rng
        self.stats = Counter()     # the coding tools written (tests read it)
        self.profile = profile
        self.h, self.w = size
        self.frames = frames
        self.second_idr = second_idr    # an IDR may start the second half
        self.mb_kinds = mb_kinds or {'I4': 3, 'I16': 2, 'PCM': 0}
        self.p_kinds = p_kinds or {'P16x16': 3, 'P8x8': 1, 'I4': 1, 'SKIP': 2}
        self.b_kinds = b_kinds or {'I4': 1, 'I16': 1}
        self.i_every = i_every
        self.num_ref_frames = num_ref_frames
        self.max_refs = max_refs
        self.t8x8 = t8x8 and profile == HIGH
        self.cip = cip
        self.deblock = deblock
        self.slices = slices
        self.slice_types = slice_types
        self.poc_type = poc_type
        self.bframes = bframes and profile != BASELINE
        self.nonref = nonref
        self.modify = modify
        self.mmco = mmco
        self.idr_long = idr_long
        self.qp_range = qp
        self.big_levels = big_levels
        self.dense = dense
        self.mv_small = mv_small
        self.weighted = weighted and profile != BASELINE
        self.qp_jumps = qp_jumps
        left, top = crop_lt
        self.mbw = -(-(self.w + left) // 16)
        self.mbh = -(-(self.h + top) // 16)
        self.crop = (left, self.mbw * 16 - self.w - left, top,
                     self.mbh * 16 - self.h - top)
        assert min(self.crop) >= 0 and all(c % 2 == 0 for c in self.crop)
        self.log2_max_frame_num = log2_max_frame_num or int(rng.integers(4, 9))
        self.log2_max_poc_lsb = int(rng.integers(5, 9))
        r = rng.integers
        # the PPS
        self.pic_init_qp = int(r(*self.qp_range)) if qp else 26
        span = 12 if chroma_offsets else 2
        cb = int(r(-span, span + 1))
        cr = int(r(-span, span + 1)) if profile == HIGH else cb
        self.chroma_qp_offset = [cb, cr]
        self.num_ref_default = int(r(1, max(1, max_refs) + 1))
        self.deblock_ctrl = deblock or bool(r(2))
        self.bottom_poc = bool(r(2)) and poc_type != 2
        self.redundant_present = profile == BASELINE and bool(r(2))
        self.scaling = scaling      # None, or where: 'sps', 'pps', 'both'
        self.sl4_sps, self.sl8_sps = [FLAT4] * 6, [FLAT8] * 2
        self.sps_scaling = None
        self.pps_scaling = None
        if scaling:
            self._draw_scaling()
        else:
            self.sl4, self.sl8 = [FLAT4] * 6, [FLAT8] * 2

    # ---------------------------------------------------------- headers
    def _draw_list(self, size, deflt):
        """(present, use default, values raster) of a random scaling
        list."""
        r = self.rng
        kind = int(r.integers(4))   # 0 absent, 1 default flag, 2-3 values
        if kind == 0:
            return ('absent', None)
        if kind == 1:
            self.stats['scaling_list_default'] += 1
            return ('default', list(deflt))
        scan = ZZ4 if size == 16 else ZZ8
        base = int(r.integers(4, 40))
        vals = [int(np.clip(base + r.integers(-3, 4) + i // 4, 1, 64))
                for i in range(size)]
        return ('values', _raster(vals, scan))

    def _draw_scaling(self):
        """SPS and PPS scaling matrices, the effective ones by fall-back
        rules A and B."""
        r = self.rng
        sps_lists = None
        if self.scaling in ('sps', 'both'):
            sps_lists = [self._draw_list(16, DEF4[i >= 3])
                         for i in range(6)] + \
                [self._draw_list(64, DEF8[i]) for i in range(2)]
            eff4, eff8 = [], []
            for i in range(6):
                kind, v = sps_lists[i]
                fb = DEF4[0] if i == 0 else DEF4[1] if i == 3 else eff4[i - 1]
                eff4.append(fb if kind == 'absent' else v)
            for i in range(2):
                kind, v = sps_lists[6 + i]
                eff8.append(DEF8[i] if kind == 'absent' else v)
            self.sl4_sps, self.sl8_sps = eff4, eff8
            self.stats['sps_scaling'] += 1
        self.sps_scaling = sps_lists
        pps_lists = None
        if self.scaling in ('pps', 'both'):
            n = 8 if self.t8x8 else 6
            pps_lists = [self._draw_list(16, DEF4[i >= 3])
                         for i in range(6)] + \
                [self._draw_list(64, DEF8[i]) for i in range(n - 6)]
            fa = sps_lists is None
            f4 = [DEF4[0] if fa else self.sl4_sps[0],
                  DEF4[1] if fa else self.sl4_sps[3]]
            f8 = [DEF8[0] if fa else self.sl8_sps[0],
                  DEF8[1] if fa else self.sl8_sps[1]]
            eff4 = []
            for i in range(6):
                kind, v = pps_lists[i]
                fb = f4[0] if i == 0 else f4[1] if i == 3 else eff4[i - 1]
                eff4.append(fb if kind == 'absent' else v)
            eff8 = list(self.sl8_sps)
            for i in range(n - 6):
                kind, v = pps_lists[6 + i]
                eff8[i] = f8[i] if kind == 'absent' else v
            self.sl4, self.sl8 = eff4, eff8
            self.stats['pps_scaling_rule_' + ('A' if fa else 'B')] += 1
        else:
            self.sl4, self.sl8 = self.sl4_sps, self.sl8_sps
        self.pps_scaling = pps_lists

    def _write_lists(self, w, lists):
        for kind, v in lists:
            w.u(1, kind != 'absent')
            if kind == 'absent':
                continue
            scan = ZZ4 if len(v) == 16 else ZZ8
            if kind == 'default':
                w.se(-8)                          # nextScale 0 at j = 0
                continue
            last = 8
            for j, pos in enumerate(scan):
                d = (v[pos] - last + 128) % 256 - 128
                w.se(d)
                last = v[pos]

    def sps_nal(self):
        w = BitWriter()
        w.u(8, self.profile)
        w.u(8, 0xC0 if self.profile == BASELINE else 0)
        w.u(8, 40)
        w.ue(0)
        if self.profile == HIGH:
            w.ue(1)
            w.ue(0)
            w.ue(0)
            w.u(1, 0)
            w.u(1, self.sps_scaling is not None)
            if self.sps_scaling is not None:
                self._write_lists(w, self.sps_scaling)
        w.ue(self.log2_max_frame_num - 4)
        w.ue(self.poc_type)
        if self.poc_type == 0:
            w.ue(self.log2_max_poc_lsb - 4)
        elif self.poc_type == 1:
            w.u(1, 0)                             # delta_pic_order_always_zero
            w.se(self.offset_non_ref)
            w.se(0)                               # offset_for_top_to_bottom
            w.ue(len(self.offset_ref))
            for o in self.offset_ref:
                w.se(o)
        w.ue(self.num_ref_frames)
        w.u(1, 0)                                 # gaps_in_frame_num_allowed
        w.ue(self.mbw - 1)
        w.ue(self.mbh - 1)
        w.u(1, 1)                                 # frame_mbs_only_flag
        w.u(1, 1)                                 # direct_8x8_inference_flag
        w.u(1, int(any(self.crop)))
        if any(self.crop):
            for c in self.crop:
                w.ue(c // 2)
        w.u(1, 1)                                 # vui_parameters_present
        for _ in range(8):                        # aspect .. pic_struct
            w.u(1, 0)
        w.u(1, 1)                                 # bitstream_restriction
        w.u(1, 1)
        w.ue(0)
        w.ue(0)
        w.ue(15)
        w.ue(15)
        w.ue(1 if self.bframes else 0)            # max_num_reorder_frames
        w.ue(max(self.num_ref_frames, 1) + (1 if self.bframes else 0))
        w.trailing()
        return nal(3, 7, w.bytes())

    def pps_nal(self):
        w = BitWriter()
        w.ue(0)
        w.ue(0)
        w.u(1, 0)                                 # CAVLC
        w.u(1, self.bottom_poc)
        w.ue(0)                                   # one slice group
        w.ue(self.num_ref_default - 1)
        w.ue(0)
        w.u(1, self.weighted)
        w.u(2, 0)
        w.se(self.pic_init_qp - 26)
        w.se(0)
        w.se(self.chroma_qp_offset[0])
        w.u(1, self.deblock_ctrl)
        w.u(1, self.cip)
        w.u(1, self.redundant_present)
        if self.profile == HIGH:
            w.u(1, self.t8x8)
            w.u(1, self.pps_scaling is not None)
            if self.pps_scaling is not None:
                self._write_lists(w, self.pps_scaling)
            w.se(self.chroma_qp_offset[1])
        w.trailing()
        return nal(3, 8, w.bytes())

    # ------------------------------------------------------- the stream
    def plan(self):
        """[(display index, kind 'I' | 'P' | 'B', idr, reference)] in
        decode order."""
        r = self.rng
        n = self.frames
        order = [(0, 'I', True, True)]
        k = 1
        while k < n:
            if self.bframes and k + 1 < n and r.random() < 0.6:
                order.append((k + 1, 'P', False, True))
                order.append((k, 'B', False, False))
                k += 2
                continue
            kind = 'I' if self.i_every and k % self.i_every == 0 else 'P'
            if k == n // 2 and r.random() < 0.3 and self.second_idr:
                order.append((k, 'I', True, True))       # a second IDR
            else:
                ref = not (r.random() < self.nonref and k < n - 1)
                if self.poc_type == 2 and not order[-1][3]:
                    ref = True          # no two non-reference frames in a row
                order.append((k, kind, False, ref))
            k += 1
        return order

    def encode(self):
        """(access units in decode order, (SPS, PPS), gop order for
        ``mux``)."""
        r = self.rng
        if self.poc_type == 1:
            cycle = int(r.integers(1, 4))
            self.offset_ref = [int(x) for x in r.integers(1, 5, cycle)]
            self.offset_non_ref = int(r.integers(-3, 1))
        order = self.plan()
        params = (self.sps_nal(), self.pps_nal())
        # dicts: serial, frame_num, long_idx, short, long
        self.dpb = []
        self.serial = 0
        self.max_long_idx = -1
        self.prev_ref_frame_num = 0
        self.frame_num_offset = 0
        self.prev_frame_num = 0
        self.poc_base = 0           # display index whose POC is 0
        self.idr_id = -1
        units = []
        frame_num = 0
        for disp, kind, idr, ref in order:
            if idr:
                frame_num = 0
                self.idr_id += 1
                self.poc_base = disp
            units.append(self.picture(disp, kind, idr, ref, frame_num))
            if ref:
                frame_num = (self.cur_frame_num + 1) % (
                    1 << self.log2_max_frame_num)
        gop = [(d, 'I' if idr else kind, idr) for d, kind, idr, _ in order]
        return units, params, gop

    # ------------------------------------------------- reference marking
    def pic_num(self, p, frame_num):
        max_fn = 1 << self.log2_max_frame_num
        fn = p['frame_num']
        return fn - max_fn if fn > frame_num else fn

    def refs(self):
        return [p for p in self.dpb if p['short'] or p['long']]

    def init_list(self, frame_num):
        st = sorted([p for p in self.dpb if p['short']],
                    key=lambda p: -self.pic_num(p, frame_num))
        lt = sorted([p for p in self.dpb if p['long']],
                    key=lambda p: p['long_idx'])
        return st + lt

    def draw_marking(self, idr, frame_num):
        """The dec_ref_pic_marking syntax of a reference picture, applied
        to the DPB model; returns (adaptive flag or the IDR's long-term
        flag, ops)."""
        r = self.rng
        cur = {'serial': self.serial, 'frame_num': frame_num, 'long_idx': -1,
               'short': False, 'long': False}
        cap = max(self.num_ref_frames, 1)
        if idr:
            self.dpb = []
            lt = r.random() < self.idr_long
            self.stats['idr_long_term'] += lt
            if lt:
                cur.update(long=True, long_idx=0)
                self.max_long_idx = 0
            else:
                cur['short'] = True
                self.max_long_idx = -1
            self.dpb.append(cur)
            return lt, []
        ops = []
        full = len(self.refs()) >= cap
        adaptive = r.random() < self.mmco or (
            full and not any(p['short'] for p in self.dpb))
        cur_long = False
        mmco5 = False
        if adaptive:
            for _ in range(int(r.integers(1, 4))):
                shorts = [p for p in self.dpb if p['short']]
                longs = [p for p in self.dpb if p['long']]
                choice = int(r.integers(7))
                if choice == 1 and shorts:
                    p = shorts[int(r.integers(len(shorts)))]
                    ops.append((1, frame_num - self.pic_num(p, frame_num) - 1))
                    p['short'] = False
                elif choice == 2 and longs:
                    p = longs[int(r.integers(len(longs)))]
                    ops.append((2, p['long_idx']))
                    p['long'] = False
                elif choice == 3 and shorts and self.max_long_idx >= 0:
                    p = shorts[int(r.integers(len(shorts)))]
                    idx = int(r.integers(self.max_long_idx + 1))
                    ops.append((3, frame_num - self.pic_num(p, frame_num) - 1,
                                idx))
                    for q in longs:
                        if q['long_idx'] == idx:
                            q['long'] = False
                    p.update(short=False, long=True, long_idx=idx)
                elif choice == 4:
                    m = int(r.integers(0, cap + 1))
                    ops.append((4, m))
                    self.max_long_idx = m - 1
                    for q in longs:
                        if q['long_idx'] > self.max_long_idx:
                            q['long'] = False
                elif choice == 5 and r.random() < 0.3 and \
                        not self.bframes and not cur_long:
                    ops.append((5,))
                    for q in self.dpb:
                        q['short'] = q['long'] = False
                    self.max_long_idx = -1
                    mmco5 = True
                elif choice == 6 and self.max_long_idx >= 0 and not cur_long:
                    idx = int(r.integers(self.max_long_idx + 1))
                    ops.append((6, idx))
                    for q in longs:
                        if q['long_idx'] == idx:
                            q['long'] = False
                    cur.update(long=True, long_idx=idx)
                    cur_long = True
            # room for the current picture: free the oldest where needed
            while len(self.refs()) + 1 > cap:
                shorts = sorted([p for p in self.dpb if p['short']],
                                key=lambda p: self.pic_num(p, frame_num))
                if shorts:
                    ops.append((1, frame_num - self.pic_num(
                        shorts[0], frame_num) - 1))
                    shorts[0]['short'] = False
                else:
                    p = [p for p in self.dpb if p['long']][0]
                    ops.append((2, p['long_idx']))
                    p['long'] = False
        else:
            refs = self.refs()
            if len(refs) >= cap:
                shorts = sorted([p for p in self.dpb if p['short']],
                                key=lambda p: self.pic_num(p, frame_num))
                assert shorts, 'sliding window without short-term frames'
                shorts[0]['short'] = False
        if not cur_long:
            cur['short'] = True
        if mmco5:
            cur['frame_num'] = 0
        self.dpb = [p for p in self.dpb if p['short'] or p['long']] + [cur]
        self.mmco5 = mmco5
        return adaptive, ops

    # -------------------------------------------------------- a picture
    def picture(self, disp, kind, idr, ref, frame_num):
        r = self.rng
        self.serial += 1
        self.stats['frame_num_wraps'] += (frame_num < self.prev_frame_num
                                          and not idr)
        self.cur_frame_num = frame_num
        self.mmco5 = False
        # POC (8.2.1): the display order's, relative to the last IDR /
        # MMCO 5
        target = 2 * (disp - self.poc_base)
        poc_fields = {}
        if self.poc_type == 0:
            poc_fields['lsb'] = target % (1 << self.log2_max_poc_lsb)
        elif self.poc_type == 1:
            max_fn = 1 << self.log2_max_frame_num
            if idr:
                offset = 0
            elif self.prev_frame_num > frame_num:
                offset = self.frame_num_offset + max_fn
            else:
                offset = self.frame_num_offset
            n = len(self.offset_ref)
            absn = offset + frame_num
            if not ref and absn > 0:
                absn -= 1
            expected = 0
            if absn > 0:
                cyc, within = divmod(absn - 1, n)
                expected = cyc * sum(self.offset_ref) + sum(
                    self.offset_ref[:within + 1])
            if not ref:
                expected += self.offset_non_ref
            poc_fields['delta0'] = target - expected
            self.frame_num_offset = offset
        self.prev_frame_num = frame_num
        # slices
        n_mb = self.mbw * self.mbh
        lo, hi = self.slices
        n_slices = int(r.integers(lo, min(hi, n_mb) + 1))
        cuts = sorted(r.choice(np.arange(1, n_mb), n_slices - 1,
                               replace=False)) if n_slices > 1 else []
        bounds = [0] + [int(c) for c in cuts] + [n_mb]
        self.stats['pictures'] += 1
        self.stats['several_slices'] += n_slices > 1
        self.stats[f'poc_type_{self.poc_type}'] += 1
        pic = PictureState(self.mbw, self.mbh)
        # marking: drawn once, written in every slice; the lists are made
        # of the DPB before it
        before = [dict(q) for q in self.dpb]
        marking = self.draw_marking(idr, frame_num) if ref else None
        after, self.dpb = self.dpb, before
        slice_kinds = []
        for s in range(n_slices):
            if kind == 'I':
                slice_kinds.append('I')
            elif kind == 'B':
                slice_kinds.append('B' if not self.slice_types or
                                   r.random() < 0.7 else 'I')
            else:
                slice_kinds.append('P' if not self.slice_types or
                                   r.random() < 0.7 else 'I')
        same = len(set(slice_kinds)) == 1
        nals = []
        for s in range(n_slices):
            nals.append(self.slice(pic, s, bounds[s], bounds[s + 1],
                                   slice_kinds[s], same, idr, ref, frame_num,
                                   poc_fields, marking))
        self.dpb = after
        if ref:
            self.prev_ref_frame_num = 0 if self.mmco5 else frame_num
            if self.mmco5:
                self.poc_base = disp
                self.frame_num_offset = 0
                self.prev_frame_num = 0
                self.cur_frame_num = 0
        return nals

    def slice(self, pic, s, first, end, kind, same, idr, ref, frame_num, poc,
              marking):
        r = self.rng
        w = BitWriter()
        w.ue(first)
        st = {'P': 0, 'B': 1, 'I': 2}[kind]
        w.ue(st + 5 if same and r.random() < 0.5 else st)
        w.ue(0)
        w.u(self.log2_max_frame_num, frame_num)
        if idr:
            w.ue(self.idr_id % 65536)
        if self.poc_type == 0:
            w.u(self.log2_max_poc_lsb, poc['lsb'])
            if self.bottom_poc:
                w.se(int(r.integers(0, 3)))       # bottom after top
        elif self.poc_type == 1:
            w.se(poc['delta0'])
            if self.bottom_poc:
                w.se(int(r.integers(0, 3)))
        if self.redundant_present:
            w.ue(0)
        if kind == 'B':
            w.u(1, 1)
        sl = SliceState(self, pic, s, kind)
        if kind in 'PB':
            avail = len(self.refs())
            if kind == 'P':
                num_ref = int(r.integers(1, min(avail, self.max_refs) + 1))
                if self.rng.random() < 0.3:
                    num_ref = min(avail, self.max_refs)
            else:
                num_ref = int(r.integers(1, avail + 1))
            override = num_ref != self.num_ref_default or r.random() < 0.2
            if kind == 'B':
                override = True
            w.u(1, override)
            if override:
                w.ue(num_ref - 1)
                if kind == 'B':
                    w.ue(int(r.integers(0, avail)))
            sl.num_ref = num_ref
            if kind == 'P':
                sl.list = self.init_list(frame_num)[:num_ref]
                self.write_modification(w, sl, frame_num)
            else:
                w.u(1, 0)
                w.u(1, 0)
        if self.weighted and kind == 'P':
            self.write_weights(w, sl)
        if ref:
            lt_or_adaptive, ops = marking
            if idr:
                w.u(1, 0)
                w.u(1, lt_or_adaptive)
            else:
                w.u(1, lt_or_adaptive)
                if lt_or_adaptive:
                    for op in ops:
                        self.stats[f'mmco_{op[0]}'] += s == 0
                        w.ue(op[0])
                        for v in op[1:]:
                            w.ue(v)
                    w.ue(0)
        qp = int(r.integers(*self.qp_range)) if self.qp_range else 26
        w.se(qp - self.pic_init_qp)
        sl.qp = qp
        sl.idc = 0
        if self.deblock_ctrl:
            idc = int(r.integers(3)) if self.deblock else \
                int(r.choice([0, 0, 1, 2]))
            w.ue(idc)
            self.stats[f'deblock_idc_{idc}'] += 1
            if idc != 1:
                w.se(int(r.integers(-6, 7)))
                w.se(int(r.integers(-6, 7)))
        sl.data(w, first, end)
        w.trailing()
        nal_type = 5 if idr else 1
        ref_idc = int(r.integers(1, 4)) if ref else 0
        return nal(ref_idc, nal_type, w.bytes())

    def write_modification(self, w, sl, frame_num):
        r = self.rng
        do = r.random() < self.modify and len(self.refs()) > 0
        w.u(1, do)
        if not do:
            return
        max_fn = 1 << self.log2_max_frame_num
        pred = frame_num
        lst = list(sl.list) + [None]
        n = sl.num_ref
        for idx in range(int(r.integers(1, n + 1))):
            p = self.refs()[int(r.integers(len(self.refs())))]
            if p['short']:
                pn = self.pic_num(p, frame_num)
                nowrap = pn if pn >= 0 else pn + max_fn
                diff = nowrap - pred
                if diff < 0 or (diff == 0 and r.random() < 0.5):
                    # subtract: pred - (abs + 1) wraps below 0
                    d = pred - nowrap
                    if d <= 0:
                        d += max_fn
                    w.ue(0)
                    w.ue(d - 1)
                else:
                    d = diff if diff > 0 else max_fn
                    w.ue(1)
                    w.ue(d - 1)
                pred = nowrap
            else:
                self.stats['modification_long_term'] += 1
                w.ue(2)
                w.ue(p['long_idx'])
            lst = lst[:idx] + [p] + [q for q in lst[idx:] if q is not p]
            lst = (lst + [None] * (n + 1))[:n + 1]
        w.ue(3)
        sl.list = lst[:n]
        self.stats['modification'] += 1
        self.stats['list_duplicates'] += len({id(q) for q in sl.list}) < n

    def write_weights(self, w, sl):
        r = self.rng
        ll, cl = int(r.integers(0, 8)), int(r.integers(0, 8))
        w.ue(ll)
        w.ue(cl)
        self.stats['weights_log2_0'] += ll == 0 or cl == 0
        self.stats['weighted_slices'] += 1
        for _ in range(sl.num_ref):
            if r.random() < 0.7:
                w.u(1, 1)
                w.se(int(np.clip((1 << ll) + r.integers(-20, 21), -128, 127)))
                w.se(int(r.integers(-20, 21)))
            else:
                w.u(1, 0)
            if r.random() < 0.6:
                w.u(1, 1)
                for _ in range(2):
                    w.se(int(np.clip((1 << cl) + r.integers(-20, 21), -128,
                                     127)))
                    w.se(int(r.integers(-20, 21)))
            else:
                w.u(1, 0)


class PictureState:
    """What the writer keeps of the picture being written."""

    def __init__(self, mbw, mbh):
        n = mbw * mbh
        self.mbw, self.mbh = mbw, mbh
        self.kind = [None] * n
        self.slice = [-1] * n
        self.ipred = [[-1] * (mbw * 4) for _ in range(mbh * 4)]
        self.nz = [[0] * (mbw * 4) for _ in range(mbh * 4)]
        self.nzc = [[[0] * (mbw * 2) for _ in range(mbh * 2)]
                    for _ in range(2)]
        self.mv = [[(0, 0)] * (mbw * 4) for _ in range(mbh * 4)]
        self.ref = [[-1] * (mbw * 4) for _ in range(mbh * 4)]


INTRA = ('I4', 'I8', 'I16', 'PCM')


class SliceState:
    """One slice being written: its macroblocks' syntax."""

    def __init__(self, stream, pic, sid, kind):
        self.st = stream
        self.pic = pic
        self.sid = sid
        self.kind = kind
        self.rng = stream.rng
        self.num_ref = 0
        self.list = []
        self.qp = 26

    # ------------------------------------------------------ neighbours
    def nb4(self, x, y, limit):
        """(gy, gx, mb) of the luma 4x4 at (x, y) relative to the current
        macroblock, or None (the decoder's rule)."""
        mx, my = self.mbx, self.mby
        p = self.pic
        if y < 0:
            my -= 1
            if x < 0:
                mx -= 1
            elif x >= 16:
                mx += 1
        elif x < 0:
            mx -= 1
        elif x >= 16:
            return None
        else:
            if BLK_AT[y >> 2][x >> 2] >= limit:
                return None
            return my * 4 + (y >> 2), mx * 4 + (x >> 2), self.addr
        if mx < 0 or mx >= p.mbw or my < 0:
            return None
        a = my * p.mbw + mx
        if p.slice[a] != self.sid:
            return None
        return (my * 4 + (((y + 16) & 15) >> 2),
                mx * 4 + (((x + 16) & 15) >> 2), a)

    def mb_avail(self, dx, dy):
        mx, my = self.mbx + dx, self.mby + dy
        if mx < 0 or mx >= self.pic.mbw or my < 0:
            return None
        a = my * self.pic.mbw + mx
        return a if self.pic.slice[a] == self.sid else None

    def intra_ok(self, a):
        return a is not None and (not self.st.cip or
                                  self.pic.kind[a] in INTRA)

    def samples(self, x, y, limit):
        n = self.nb4(x, y, limit)
        return n is not None and (not self.st.cip or
                                  self.pic.kind[n[2]] in INTRA)

    def g(self, b):
        return self.mby * 4 + BLK_Y[b], self.mbx * 4 + BLK_X[b]

    def nc_luma(self, b):
        x, y = BLK_X[b] * 4, BLK_Y[b] * 4
        a, c = self.nb4(x - 1, y, 16), self.nb4(x, y - 1, 16)
        nz = self.pic.nz
        if a and c:
            return (nz[a[0]][a[1]] + nz[c[0]][c[1]] + 1) >> 1
        if a:
            return nz[a[0]][a[1]]
        if c:
            return nz[c[0]][c[1]]
        return 0

    def nc_chroma(self, comp, b):
        bx, by = b & 1, b >> 1
        nzc = self.pic.nzc[comp]
        gy, gx = self.mby * 2 + by, self.mbx * 2 + bx
        na = nb = None
        if bx:
            na = nzc[gy][gx - 1]
        elif self.mb_avail(-1, 0) is not None:
            na = nzc[gy][gx - 1]
        if by:
            nb = nzc[gy - 1][gx]
        elif self.mb_avail(0, -1) is not None:
            nb = nzc[gy - 1][gx]
        if na is not None and nb is not None:
            return (na + nb + 1) >> 1
        return na if na is not None else nb if nb is not None else 0

    # ----------------------------------------------------------- data
    def data(self, w, first, end):
        r = self.rng
        st = self.st
        run = 0
        kinds = {'I': st.mb_kinds, 'P': st.p_kinds, 'B': st.b_kinds}[self.kind]
        names = list(kinds)
        probs = np.array([kinds[k] for k in names], float)
        probs /= probs.sum()
        for addr in range(first, end):
            self.addr = addr
            self.mbx, self.mby = addr % self.pic.mbw, addr // self.pic.mbw
            self.pic.slice[addr] = self.sid
            kind = names[int(r.choice(len(names), p=probs))]
            st.stats[f'{self.kind}_slice_mb'] += 1
            if kind == 'P':
                kind = ('P16x16', 'P16x8', 'P8x16', 'P8x8')[int(r.integers(4))]
            if kind == 'I8' and not st.t8x8:
                kind = 'I4'
            if kind == 'P8x8ref0' and self.num_ref < 2:
                kind = 'P8x8'
            st.stats[kind if self.kind != 'B' else 'B_' + kind] += 1
            if kind == 'SKIP':
                self.write_skip()
                run += 1
                continue
            if self.kind != 'I':
                w.ue(run)
            run = 0
            if kind in INTRA:
                self.write_intra(w, kind)
            else:
                self.write_inter(w, kind)
        if run:
            w.ue(run)

    def qp_delta(self, w):
        r = self.rng
        st = self.st
        lo, hi = st.qp_range
        if st.qp_jumps and r.random() < 0.3:
            target = int(r.integers(lo, hi))
        else:
            target = int(np.clip(self.qp + r.integers(-3, 4), lo, hi - 1))
        d = target - self.qp
        if d > 25:
            d -= 52
        elif d < -26:
            d += 52
        st.stats['mb_qp_delta_wraps'] += not 0 <= self.qp + d <= 51
        w.se(d)
        self.qp = (self.qp + d + 52) % 52

    def set_mb(self, kind, ipred=-1):
        p = self.pic
        p.kind[self.addr] = kind
        for b in range(16):
            gy, gx = self.g(b)
            if ipred is not None:
                p.ipred[gy][gx] = ipred
            if kind in INTRA:
                p.mv[gy][gx] = (0, 0)
                p.ref[gy][gx] = -1

    # ---------------------------------------------------------- intra
    def pred_mode(self, b):
        x, y = BLK_X[b] * 4, BLK_Y[b] * 4
        a, c = self.nb4(x - 1, y, 16), self.nb4(x, y - 1, 16)
        if a is None or c is None:
            return 2
        if self.st.cip and (self.pic.kind[a[2]] not in INTRA or
                            self.pic.kind[c[2]] not in INTRA):
            return 2
        pa, pb = self.pic.ipred[a[0]][a[1]], self.pic.ipred[c[0]][c[1]]
        return min(pa if pa >= 0 else 2, pb if pb >= 0 else 2)

    def nxn_modes(self, n, b):
        x, y = BLK_X[b] * 4, BLK_Y[b] * 4
        ha, hb = self.samples(x - 1, y, b), self.samples(x, y - 1, b)
        hd = self.samples(x - 1, y - 1, b)
        modes = [2]
        if hb:
            modes += [0, 3, 7]
        if ha:
            modes += [1, 8]
        if ha and hb and hd:
            modes += [4, 5, 6]
        return modes

    def write_intra(self, w, kind):
        r = self.rng
        st = self.st
        off = {'I': 0, 'P': 5, 'B': 23}[self.kind]
        p = self.pic
        if kind == 'PCM':
            w.ue(25 + off)
            w.align_zero()
            w.raw(r.integers(0, 256, 384, dtype=np.uint8).tobytes())
            self.set_mb('PCM')
            for b in range(16):
                gy, gx = self.g(b)
                p.nz[gy][gx] = 16
            for c in range(2):
                for k in range(4):
                    gy, gx = self.mby * 2 + (k >> 1), self.mbx * 2 + (k & 1)
                    p.nzc[c][gy][gx] = 16
            return
        ha = self.intra_ok(self.mb_avail(-1, 0))
        hb = self.intra_ok(self.mb_avail(0, -1))
        hd = self.intra_ok(self.mb_avail(-1, -1))
        cmodes = [0] + ([1] if ha else []) + ([2] if hb else []) + \
            ([3] if ha and hb and hd else [])
        cmode = int(r.choice(cmodes))
        st.stats[f'chroma_mode_{cmode}'] += 1
        if kind == 'I16':
            modes = [2] + ([0] if hb else []) + ([1] if ha else []) + \
                ([3] if ha and hb and hd else [])
            mode = int(r.choice(modes))
            cbp_c = int(r.integers(3))
            cbp_l = 15 if r.random() < 0.5 else 0
            w.ue(off + 1 + mode + 4 * cbp_c + (12 if cbp_l else 0))
            i16_type = 1 + mode + 4 * cbp_c + (12 if cbp_l else 0)
            st.stats[f'I16_type_{i16_type}'] += 1
            self.set_mb('I16')
            w.ue(cmode)
            self.qp_delta(w)
            self.residual(w, cbp_l | cbp_c << 4, intra=True, i16=True,
                          t8=False)
            return
        t8 = kind == 'I8'
        w.ue(off)
        if st.t8x8:
            w.u(1, t8)
        self.set_mb(kind)
        step = 4 if t8 else 1
        for b in range(0, 16, step):
            pred = self.pred_mode(b)
            mode = int(r.choice(self.nxn_modes(8 if t8 else 4, b)))
            st.stats[f'{kind}_mode_{mode}'] += 1
            if mode == pred:
                w.u(1, 1)
            else:
                w.u(1, 0)
                w.u(3, mode if mode < pred else mode - 1)
            for i in range(step):
                gy, gx = self.g(b + i)
                p.ipred[gy][gx] = mode
        w.ue(cmode)
        cbp = self.draw_cbp()
        w.ue(CODE_INTRA[cbp])
        if cbp:
            self.qp_delta(w)
        self.residual(w, cbp, intra=True, i16=False, t8=t8)

    def draw_cbp(self):
        r = self.rng
        if self.st.dense:
            return int(r.choice([47, 31, 15, 47, 46, 39]))
        return int(r.integers(48))

    # ---------------------------------------------------------- inter
    def motion(self, x, y, limit):
        n = self.nb4(x, y, limit)
        if n is None:
            return False, -1, (0, 0)
        gy, gx, _ = n
        ref = self.pic.ref[gy][gx]
        if ref < 0:
            return True, -1, (0, 0)
        return True, ref, self.pic.mv[gy][gx]

    def mvp(self, x, y, w_, ref, shape, part):
        limit = BLK_AT[y >> 2][x >> 2]
        a, b = self.motion(x - 1, y, limit), self.motion(x, y - 1, limit)
        c = self.motion(x + w_, y - 1, limit)
        if not c[0]:
            c = self.motion(x - 1, y - 1, limit)
        if shape == 1:
            if part == 0 and b[1] == ref:
                return b[2]
            if part == 1 and a[1] == ref:
                return a[2]
        elif shape == 2:
            if part == 0 and a[1] == ref:
                return a[2]
            if part == 1 and c[1] == ref:
                return c[2]
        if not b[0] and not c[0] and a[0]:
            b = c = a
        hits = [n for n in (a, b, c) if n[1] == ref]
        if len(hits) == 1:
            return hits[0][2]
        return (sorted([a[2][0], b[2][0], c[2][0]])[1],
                sorted([a[2][1], b[2][1], c[2][1]])[1])

    def set_motion(self, x, y, w_, h, ref, mv):
        for j in range(y >> 2, (y + h) >> 2):
            for i in range(x >> 2, (x + w_) >> 2):
                gy, gx = self.mby * 4 + j, self.mbx * 4 + i
                self.pic.ref[gy][gx] = ref
                self.pic.mv[gy][gx] = mv

    def write_skip(self):
        p = self.pic
        p.kind[self.addr] = 'SKIP'
        a, b = self.motion(-1, 0, 0), self.motion(0, -1, 0)
        if not a[0] or not b[0] or (a[1] == 0 and a[2] == (0, 0)) or \
                (b[1] == 0 and b[2] == (0, 0)):
            mv = (0, 0)
        else:
            mv = self.mvp(0, 0, 16, 0, 0, 0)
        assert max(abs(mv[0]), abs(mv[1])) <= MV_MAX
        self.st.stats['P_Skip_nonzero_mv'] += mv != (0, 0)
        self.set_motion(0, 0, 16, 16, 0, mv)
        for b_ in range(16):
            gy, gx = self.g(b_)
            p.nz[gy][gx] = 0
            p.ipred[gy][gx] = -1
        for c in range(2):
            for k in range(4):
                p.nzc[c][self.mby * 2 + (k >> 1)][self.mbx * 2 + (k & 1)] = 0

    def draw_mv(self, pred):
        r = self.rng
        u = r.random()
        if u < 0.15:
            return pred
        lim = 8 if self.st.mv_small or u < 0.5 else 64 if u < 0.85 else MV_MAX
        return tuple(int(np.clip(r.integers(-lim, lim + 1), -MV_MAX, MV_MAX))
                     for _ in range(2))

    def outside(self, x, y, w_, h, mv):
        """Count a block whose reference samples reach past the picture."""
        x0 = self.mbx * 16 + x + (mv[0] >> 2) - 2
        y0 = self.mby * 16 + y + (mv[1] >> 2) - 2
        self.st.stats['mv_past_the_edge'] += (
            x0 < 0 or y0 < 0 or x0 + w_ + 5 > self.pic.mbw * 16 or
            y0 + h + 5 > self.pic.mbh * 16)

    def write_ref(self, w, ref):
        if self.num_ref <= 1:
            return
        if self.num_ref == 2:
            w.u(1, 1 - ref)
        else:
            w.ue(ref)

    def write_inter(self, w, kind):
        r = self.rng
        p = self.pic
        t = ('P16x16', 'P16x8', 'P8x16', 'P8x8', 'P8x8ref0').index(kind)
        w.ue(t)
        p.kind[self.addr] = 'P'
        for b in range(16):
            gy, gx = self.g(b)
            p.ipred[gy][gx] = -1
        if t < 3:
            n = 1 if t == 0 else 2
            refs = [int(r.integers(self.num_ref)) for _ in range(n)]
            for ref in refs:
                self.write_ref(w, ref)
            geo = [(0, 0, 16, 16)] if t == 0 else \
                [(0, 0, 16, 8), (0, 8, 16, 8)] if t == 1 else \
                [(0, 0, 8, 16), (8, 0, 8, 16)]
            for i, (x, y, pw, ph) in enumerate(geo):
                pred = self.mvp(x, y, pw, refs[i], t if t else 0, i)
                mv = self.draw_mv(pred)
                w.se(mv[0] - pred[0])
                w.se(mv[1] - pred[1])
                self.set_motion(x, y, pw, ph, refs[i], mv)
                self.outside(x, y, pw, ph, mv)
            small = False
        else:
            subs = [int(r.integers(4)) for _ in range(4)]
            for sub in subs:
                self.st.stats[f'sub_mb_type_{sub}'] += 1
            for s in subs:
                w.ue(s)
            refs = [0] * 4 if t == 4 else [int(r.integers(self.num_ref))
                                           for _ in range(4)]
            if t == 3:
                for ref in refs:
                    self.write_ref(w, ref)
            for i in range(4):
                x0, y0 = (i & 1) * 8, (i >> 1) * 8
                sw = 8 if subs[i] in (0, 1) else 4
                sh = 8 if subs[i] in (0, 2) else 4
                for y in range(0, 8, sh):
                    for x in range(0, 8, sw):
                        pred = self.mvp(x0 + x, y0 + y, sw, refs[i], 0, 0)
                        mv = self.draw_mv(pred)
                        w.se(mv[0] - pred[0])
                        w.se(mv[1] - pred[1])
                        self.set_motion(x0 + x, y0 + y, sw, sh, refs[i], mv)
                        self.outside(x0 + x, y0 + y, sw, sh, mv)
            small = any(subs)
        cbp = self.draw_cbp()
        w.ue(CODE_INTER[cbp])
        t8 = False
        if cbp & 15 and self.st.t8x8 and not small:
            t8 = bool(r.integers(2))
            self.st.stats['P_transform_8x8'] += t8
            w.u(1, t8)
        if cbp:
            self.qp_delta(w)
        self.residual(w, cbp, intra=False, i16=False, t8=t8)

    # ------------------------------------------------------- residual
    def ls4(self, li, q, pos):
        return self.st.sl4[li][pos] * NORM4[q % 6][(pos >> 2 & 1) + (pos & 1)]

    def ls8(self, li, q, pos):
        rr, cc = pos >> 3, pos & 7
        cls = NORM8_POS[(rr & 3) * 4 + (cc & 3)]
        return self.st.sl8[li][pos] * NORM8[q % 6][cls]

    def deq4(self, c, li, q, pos):
        v = c * self.ls4(li, q, pos)
        s = q // 6
        return v << (s - 4) if q >= 24 else (v + (1 << (3 - s))) >> (4 - s)

    def deq8(self, c, li, q, pos):
        v = c * self.ls8(li, q, pos)
        s = q // 6
        return v << (s - 6) if q >= 36 else (v + (1 << (5 - s))) >> (6 - s)

    def draw_levels(self, n):
        """n coefficients by scan index, most zero."""
        r = self.rng
        st = self.st
        u = r.random()
        if st.dense:
            k = int(r.integers(n // 2, n + 1))
        elif u < 0.35:
            k = 0
        elif u < 0.85:
            k = int(r.integers(1, min(5, n) + 1))
        else:
            k = int(r.integers(1, n + 1))
        out = [0] * n
        if not k:
            return out
        pos = sorted(r.choice(n, k, replace=False))
        for i in pos:
            v = r.random()
            if v < 0.6:
                mag = 1
            elif v < 0.85:
                mag = int(r.integers(2, 4))
            elif v < 0.97 or not st.big_levels:
                mag = int(r.integers(4, 40))
            else:
                mag = int(r.integers(40, 2300))
            out[int(i)] = mag if r.integers(2) else -mag
        return out

    @staticmethod
    def shrink(levels, cost, bound):
        """Halve the largest levels, then drop coefficients, until
        cost(levels) <= bound."""
        while cost(levels) > bound:
            i = max(range(len(levels)), key=lambda j: abs(levels[j]))
            v = levels[i]
            if abs(v) > 1:
                levels[i] = (abs(v) // 2) * (1 if v > 0 else -1)
            else:
                levels[i] = 0
        return levels

    def block4(self, li, q, first):
        """Levels by scan index of a 4x4 block whose coefficients from scan
        index ``first`` are coded; sum of |dequantised| within bound."""
        n = 16 - first
        bound = 30000 if self.st.big_levels and first == 0 else COEF_BOUND - (
            DC_BOUND if first else 0)
        lv = self.draw_levels(n)

        def cost(lv_):
            return sum(abs(self.deq4(c, li, q, ZZ4[i + first]))
                       for i, c in enumerate(lv_))
        if self.st.big_levels and first == 0:
            # a single large level alone in its block, others small
            big = [i for i, c in enumerate(lv) if abs(c) > 40]
            for i in big[1:]:
                lv[i] = 1
            if big:
                others = sum(abs(self.deq4(c, li, q, ZZ4[i]))
                             for i, c in enumerate(lv) if i != big[0])
                if others > 2000:
                    lv = [c if i == big[0] else 0 for i, c in enumerate(lv)]
        return self.shrink(lv, cost, bound)

    def write_block(self, w, nc, coef):
        """residual_block_cavlc of the coefficients ``coef`` (by scan
        index) with nC ``nc``; returns TotalCoeff."""
        nzpos = [i for i, c in enumerate(coef) if c]
        tc = len(nzpos)
        levels = [coef[i] for i in reversed(nzpos)]
        t1 = 0
        for lv in levels:
            if abs(lv) == 1 and t1 < 3:
                t1 += 1
            else:
                break
        sym = tc * 4 + t1
        table = 'chroma_dc' if nc < 0 else '0-1' if nc < 2 else '2-3' \
            if nc < 4 else '4-7' if nc < 8 else '8+'
        self.st.stats['coeff_token_' + table] += 1
        if nc < 0:
            w.u(CDC_LEN[sym], CDC_BITS[sym])
        elif nc < 8:
            tab = 0 if nc < 2 else 1 if nc < 4 else 2
            w.u(CT_LEN[tab][sym], CT_BITS[tab][sym])
        else:
            w.u(6, (tc - 1) * 4 + t1 if tc else 3)
        if not tc:
            return 0
        suffix_len = 1 if tc > 10 and t1 < 3 else 0
        for i, lv in enumerate(levels):
            if i < t1:
                w.u(1, lv < 0)
                continue
            code = 2 * lv - 2 if lv > 0 else -2 * lv - 1
            if i == t1 and t1 < 3:
                code -= 2
            self.write_level(w, code, suffix_len, self.st.stats)
            if suffix_len == 0:
                suffix_len = 1
            if abs(lv) > (3 << (suffix_len - 1)) and suffix_len < 6:
                suffix_len += 1
        total_zeros = nzpos[-1] + 1 - tc
        if tc < len(coef):
            if len(coef) == 4:
                w.u(TZC_LEN[tc - 1][total_zeros],
                    TZC_BITS[tc - 1][total_zeros])
            else:
                w.u(TZ_LEN[tc - 1][total_zeros], TZ_BITS[tc - 1][total_zeros])
        left = total_zeros
        for i in range(tc - 1):
            run = nzpos[tc - 1 - i] - nzpos[tc - 2 - i] - 1
            if left > 0:
                t = min(left, 7) - 1
                w.u(RB_LEN[t][run], RB_BITS[t][run])
            left -= run
        return tc

    @staticmethod
    def write_level(w, code, sl, stats):
        def prefix(n):
            if n >= 15:
                stats[f'level_prefix_{min(n, 16)}'] += 1
            w.u(n, 0)
            w.u(1, 1)
        if sl == 0:
            if code < 14:
                prefix(code)
                return
            if code < 30:
                prefix(14)
                w.u(4, code - 14)
                return
            rest = code - 30
        else:
            if code >> sl < 15:
                prefix(code >> sl)
                w.u(sl, code & ((1 << sl) - 1))
                return
            rest = code - (15 << sl)
        if rest < 4096:
            prefix(15)
            w.u(12, rest)
            return
        p = 16
        while rest - ((1 << (p - 3)) - 4096) >= (1 << (p - 3)):
            p += 1
        prefix(p)
        w.u(p - 3, rest - ((1 << (p - 3)) - 4096))

    def residual(self, w, cbp, intra, i16, t8):
        p = self.pic
        q = self.qp
        li = 0 if intra else 3
        cbp_l, cbp_c = cbp & 15, cbp >> 4
        if i16:
            dc = self.draw_levels(16)

            def dc_cost(lv):
                c = [0] * 16
                for k, v in enumerate(lv):
                    c[ZZ4[k]] = v
                h = [[1, 1, 1, 1], [1, 1, -1, -1], [1, -1, -1, 1],
                     [1, -1, 1, -1]]
                cm = np.array(c).reshape(4, 4)
                f = np.array(h) @ cm @ np.array(h)
                ls = self.ls4(0, q, 0)
                s = q // 6
                vals = [(int(x) * ls) << (s - 6) if q >= 36 else
                        (int(x) * ls + (1 << (5 - s))) >> (6 - s)
                        for x in f.flat]
                return max(abs(v) for v in vals)
            self.shrink(dc, dc_cost, DC_BOUND)
            self.write_block(w, self.nc_luma(0), dc)
        for b8 in range(4):
            lv8 = None
            if t8 and (cbp_l >> b8) & 1:
                lv8 = self.draw_levels(64)

                def cost8(lv):
                    return sum(abs(self.deq8(c, 0 if intra else 1, q, ZZ8[i]))
                               for i, c in enumerate(lv))
                self.shrink(lv8, cost8, COEF_BOUND)
                if not any(lv8):
                    # a coded 8x8 block holds a coefficient, as encoders
                    # write them: FFmpeg's deblocking takes a coded but
                    # empty 8x8 block for one with coefficients where both
                    # chroma QP offsets are equal
                    lv8[0] = 1
            for k in range(4):
                b = b8 * 4 + k
                gy, gx = self.g(b)
                if not (cbp_l >> b8) & 1:
                    p.nz[gy][gx] = 0
                    continue
                nc = self.nc_luma(b)
                if i16:
                    coef = self.block4(li, q, 1)
                elif t8:
                    coef = [lv8[4 * i + k] for i in range(16)]
                else:
                    coef = self.block4(li, q, 0)
                p.nz[gy][gx] = self.write_block(w, nc, coef)
        for c in range(2):
            qc = chroma_qp(q, self.st.chroma_qp_offset[c])
            if cbp_c:
                dc = self.draw_levels(4)
                lic = li + 1 + c

                def cdc_cost(lv):
                    f = [lv[0] + lv[1] + lv[2] + lv[3],
                         lv[0] - lv[1] + lv[2] - lv[3],
                         lv[0] + lv[1] - lv[2] - lv[3],
                         lv[0] - lv[1] - lv[2] + lv[3]]
                    ls = self.ls4(lic, qc, 0)
                    return max(abs(((x * ls) << (qc // 6)) >> 5) for x in f)
                self.shrink(dc, cdc_cost, DC_BOUND)
                self.write_block(w, -1, dc)
        for c in range(2):
            qc = chroma_qp(q, self.st.chroma_qp_offset[c])
            for k in range(4):
                gy, gx = self.mby * 2 + (k >> 1), self.mbx * 2 + (k & 1)
                if cbp_c & 2:
                    nc = self.nc_chroma(c, k)
                    coef = self.block4(li + 1 + c, qc, 1)
                    p.nzc[c][gy][gx] = self.write_block(w, nc, coef)
                else:
                    p.nzc[c][gy][gx] = 0


_QPC = [29, 30, 31, 32, 32, 33, 34, 34, 35, 35, 36, 36, 37, 37, 37, 38, 38,
        38, 39, 39, 39, 39]


def chroma_qp(qp, offset):
    qpi = min(max(qp + offset, 0), 51)
    return qpi if qpi < 30 else _QPC[qpi - 30]


def encode(family, seed, options=None):
    """(access units, (SPS, PPS), gop order, (H, W), profile, the coding
    tools written) of one stream of ``family``, ``options`` overriding
    the family's."""
    opts = dict(FAMILIES[family], **(options or {}))
    rng = np.random.default_rng([seed, sorted(FAMILIES).index(family)])
    st = Stream(rng, **opts)
    units, params, order = st.encode()
    return units, params, order, (st.h, st.w), st.profile, st.stats


def write_stream(path, family, seed, options=None, **mux_kw):
    """Write one stream of ``family`` (``options`` as for ``encode``) as
    an mp4 at ``path``; returns (its frame count, the coding tools
    written: a Counter)."""
    units, params, order, (h, w), profile, stats = encode(family, seed,
                                                          options)
    mux(path, units, params, order, w, h, profile, **mux_kw)
    return len(units), stats
