"""Write small H.264 clips in mp4 whose decoded frames are known exactly:
the fixtures of the port's mp4 path (demuxer, NVDEC, the NV12 -> RGB
kernel, the train loader over a folder of mp4 files).

The stream is CAVLC with every macroblock ``I_PCM`` (raw samples) or
``P_Skip`` (a copy of the co-located macroblock of the previous reference
frame: every motion vector predicts to zero, since each neighbour is
intra or a skip of zero motion) and the deblocking filter off, so every
conforming decoder gives back exactly the planes written:

- an IDR frame every ``gop`` frames, of ``I_PCM`` macroblocks;
- P frames mixing ``I_PCM`` and ``P_Skip`` (``skip`` the share skipped);
- with ``bframes``, non-reference B frames of ``I_PCM`` macroblocks in
  every other display slot (decode order I0 P2 B1 P4 B3 ...), their POC
  in the slice header, a ``ctts`` box, and an edit list that shifts the
  first composition time to 0, as ffmpeg's mp4 muxer writes it;
- SPS frame cropping where the display size is not a multiple of 16.

Samples are 4-byte length-prefixed NAL units at 30 frames a second; the
SPS and PPS sit in the ``avcC`` box only. Nothing here reads or runs a
decoder. ``write_clip`` writes one clip and returns its display planes.
"""

import re
import struct

import numpy as np

MAIN, HIGH = 77, 100
# the media timescale and frame duration ffmpeg's muxer uses at 30 fps
TIMESCALE, FRAME_TICKS = 15360, 512
_LOG2_MAX_FRAME_NUM = 8
_LOG2_MAX_POC_LSB = 8


class BitWriter:
    """MSB-first bits into a bytearray."""

    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.n = 0

    def u(self, nbits, value):
        for i in range(nbits - 1, -1, -1):
            self.acc = (self.acc << 1) | ((value >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.buf.append(self.acc)
                self.acc = self.n = 0

    def ue(self, value):
        code = value + 1
        nbits = code.bit_length()
        self.u(nbits - 1, 0)
        self.u(nbits, code)

    def se(self, value):
        self.ue(2 * value - 1 if value > 0 else -2 * value)

    def align_zero(self):
        while self.n:
            self.u(1, 0)

    def trailing(self):
        """rbsp_trailing_bits: a one, then zeros to the byte."""
        self.u(1, 1)
        self.align_zero()

    def raw(self, data):
        assert self.n == 0, 'raw bytes need byte alignment'
        self.buf += data

    def bytes(self):
        assert self.n == 0
        return bytes(self.buf)


def nal(ref_idc, nal_type, rbsp):
    """A NAL unit: its header, then the RBSP with emulation prevention
    (0x000003 before any 0x0000 followed by a byte <= 3)."""
    ebsp = re.sub(rb'\x00\x00(?=[\x00-\x03])', b'\x00\x00\x03', rbsp)
    return bytes([(ref_idc << 5) | nal_type]) + ebsp


def sps(profile, width_mbs, height_mbs, crop, num_ref, reorder):
    """crop: (left, right, top, bottom) in luma samples (even)."""
    w = BitWriter()
    w.u(8, profile)
    w.u(8, 0)                       # constraint flags, reserved bits
    w.u(8, 51)                      # level 5.1: I_PCM frames are large
    w.ue(0)                         # seq_parameter_set_id
    if profile == HIGH:
        w.ue(1)                     # chroma_format_idc 4:2:0
        w.ue(0)                     # bit_depth_luma_minus8
        w.ue(0)                     # bit_depth_chroma_minus8
        w.u(1, 0)                   # qpprime_y_zero_transform_bypass_flag
        w.u(1, 0)                   # seq_scaling_matrix_present_flag
    w.ue(_LOG2_MAX_FRAME_NUM - 4)
    w.ue(0)                         # pic_order_cnt_type
    w.ue(_LOG2_MAX_POC_LSB - 4)
    w.ue(num_ref)                   # max_num_ref_frames
    w.u(1, 0)                       # gaps_in_frame_num_value_allowed_flag
    w.ue(width_mbs - 1)
    w.ue(height_mbs - 1)
    w.u(1, 1)                       # frame_mbs_only_flag
    w.u(1, 1)                       # direct_8x8_inference_flag
    w.u(1, int(any(crop)))          # frame_cropping_flag
    if any(crop):
        for c in crop:              # CropUnitX = CropUnitY = 2 (4:2:0)
            w.ue(c // 2)
    w.u(1, 1)                       # vui_parameters_present_flag
    w.u(1, 0)                       # aspect_ratio_info_present_flag
    w.u(1, 0)                       # overscan_info_present_flag
    w.u(1, 0)                       # video_signal_type_present_flag
    w.u(1, 0)                       # chroma_loc_info_present_flag
    w.u(1, 0)                       # timing_info_present_flag
    w.u(1, 0)                       # nal_hrd_parameters_present_flag
    w.u(1, 0)                       # vcl_hrd_parameters_present_flag
    w.u(1, 0)                       # pic_struct_present_flag
    w.u(1, 1)                       # bitstream_restriction_flag
    w.u(1, 1)                       # motion_vectors_over_pic_boundaries
    w.ue(0)                         # max_bytes_per_pic_denom
    w.ue(0)                         # max_bits_per_mb_denom
    w.ue(15)                        # log2_max_mv_length_horizontal
    w.ue(15)                        # log2_max_mv_length_vertical
    w.ue(reorder)                   # max_num_reorder_frames
    w.ue(num_ref)                   # max_dec_frame_buffering
    w.trailing()
    return nal(3, 7, w.bytes())


def pps():
    w = BitWriter()
    w.ue(0)                         # pic_parameter_set_id
    w.ue(0)                         # seq_parameter_set_id
    w.u(1, 0)                       # entropy_coding_mode_flag: CAVLC
    w.u(1, 0)                       # bottom_field_pic_order_in_frame_present
    w.ue(0)                         # num_slice_groups_minus1
    w.ue(0)                         # num_ref_idx_l0_default_active_minus1
    w.ue(0)                         # num_ref_idx_l1_default_active_minus1
    w.u(1, 0)                       # weighted_pred_flag
    w.u(2, 0)                       # weighted_bipred_idc
    w.se(0)                         # pic_init_qp_minus26
    w.se(0)                         # pic_init_qs_minus26
    w.se(0)                         # chroma_qp_index_offset
    w.u(1, 1)                       # deblocking_filter_control_present_flag
    w.u(1, 0)                       # constrained_intra_pred_flag
    w.u(1, 0)                       # redundant_pic_cnt_present_flag
    w.trailing()
    return nal(3, 8, w.bytes())


# slice_type + 5 (every slice of the picture of this type); the mb_type of
# I_PCM in each (Table 7-11 offset by the inter types before it)
_SLICE = {'I': (7, 25), 'P': (5, 30), 'B': (6, 48)}


def slice_nal(kind, idr, frame_num, poc_lsb, idr_id, mbs, skipped):
    """One slice of the whole frame. ``mbs``: (n_mb, 384) uint8, each row a
    macroblock's 256 luma then 64 Cb and 64 Cr samples in raster order;
    ``skipped``: (n_mb,) bool, P_Skip macroblocks (P slices only)."""
    slice_type, pcm_type = _SLICE[kind]
    ref = kind != 'B'
    w = BitWriter()
    w.ue(0)                         # first_mb_in_slice
    w.ue(slice_type)
    w.ue(0)                         # pic_parameter_set_id
    w.u(_LOG2_MAX_FRAME_NUM, frame_num)
    if idr:
        w.ue(idr_id)
    w.u(_LOG2_MAX_POC_LSB, poc_lsb)
    if kind == 'B':
        w.u(1, 1)                   # direct_spatial_mv_pred_flag
    if kind != 'I':
        w.u(1, 0)                   # num_ref_idx_active_override_flag
        w.u(1, 0)                   # ref_pic_list_modification_flag_l0
        if kind == 'B':
            w.u(1, 0)               # ref_pic_list_modification_flag_l1
    if ref:                         # dec_ref_pic_marking
        if idr:
            w.u(1, 0)               # no_output_of_prior_pics_flag
            w.u(1, 0)               # long_term_reference_flag
        else:
            w.u(1, 0)               # adaptive_ref_pic_marking_mode_flag
    w.se(0)                         # slice_qp_delta
    w.ue(1)                         # disable_deblocking_filter_idc
    run = 0
    for i in range(len(mbs)):
        if skipped is not None and skipped[i]:
            run += 1
            continue
        if kind != 'I':
            w.ue(run)               # mb_skip_run
        run = 0
        w.ue(pcm_type)              # mb_type I_PCM
        w.align_zero()              # pcm_alignment_zero_bit
        w.raw(mbs[i].tobytes())
    if run:
        w.ue(run)
    w.trailing()
    return nal(2 if ref else 0, 5 if idr else 1, w.bytes())


def _to_mbs(y, u, v):
    """Coded planes -> (n_mb, 384) macroblock rows in raster order."""
    hm, wm = y.shape[0] // 16, y.shape[1] // 16
    ly = y.reshape(hm, 16, wm, 16).transpose(0, 2, 1, 3).reshape(-1, 256)
    cb = u.reshape(hm, 8, wm, 8).transpose(0, 2, 1, 3).reshape(-1, 64)
    cr = v.reshape(hm, 8, wm, 8).transpose(0, 2, 1, 3).reshape(-1, 64)
    return np.concatenate([ly, cb, cr], axis=1)


def gop_order(n_frames, gop, bframes):
    """[(display index, kind, is IDR)] in decode order."""
    order = []
    for g in range(0, n_frames, gop):
        last = min(g + gop, n_frames) - 1
        order.append((g, 'I', True))
        k = g + 1
        while k <= last:
            if bframes and k + 1 <= last:
                order += [(k + 1, 'P', False), (k, 'B', False)]
                k += 2
            else:
                order.append((k, 'P', False))
                k += 1
    return order


def encode(rng, width, height, n_frames, gop=8, bframes=False, skip=0.5,
           profile=MAIN, planes=None):
    """The stream and the frames it decodes to.

    Returns (access units in decode order, each a list of NAL units without
    start codes; the SPS and PPS NAL units; the decode order as
    ``gop_order`` gives it; the display frames' planes (y, u, v): uint8
    (n, height, width), (n, height/2, width/2) twice, cropped to the display
    size). ``planes``: optional (y, u, v) of the coded size to use for every
    I_PCM macroblock of display frame k (``planes[c][k]``), instead of
    random samples."""
    assert width % 2 == 0 and height % 2 == 0
    wm, hm = -(-width // 16), -(-height // 16)
    cw, chh = wm * 16, hm * 16
    crop = (0, cw - width, 0, chh - height)
    order = gop_order(n_frames, gop, bframes)
    num_ref = 2 if bframes else 1
    sps_nal = sps(profile, wm, hm, crop, num_ref, int(bframes))
    pps_nal = pps()
    n_mb = wm * hm
    coded = [None] * n_frames
    units = []
    last_ref = None
    frame_num, idr_id, idr_at = 0, -1, 0
    for disp, kind, idr in order:
        if planes is not None:
            fresh = _to_mbs(planes[0][disp], planes[1][disp],
                            planes[2][disp])
        else:
            fresh = rng.integers(0, 256, (n_mb, 384), dtype=np.uint8)
        skipped = None
        if idr:
            frame_num, idr_id, idr_at = 0, idr_id + 1, disp
        elif kind == 'P':
            skipped = rng.random(n_mb) < skip
            if planes is not None:      # only where the frame repeats
                skipped &= (fresh == last_ref).all(axis=1)
        mbs = fresh if skipped is None else np.where(
            skipped[:, None], last_ref, fresh)
        poc = 2 * (disp - idr_at) % (1 << _LOG2_MAX_POC_LSB)
        units.append([slice_nal(kind, idr, frame_num, poc, idr_id % 65536,
                                mbs, skipped)])
        coded[disp] = mbs
        if kind != 'B':
            last_ref = mbs
            frame_num = (frame_num + 1) % (1 << _LOG2_MAX_FRAME_NUM)
    y = np.empty((n_frames, chh, cw), np.uint8)
    u = np.empty((n_frames, chh // 2, cw // 2), np.uint8)
    v = np.empty_like(u)
    for k, mbs in enumerate(coded):
        y[k] = mbs[:, :256].reshape(hm, wm, 16, 16).transpose(
            0, 2, 1, 3).reshape(chh, cw)
        u[k] = mbs[:, 256:320].reshape(hm, wm, 8, 8).transpose(
            0, 2, 1, 3).reshape(chh // 2, cw // 2)
        v[k] = mbs[:, 320:].reshape(hm, wm, 8, 8).transpose(
            0, 2, 1, 3).reshape(chh // 2, cw // 2)
    return units, (sps_nal, pps_nal), order, (
        y[:, :height, :width], u[:, :height // 2, :width // 2],
        v[:, :height // 2, :width // 2])


# -- mp4 ------------------------------------------------------------------- #

def box(kind, *payload):
    data = b''.join(payload)
    return struct.pack('>I4s', 8 + len(data), kind) + data


def full_box(kind, version, flags, *payload):
    return box(kind, struct.pack('>I', (version << 24) | flags), *payload)


_MATRIX = struct.pack('>9I', 0x10000, 0, 0, 0, 0x10000, 0, 0, 0,
                      0x40000000)


def _avcc(profile, sps_nal, pps_nal):
    out = bytes([1, profile, sps_nal[2], sps_nal[3], 0xFF, 0xE1])
    out += struct.pack('>H', len(sps_nal)) + sps_nal
    out += bytes([1]) + struct.pack('>H', len(pps_nal)) + pps_nal
    if profile == HIGH:             # chroma 4:2:0, 8 bits, no SPS ext
        out += bytes([0xFC | 1, 0xF8, 0xF8, 0])
    return box(b'avcC', out)


def mux(path, units, params, order, width, height, profile=MAIN, chunk=4,
        co64=False, moov_first=False):
    """Write the access units as an mp4 (one avc1 track), ``chunk``
    samples a chunk, ``co64`` offsets or ``stco``, ``moov`` before or
    after ``mdat``. Samples are in decode order; composition offsets
    (``ctts``) and the edit list follow from ``order``'s display indices
    as ffmpeg's muxer sets them."""
    dur = FRAME_TICKS
    n = len(units)
    samples = [b''.join(struct.pack('>I', len(u)) + u for u in au)
               for au in units]
    disp = [d for d, _, _ in order]
    # dts = decode index * dur; cts = display index * dur + shift, where the
    # shift makes every offset >= 0 (the reorder delay)
    shift = max(0, max(i - d for i, d in enumerate(disp))) * dur
    offsets = [d * dur + shift - i * dur for i, d in enumerate(disp)]
    reorder = any(offsets)
    sync = [i + 1 for i, (_, _, idr) in enumerate(order) if idr]

    def moov(mdat_data_at):
        chunks, at = [], mdat_data_at
        for c in range(0, n, chunk):
            chunks.append(at)
            at += sum(len(s) for s in samples[c:c + chunk])
        per = [min(chunk, n - c) for c in range(0, n, chunk)]
        stsc = [(1, per[0], 1)]
        if per[-1] != per[0]:
            stsc.append((len(per), per[-1], 1))
        ctts_runs = []
        for o in offsets:
            if ctts_runs and ctts_runs[-1][1] == o:
                ctts_runs[-1][0] += 1
            else:
                ctts_runs.append([1, o])
        stbl = [
            full_box(b'stsd', 0, 0, struct.pack('>I', 1), box(
                b'avc1', bytes(6), struct.pack('>H', 1), bytes(16),
                struct.pack('>HH', width, height),
                struct.pack('>II', 0x480000, 0x480000), bytes(4),
                struct.pack('>H', 1), bytes(32),
                struct.pack('>Hh', 0x18, -1),
                _avcc(profile, *params))),
            full_box(b'stts', 0, 0, struct.pack('>III', 1, n, dur))]
        if reorder:
            stbl.append(full_box(b'ctts', 0, 0, struct.pack(
                '>I', len(ctts_runs)), *[struct.pack('>II', c, o)
                                         for c, o in ctts_runs]))
        if len(sync) < n:
            stbl.append(full_box(b'stss', 0, 0, struct.pack(
                '>I', len(sync)), *[struct.pack('>I', s) for s in sync]))
        stbl += [
            full_box(b'stsc', 0, 0, struct.pack('>I', len(stsc)),
                     *[struct.pack('>III', *e) for e in stsc]),
            full_box(b'stsz', 0, 0, struct.pack('>II', 0, n),
                     *[struct.pack('>I', len(s)) for s in samples]),
            full_box(b'co64', 0, 0, struct.pack('>I', len(chunks)),
                     *[struct.pack('>Q', c) for c in chunks]) if co64 else
            full_box(b'stco', 0, 0, struct.pack('>I', len(chunks)),
                     *[struct.pack('>I', c) for c in chunks])]
        media_dur = n * dur
        movie_dur = media_dur * 1000 // TIMESCALE
        trak = [full_box(b'tkhd', 0, 3, struct.pack(
            '>IIIII', 0, 0, 1, 0, movie_dur), bytes(8),
            struct.pack('>hhhH', 0, 0, 0, 0), _MATRIX,
            struct.pack('>II', width << 16, height << 16))]
        if reorder:
            trak.append(box(b'edts', full_box(b'elst', 0, 0, struct.pack(
                '>IIiHH', 1, movie_dur, shift, 1, 0))))
        trak.append(box(b'mdia', full_box(b'mdhd', 0, 0, struct.pack(
            '>IIIIHH', 0, 0, TIMESCALE, media_dur, 0x55C4, 0)),
            full_box(b'hdlr', 0, 0, struct.pack('>I4s', 0, b'vide'),
                     bytes(12), b'VideoHandler\x00'),
            box(b'minf', full_box(b'vmhd', 0, 1, bytes(8)),
                box(b'dinf', full_box(b'dref', 0, 0, struct.pack('>I', 1),
                                      full_box(b'url ', 0, 1))),
                box(b'stbl', *stbl))))
        return box(b'moov', full_box(b'mvhd', 0, 0, struct.pack(
            '>IIIIIH', 0, 0, 1000, movie_dur, 0x10000, 0x100), bytes(10),
            _MATRIX, bytes(24), struct.pack('>I', 2)), box(b'trak', *trak))

    ftyp = box(b'ftyp', b'isom', struct.pack('>I', 0x200),
               b'isomiso2avc1mp41')
    payload = b''.join(samples)
    if moov_first:
        size = len(moov(0))         # offsets do not change the size
        head = ftyp + moov(len(ftyp) + size + 8)
        data = head + box(b'mdat', payload)
    else:
        data = ftyp + box(b'mdat', payload) + moov(len(ftyp) + 8)
    with open(path, 'wb') as f:
        f.write(data)


def write_clip(path, seed, width, height, n_frames, gop=8, bframes=False,
               skip=0.5, profile=MAIN, planes=None, **mux_kw):
    """Encode and mux one clip; returns its display planes (y, u, v)."""
    rng = np.random.default_rng(seed)
    units, params, order, frames = encode(rng, width, height, n_frames,
                                          gop, bframes, skip, profile,
                                          planes)
    mux(path, units, params, order, width, height, profile, **mux_kw)
    return frames


def nv12(y, u, v):
    """Planes (..., H, W), (..., H/2, W/2) x 2 -> NV12 (..., H*3/2, W):
    the luma rows, then the chroma rows with Cb and Cr interleaved."""
    uv = np.stack([u, v], axis=-1).reshape(*u.shape[:-1], -1)
    return np.concatenate([y, uv], axis=-2)


def all_chroma_planes(rng, n_frames=1):
    """512 x 512 frames whose 256 x 256 chroma planes hold every (Cb, Cr)
    pair once (Cb = column, Cr = row), the luma random."""
    cb, cr = np.meshgrid(np.arange(256, dtype=np.uint8),
                         np.arange(256, dtype=np.uint8))
    y = rng.integers(0, 256, (n_frames, 512, 512), dtype=np.uint8)
    return y, np.broadcast_to(cb, (n_frames, 256, 256)).copy(), \
        np.broadcast_to(cr, (n_frames, 256, 256)).copy()
