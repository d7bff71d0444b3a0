"""The H.264 sequence parameter set, read without decoding (no counterpart
in the JAX package, which asks cv2 for a clip's frame size after decoding
it): the displayed (H, W), the coded size and the frame cropping, which
the train loader needs to draw another rank's window without decoding
it, and the fields that decide whether the port reads the stream at all.

The port decodes with its host decoder (``data/h264_decode``) and
converts as cv2's swscale does for BT.601 limited-range 4:2:0
(``data/yuv``). Streams outside that raise NotImplementedError naming the
field and the ROADMAP item that will take it: a chroma format other than
4:2:0, a bit depth other than 8 and interlaced coding
(``frame_mbs_only_flag`` 0), which the host decoder does not read, and a
VUI that asks for full range or a matrix other than BT.601 (cv2 converts
those with other coefficients, found against cv2 5.0 in this
repository's tests).
"""

# profile_idc values whose SPS carries chroma_format_idc and bit depths
_HIGH_PROFILES = (100, 110, 122, 244, 44, 83, 86, 118, 128, 138, 139, 134,
                  135)
# matrix_coefficients that swscale converts as BT.601: unspecified (2),
# BT.470BG (5), SMPTE 170M (6)
_BT601 = (2, 5, 6)


def rbsp(nal):
    """A NAL unit's payload without its header byte and with emulation
    prevention removed (every 0x000003 -> 0x0000)."""
    out = bytearray()
    zeros = 0
    for b in nal[1:]:
        if zeros >= 2 and b == 3:
            zeros = 0
            continue
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


class BitReader:
    """MSB-first reader of fixed-width and exp-Golomb codes."""

    def __init__(self, data):
        self.data = data
        self.pos = 0

    def u(self, n):
        v = 0
        for _ in range(n):
            byte = self.pos >> 3
            if byte >= len(self.data):
                raise IOError('H.264 SPS: truncated')
            v = (v << 1) | ((self.data[byte] >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def ue(self):
        zeros = 0
        while self.u(1) == 0:
            zeros += 1
            if zeros > 31:
                raise IOError('H.264 SPS: bad exp-Golomb code')
        return (1 << zeros) - 1 + self.u(zeros)

    def se(self):
        k = self.ue()
        return (k + 1) // 2 if k & 1 else -(k // 2)


def _skip_scaling_list(r, size):
    last = nxt = 8
    for _ in range(size):
        if nxt:
            nxt = (last + r.se() + 256) % 256
        last = nxt or last


def parse_sps(nal):
    """The sizes of the stream of an SPS NAL unit (header byte included):
    a dict with profile_idc, the coded (H, W) ``coded_hw``, ``crop``
    (left, right, top, bottom) in luma samples and the displayed (H, W)
    ``hw``. Raises NotImplementedError naming the field for streams the
    port does not read (module docstring), IOError for a malformed SPS."""
    if not nal or nal[0] & 0x1F != 7:
        raise IOError('H.264: not an SPS NAL unit')
    r = BitReader(rbsp(nal))
    profile = r.u(8)
    r.u(8)                                    # constraint flags
    r.u(8)                                    # level_idc
    r.ue()                                    # seq_parameter_set_id
    chroma, depth_y, depth_c = 1, 8, 8
    if profile in _HIGH_PROFILES:
        chroma = r.ue()
        if chroma == 3:
            r.u(1)                            # separate_colour_plane_flag
        depth_y = r.ue() + 8
        depth_c = r.ue() + 8
        r.u(1)                                # qpprime_y_zero_transform_bypass
        if r.u(1):                            # seq_scaling_matrix_present
            for i in range(8 if chroma != 3 else 12):
                if r.u(1):
                    _skip_scaling_list(r, 16 if i < 6 else 64)
    if chroma != 1:
        raise NotImplementedError(
            f'H.264 chroma_format_idc {chroma} (profile_idc {profile}): the '
            f'host decoder reads 4:2:0 only (ROADMAP Queue 1 item 5e)')
    if depth_y != 8 or depth_c != 8:
        raise NotImplementedError(
            f'H.264 bit_depth_luma {depth_y} / bit_depth_chroma {depth_c}: '
            f'the host decoder reads 8-bit streams only (ROADMAP Queue 1 '
            f'item 5e)')
    r.ue()                                    # log2_max_frame_num_minus4
    poc_type = r.ue()
    if poc_type == 0:
        r.ue()                                # log2_max_pic_order_cnt_lsb_m4
    elif poc_type == 1:
        r.u(1)                                # delta_pic_order_always_zero
        r.se()                                # offset_for_non_ref_pic
        r.se()                                # offset_for_top_to_bottom_field
        for _ in range(r.ue()):
            r.se()                            # offset_for_ref_frame
    r.ue()                                    # max_num_ref_frames
    r.u(1)                                    # gaps_in_frame_num_allowed
    width_mbs = r.ue() + 1
    height_units = r.ue() + 1
    frame_mbs_only = r.u(1)
    if not frame_mbs_only:
        raise NotImplementedError(
            'H.264 frame_mbs_only_flag 0 (interlaced coding): the host '
            'decoder reads progressive streams only (ROADMAP Queue 1 item '
            '5e)')
    r.u(1)                                    # direct_8x8_inference_flag
    crop = (0, 0, 0, 0)
    if r.u(1):                                # frame_cropping_flag
        # CropUnitX = CropUnitY = 2 for progressive 4:2:0
        crop = tuple(2 * r.ue() for _ in range(4))
    full_range = matrix = None
    if r.u(1):                                # vui_parameters_present_flag
        if r.u(1):                            # aspect_ratio_info_present
            if r.u(8) == 255:                 # Extended_SAR
                r.u(32)
        if r.u(1):                            # overscan_info_present_flag
            r.u(1)
        if r.u(1):                            # video_signal_type_present
            r.u(3)                            # video_format
            full_range = r.u(1)
            if r.u(1):                        # colour_description_present
                r.u(8)                        # colour_primaries
                r.u(8)                        # transfer_characteristics
                matrix = r.u(8)
    if full_range:
        raise NotImplementedError(
            'H.264 VUI video_full_range_flag 1: the port converts limited '
            'range only (data/yuv; ROADMAP Queue 1 item 5e)')
    if matrix is not None and matrix not in _BT601:
        raise NotImplementedError(
            f'H.264 VUI matrix_coefficients {matrix}: the port converts '
            f'with BT.601 only (data/yuv; ROADMAP Queue 1 item 5e)')
    coded = (height_units * 16, width_mbs * 16)
    left, right, top, bottom = crop
    hw = (coded[0] - top - bottom, coded[1] - left - right)
    if hw[0] <= 0 or hw[1] <= 0:
        raise IOError(f'H.264 SPS: cropping {crop} leaves no picture of '
                      f'{coded}')
    return {'profile_idc': profile, 'coded_hw': coded, 'crop': crop,
            'hw': hw}
