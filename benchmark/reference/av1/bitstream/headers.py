"""AV1 OBU framing + sequence/frame header codec (uncompressed bits).

Implements the normative header syntax (AV1 spec §5.5 sequence_header_obu,
§5.9 uncompressed_header; reference behavior: av1/encoder/bitstream.c:2612
write_sequence_header, :2865 write_uncompressed_header_obu, and
av1/decoder/obu.c:847 for the read path).  Both writer and parser are
implemented so our own streams round-trip and reference streams can be
inspected/decoded.

Scope note: fields for tools the TPU encoder does not yet emit (timing info,
decoder model, scalability metadata) are supported only in their "absent"
configuration; the parser asserts on inputs that use them.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .bits import BitReader, BitWriter, leb128_decode, leb128_encode
from . import constants as c

PRIMARY_REF_NONE = 7
SUPERRES_DENOM_BITS = 3
SUPERRES_DENOM_MIN = 9
SUPERRES_NUM = 8


# ---------------------------------------------------------------------------
# Sequence header
# ---------------------------------------------------------------------------


@dataclass
class SequenceHeader:
    profile: int = 0
    still_picture: int = 0
    reduced_still_picture_header: int = 0
    operating_point_idc: int = 0
    seq_level_idx: int = 31  # LEVEL_MAX: no level constraints
    seq_tier: int = 0
    max_frame_width: int = 0
    max_frame_height: int = 0
    frame_id_numbers_present: int = 0
    delta_frame_id_length: int = 14
    frame_id_length: int = 15
    use_128x128_superblock: int = 0
    enable_filter_intra: int = 0
    enable_intra_edge_filter: int = 0
    enable_interintra_compound: int = 0
    enable_masked_compound: int = 0
    enable_warped_motion: int = 0
    enable_dual_filter: int = 0
    enable_order_hint: int = 0
    enable_jnt_comp: int = 0
    enable_ref_frame_mvs: int = 0
    force_screen_content_tools: int = 0  # 0/1, or 2 = per-frame choice
    force_integer_mv: int = 2
    order_hint_bits: int = 0
    enable_superres: int = 0
    enable_cdef: int = 0
    enable_restoration: int = 0
    # color_config
    high_bitdepth: int = 0
    twelve_bit: int = 0
    mono_chrome: int = 0
    color_description_present: int = 0
    color_primaries: int = 2      # CP_UNSPECIFIED
    transfer_characteristics: int = 2
    matrix_coefficients: int = 2
    color_range: int = 0
    subsampling_x: int = 1
    subsampling_y: int = 1
    chroma_sample_position: int = 0
    separate_uv_delta_q: int = 0
    film_grain_params_present: int = 0

    @property
    def bit_depth(self) -> int:
        if self.profile == 2 and self.high_bitdepth:
            return 12 if self.twelve_bit else 10
        return 10 if self.high_bitdepth else 8

    @property
    def sb_size_log2(self) -> int:
        return 7 if self.use_128x128_superblock else 6

    @property
    def frame_width_bits(self) -> int:
        return max(1, (self.max_frame_width - 1).bit_length())

    @property
    def frame_height_bits(self) -> int:
        return max(1, (self.max_frame_height - 1).bit_length())


def write_sequence_header(sh: SequenceHeader, w: BitWriter) -> None:
    w.write_literal(sh.profile, 3)
    w.write_bit(sh.still_picture)
    w.write_bit(sh.reduced_still_picture_header)
    assert not sh.reduced_still_picture_header
    w.write_bit(0)  # timing_info_present_flag
    w.write_bit(0)  # initial_display_delay_present_flag
    w.write_literal(0, 5)  # operating_points_cnt_minus_1
    w.write_literal(sh.operating_point_idc, 12)
    w.write_literal(sh.seq_level_idx, 5)
    if sh.seq_level_idx > 7:
        w.write_bit(sh.seq_tier)
    w.write_literal(sh.frame_width_bits - 1, 4)
    w.write_literal(sh.frame_height_bits - 1, 4)
    w.write_literal(sh.max_frame_width - 1, sh.frame_width_bits)
    w.write_literal(sh.max_frame_height - 1, sh.frame_height_bits)
    w.write_bit(sh.frame_id_numbers_present)
    if sh.frame_id_numbers_present:
        w.write_literal(sh.delta_frame_id_length - 2, 4)
        w.write_literal(sh.frame_id_length - sh.delta_frame_id_length - 1, 3)
    w.write_bit(sh.use_128x128_superblock)
    w.write_bit(sh.enable_filter_intra)
    w.write_bit(sh.enable_intra_edge_filter)
    w.write_bit(sh.enable_interintra_compound)
    w.write_bit(sh.enable_masked_compound)
    w.write_bit(sh.enable_warped_motion)
    w.write_bit(sh.enable_dual_filter)
    w.write_bit(sh.enable_order_hint)
    if sh.enable_order_hint:
        w.write_bit(sh.enable_jnt_comp)
        w.write_bit(sh.enable_ref_frame_mvs)
    if sh.force_screen_content_tools == 2:
        w.write_bit(1)
    else:
        w.write_bit(0)
        w.write_bit(sh.force_screen_content_tools)
    if sh.force_screen_content_tools > 0:
        if sh.force_integer_mv == 2:
            w.write_bit(1)
        else:
            w.write_bit(0)
            w.write_bit(sh.force_integer_mv)
    else:
        assert sh.force_integer_mv == 2
    if sh.enable_order_hint:
        w.write_literal(sh.order_hint_bits - 1, 3)
    w.write_bit(sh.enable_superres)
    w.write_bit(sh.enable_cdef)
    w.write_bit(sh.enable_restoration)
    _write_color_config(sh, w)
    w.write_bit(sh.film_grain_params_present)


def _write_color_config(sh: SequenceHeader, w: BitWriter) -> None:
    w.write_bit(sh.high_bitdepth)
    if sh.profile == 2 and sh.high_bitdepth:
        w.write_bit(sh.twelve_bit)
    if sh.profile != 1:
        w.write_bit(sh.mono_chrome)
    w.write_bit(sh.color_description_present)
    if sh.color_description_present:
        w.write_literal(sh.color_primaries, 8)
        w.write_literal(sh.transfer_characteristics, 8)
        w.write_literal(sh.matrix_coefficients, 8)
    if sh.mono_chrome:
        w.write_bit(sh.color_range)
        return
    is_srgb = (sh.color_description_present and sh.color_primaries == 1
               and sh.transfer_characteristics == 13
               and sh.matrix_coefficients == 0)
    if not is_srgb:
        w.write_bit(sh.color_range)
        if sh.profile == 0:
            assert (sh.subsampling_x, sh.subsampling_y) == (1, 1)
        elif sh.profile == 1:
            assert (sh.subsampling_x, sh.subsampling_y) == (0, 0)
        else:
            if sh.bit_depth == 12:
                w.write_bit(sh.subsampling_x)
                if sh.subsampling_x:
                    w.write_bit(sh.subsampling_y)
        if sh.subsampling_x and sh.subsampling_y:
            w.write_literal(sh.chroma_sample_position, 2)
    w.write_bit(sh.separate_uv_delta_q)


def parse_sequence_header(data: bytes) -> SequenceHeader:
    r = BitReader(data)
    sh = SequenceHeader()
    sh.profile = r.read_literal(3)
    sh.still_picture = r.read_bit()
    sh.reduced_still_picture_header = r.read_bit()
    assert not sh.reduced_still_picture_header, "unsupported"
    assert r.read_bit() == 0, "timing info unsupported"
    assert r.read_bit() == 0, "display delay unsupported"
    op_cnt = r.read_literal(5) + 1
    for i in range(op_cnt):
        idc = r.read_literal(12)
        lvl = r.read_literal(5)
        tier = r.read_bit() if lvl > 7 else 0
        if i == 0:
            sh.operating_point_idc, sh.seq_level_idx, sh.seq_tier = \
                idc, lvl, tier
    wbits = r.read_literal(4) + 1
    hbits = r.read_literal(4) + 1
    sh.max_frame_width = r.read_literal(wbits) + 1
    sh.max_frame_height = r.read_literal(hbits) + 1
    sh.frame_id_numbers_present = r.read_bit()
    if sh.frame_id_numbers_present:
        sh.delta_frame_id_length = r.read_literal(4) + 2
        sh.frame_id_length = (r.read_literal(3) + sh.delta_frame_id_length
                              + 1)
    sh.use_128x128_superblock = r.read_bit()
    sh.enable_filter_intra = r.read_bit()
    sh.enable_intra_edge_filter = r.read_bit()
    sh.enable_interintra_compound = r.read_bit()
    sh.enable_masked_compound = r.read_bit()
    sh.enable_warped_motion = r.read_bit()
    sh.enable_dual_filter = r.read_bit()
    sh.enable_order_hint = r.read_bit()
    if sh.enable_order_hint:
        sh.enable_jnt_comp = r.read_bit()
        sh.enable_ref_frame_mvs = r.read_bit()
    sh.force_screen_content_tools = 2 if r.read_bit() else r.read_bit()
    if sh.force_screen_content_tools > 0:
        sh.force_integer_mv = 2 if r.read_bit() else r.read_bit()
    else:
        sh.force_integer_mv = 2
    if sh.enable_order_hint:
        sh.order_hint_bits = r.read_literal(3) + 1
    sh.enable_superres = r.read_bit()
    sh.enable_cdef = r.read_bit()
    sh.enable_restoration = r.read_bit()
    # color config
    sh.high_bitdepth = r.read_bit()
    if sh.profile == 2 and sh.high_bitdepth:
        sh.twelve_bit = r.read_bit()
    sh.mono_chrome = r.read_bit() if sh.profile != 1 else 0
    sh.color_description_present = r.read_bit()
    if sh.color_description_present:
        sh.color_primaries = r.read_literal(8)
        sh.transfer_characteristics = r.read_literal(8)
        sh.matrix_coefficients = r.read_literal(8)
    if sh.mono_chrome:
        sh.color_range = r.read_bit()
        sh.subsampling_x = sh.subsampling_y = 1
        sh.separate_uv_delta_q = 0
    else:
        is_srgb = (sh.color_description_present and sh.color_primaries == 1
                   and sh.transfer_characteristics == 13
                   and sh.matrix_coefficients == 0)
        if is_srgb:
            sh.color_range = 1
            sh.subsampling_x = sh.subsampling_y = 0
        else:
            sh.color_range = r.read_bit()
            if sh.profile == 0:
                sh.subsampling_x = sh.subsampling_y = 1
            elif sh.profile == 1:
                sh.subsampling_x = sh.subsampling_y = 0
            else:
                if sh.bit_depth == 12:
                    sh.subsampling_x = r.read_bit()
                    sh.subsampling_y = r.read_bit() if sh.subsampling_x else 0
                else:
                    sh.subsampling_x, sh.subsampling_y = 1, 0
            if sh.subsampling_x and sh.subsampling_y:
                sh.chroma_sample_position = r.read_literal(2)
        sh.separate_uv_delta_q = r.read_bit()
    sh.film_grain_params_present = r.read_bit()
    return sh


# ---------------------------------------------------------------------------
# Frame header
# ---------------------------------------------------------------------------


@dataclass
class FrameHeader:
    frame_type: int = c.KEY_FRAME
    show_frame: int = 1
    showable_frame: int = 0
    error_resilient_mode: int = 0
    disable_cdf_update: int = 0
    disable_frame_end_update_cdf: int = 0
    allow_screen_content_tools: int = 0
    force_integer_mv: int = 0
    frame_size_override: int = 0
    order_hint: int = 0
    primary_ref_frame: int = PRIMARY_REF_NONE
    refresh_frame_flags: int = 0xFF
    frame_width: int = 0        # coded (superres-downscaled) width
    frame_height: int = 0
    upscaled_width: int = 0     # display width (== frame_width w/o superres)
    render_width: int = 0
    render_height: int = 0
    superres_denom: int = SUPERRES_NUM
    allow_intrabc: int = 0
    # tile info
    tile_cols_log2: int = 0
    tile_rows_log2: int = 0
    uniform_tile_spacing: int = 1
    context_update_tile_id: int = 0
    tile_size_bytes: int = 4
    # quantization
    base_q_idx: int = 0
    delta_q_y_dc: int = 0
    diff_uv_delta: int = 0
    delta_q_u_dc: int = 0
    delta_q_u_ac: int = 0
    delta_q_v_dc: int = 0
    delta_q_v_ac: int = 0
    using_qmatrix: int = 0
    qm_y: int = 0
    qm_u: int = 0
    qm_v: int = 0
    # segmentation / delta q
    segmentation_enabled: int = 0
    seg_update_map: int = 0
    seg_temporal_update: int = 0
    seg_update_data: int = 0
    seg_feature_mask: tuple = (0,) * 8
    seg_feature_data: tuple = tuple((0,) * 8 for _ in range(8))
    seg_preskip: int = 0
    seg_last_active: int = 0
    delta_q_present: int = 0
    delta_q_res_log2: int = 0
    delta_lf_present: int = 0
    delta_lf_res_log2: int = 0
    delta_lf_multi: int = 0
    # loop filter
    filter_level: tuple = (0, 0)
    filter_level_u: int = 0
    filter_level_v: int = 0
    sharpness_level: int = 0
    loop_filter_delta_enabled: int = 0
    # cdef
    cdef_damping: int = 3
    cdef_bits: int = 0
    cdef_y_pri: tuple = (0,)
    cdef_y_sec: tuple = (0,)
    cdef_uv_pri: tuple = (0,)
    cdef_uv_sec: tuple = (0,)
    # restoration: (frame_restoration_type per plane, unit sizes)
    lr_type: tuple = (0, 0, 0)
    lr_unit_shift: int = 0
    lr_uv_shift: int = 0
    # modes
    tx_mode: int = c.ONLY_4X4
    reduced_tx_set: int = 0
    allow_warped_motion: int = 0
    allow_high_precision_mv: int = 0
    interpolation_filter: int = 0
    is_motion_mode_switchable: int = 0
    is_filter_switchable: int = 1
    # inter-frame reference signaling
    ref_order_hints: tuple = (0,) * 8     # per ref slot (error-resilient)
    frame_refs_short_signaling: int = 0
    ref_frame_idx: tuple = (0, 1, 2, 3, 4, 5, 6)
    allow_ref_frame_mvs: int = 0
    reference_mode: int = 0               # 0 single, 1 select
    skip_mode_flag: int = 0
    skip_mode_refs: tuple = ()
    #: encoder-side: primary-ref slot's stored GM params (write context)
    prev_gm_params: tuple | None = None
    gm_type: tuple = (0,) * 7             # global motion per ref (identity)
    # per ref LAST..ALTREF: (wmtype, (wmmat0..5), invalid)
    gm_params: tuple = tuple((0, (0, 0, 65536, 0, 0, 65536), 0)
                             for _ in range(7))
    # loop filter deltas
    ref_deltas: tuple = (1, 0, 0, 0, -1, 0, -1, -1)
    mode_deltas: tuple = (0, 0)
    loop_filter_delta_update: int = 0
    current_frame_id: int = 0
    show_existing_frame: int = 0
    frame_to_show: int = 0
    film_grain: object = None             # FilmGrainParams or None

    def coded_lossless(self, sh: SequenceHeader) -> bool:
        if self.base_q_idx != 0 or self.delta_q_y_dc != 0:
            return False
        if not sh.mono_chrome:
            if (self.delta_q_u_dc or self.delta_q_u_ac or self.delta_q_v_dc
                    or self.delta_q_v_ac):
                return False
        return not self.segmentation_enabled

    @property
    def is_intra(self) -> bool:
        return self.frame_type in (c.KEY_FRAME, c.INTRA_ONLY_FRAME)

    def mi_cols(self) -> int:
        return 2 * ((self.frame_width + 7) >> 3)

    def mi_rows(self) -> int:
        return 2 * ((self.frame_height + 7) >> 3)

    def sb_cols(self, sh: SequenceHeader) -> int:
        sb = 1 << sh.sb_size_log2
        return (self.frame_width + sb - 1) >> sh.sb_size_log2

    def sb_rows(self, sh: SequenceHeader) -> int:
        sb = 1 << sh.sb_size_log2
        return (self.frame_height + sb - 1) >> sh.sb_size_log2


def _write_delta_q(w: BitWriter, v: int) -> None:
    if v:
        w.write_bit(1)
        w.write_inv_signed_literal(v, 6)
    else:
        w.write_bit(0)


def _read_delta_q(r: BitReader) -> int:
    return r.read_inv_signed_literal(6) if r.read_bit() else 0


def write_frame_header(fh: FrameHeader, sh: SequenceHeader,
                       w: BitWriter) -> None:
    """Uncompressed header (spec 5.9.2), mirror of parse_frame_header.

    Inter frames may be non-error-resilient when the sequence enables
    order hints: primary_ref_frame CDF carry, skip mode and
    allow_ref_frame_mvs become codeable (av1_common_int.h:414,985).
    """
    if not fh.is_intra and not fh.error_resilient_mode:
        assert sh.enable_order_hint, \
            "non-ER inter frames need sequence order hints"
    w.write_bit(0)  # show_existing_frame
    w.write_literal(fh.frame_type, 2)
    w.write_bit(fh.show_frame)
    if not fh.show_frame:
        w.write_bit(fh.showable_frame)
    forced_er = (fh.frame_type == c.SWITCH_FRAME or
                 (fh.frame_type == c.KEY_FRAME and fh.show_frame))
    if not forced_er:
        w.write_bit(fh.error_resilient_mode)
    w.write_bit(fh.disable_cdf_update)
    if sh.force_screen_content_tools == 2:
        w.write_bit(fh.allow_screen_content_tools)
    if fh.allow_screen_content_tools and sh.force_integer_mv == 2:
        w.write_bit(fh.force_integer_mv)
    if fh.frame_type != c.SWITCH_FRAME:
        w.write_bit(fh.frame_size_override)
    if sh.enable_order_hint:
        w.write_literal(fh.order_hint, sh.order_hint_bits)
    if not fh.error_resilient_mode and not fh.is_intra:
        w.write_literal(fh.primary_ref_frame, 3)
    keyshow = fh.frame_type == c.KEY_FRAME and fh.show_frame
    if not keyshow and fh.frame_type != c.SWITCH_FRAME:
        w.write_literal(fh.refresh_frame_flags, 8)
    if not fh.is_intra or fh.refresh_frame_flags != 0xFF:
        if fh.error_resilient_mode and sh.enable_order_hint:
            for i in range(8):
                w.write_literal(fh.ref_order_hints[i], sh.order_hint_bits)
    if fh.is_intra:
        _write_frame_size(fh, sh, w)
        if (fh.allow_screen_content_tools
                and fh.superres_denom == SUPERRES_NUM):
            w.write_bit(fh.allow_intrabc)
    else:
        if sh.enable_order_hint:
            w.write_bit(fh.frame_refs_short_signaling)
            assert not fh.frame_refs_short_signaling
        for i in range(7):
            w.write_literal(fh.ref_frame_idx[i], 3)
        if fh.frame_size_override and not fh.error_resilient_mode:
            # frame_size_with_refs (spec 5.9.7): signal found_ref = 0
            # for every slot, then an explicit frame_size() — always
            # decodable without writer-side ref-size bookkeeping
            for _ in range(7):
                w.write_bit(0)
        _write_frame_size(fh, sh, w)
        if not fh.force_integer_mv:
            w.write_bit(fh.allow_high_precision_mv)
        w.write_bit(fh.is_filter_switchable)
        if not fh.is_filter_switchable:
            w.write_literal(fh.interpolation_filter, 2)
        w.write_bit(fh.is_motion_mode_switchable)
        if (not fh.error_resilient_mode and sh.enable_ref_frame_mvs
                and sh.enable_order_hint):
            w.write_bit(fh.allow_ref_frame_mvs)
    if not fh.disable_cdf_update:
        w.write_bit(fh.disable_frame_end_update_cdf)
    _write_tile_info(fh, sh, w)
    _write_quantization_params(fh, sh, w)
    _write_segmentation(fh, w)
    # delta_q_params
    if fh.base_q_idx > 0:
        w.write_bit(fh.delta_q_present)
        if fh.delta_q_present:
            w.write_literal(fh.delta_q_res_log2, 2)
    # delta_lf_params
    if fh.delta_q_present:
        if not fh.allow_intrabc:
            w.write_bit(fh.delta_lf_present)
        if fh.delta_lf_present:
            w.write_literal(fh.delta_lf_res_log2, 2)
            w.write_bit(fh.delta_lf_multi)
    coded_lossless = fh.coded_lossless(sh)
    # loop_filter_params
    if not (coded_lossless or fh.allow_intrabc):
        w.write_literal(fh.filter_level[0], 6)
        w.write_literal(fh.filter_level[1], 6)
        if not sh.mono_chrome:
            if fh.filter_level[0] or fh.filter_level[1]:
                w.write_literal(fh.filter_level_u, 6)
                w.write_literal(fh.filter_level_v, 6)
        w.write_literal(fh.sharpness_level, 3)
        w.write_bit(fh.loop_filter_delta_enabled)
        if fh.loop_filter_delta_enabled:
            # deltas carried at their default values: no update bits set
            w.write_bit(fh.loop_filter_delta_update)
            if fh.loop_filter_delta_update:
                for _ in range(10):
                    w.write_bit(0)
    # cdef_params
    if not (coded_lossless or fh.allow_intrabc) and sh.enable_cdef:
        w.write_literal(fh.cdef_damping - 3, 2)
        w.write_literal(fh.cdef_bits, 2)
        for i in range(1 << fh.cdef_bits):
            w.write_literal(fh.cdef_y_pri[i], 4)
            w.write_literal(fh.cdef_y_sec[i], 2)
            if not sh.mono_chrome:
                w.write_literal(fh.cdef_uv_pri[i], 4)
                w.write_literal(fh.cdef_uv_sec[i], 2)
    # lr_params
    all_lossless = coded_lossless and fh.superres_denom == SUPERRES_NUM
    if not (all_lossless or fh.allow_intrabc) and sh.enable_restoration:
        uses_lr = any(fh.lr_type)
        uses_chroma_lr = any(fh.lr_type[1:])
        for t in fh.lr_type:
            if t in (c.RESTORE_WIENER, c.RESTORE_SGRPROJ):
                w.write_bit(1)
                w.write_bit(t == c.RESTORE_SGRPROJ)
            else:
                w.write_bit(0)
                w.write_bit(t == c.RESTORE_SWITCHABLE)
        if uses_lr:
            if sh.use_128x128_superblock:
                # spec 5.9.20: unit >= 128, one shift bit
                assert fh.lr_unit_shift >= 1
                w.write_bit(fh.lr_unit_shift - 1)
            else:
                w.write_bit(fh.lr_unit_shift >= 1)
                if fh.lr_unit_shift >= 1:
                    w.write_bit(fh.lr_unit_shift >= 2)
            if sh.subsampling_x and sh.subsampling_y and uses_chroma_lr:
                w.write_bit(fh.lr_uv_shift)
    # read_tx_mode
    if not coded_lossless:
        w.write_bit(fh.tx_mode == c.TX_MODE_SELECT)
    if not fh.is_intra:
        w.write_bit(fh.reference_mode)
        _setup_skip_mode(fh, sh)
        if fh.skip_mode_refs:
            w.write_bit(fh.skip_mode_flag)
        else:
            assert not fh.skip_mode_flag
        if not fh.error_resilient_mode and sh.enable_warped_motion:
            w.write_bit(fh.allow_warped_motion)
    w.write_bit(fh.reduced_tx_set)
    if not fh.is_intra:
        _write_global_motion(fh, w)
    if sh.film_grain_params_present and (fh.show_frame
                                         or fh.showable_frame):
        _write_film_grain(fh, sh, w)


def _write_film_grain(fh: FrameHeader, sh: SequenceHeader,
                      w: BitWriter) -> None:
    """av1_write_film_grain_params (bitstream.c): mirror of
    _parse_film_grain; always writes full params (update_parameters=1)."""
    p = fh.film_grain
    w.write_bit(1 if (p is not None and p.apply_grain) else 0)
    if p is None or not p.apply_grain:
        return
    w.write_literal(p.random_seed, 16)
    if fh.frame_type == c.INTER_FRAME:
        w.write_bit(1)  # update_parameters
    w.write_literal(p.num_y_points, 4)
    for (v, s) in p.scaling_points_y:
        w.write_literal(v, 8)
        w.write_literal(s, 8)
    if not sh.mono_chrome:
        w.write_bit(p.chroma_scaling_from_luma)
    if not (sh.mono_chrome or p.chroma_scaling_from_luma
            or (sh.subsampling_x and sh.subsampling_y
                and p.num_y_points == 0)):
        w.write_literal(p.num_cb_points, 4)
        for (v, s) in p.scaling_points_cb:
            w.write_literal(v, 8)
            w.write_literal(s, 8)
        w.write_literal(p.num_cr_points, 4)
        for (v, s) in p.scaling_points_cr:
            w.write_literal(v, 8)
            w.write_literal(s, 8)
    w.write_literal(p.scaling_shift - 8, 2)
    w.write_literal(p.ar_coeff_lag, 2)
    if p.num_y_points:
        for v in p.ar_coeffs_y:
            w.write_literal(v + 128, 8)
    if p.num_cb_points or p.chroma_scaling_from_luma:
        for v in p.ar_coeffs_cb:
            w.write_literal(v + 128, 8)
    if p.num_cr_points or p.chroma_scaling_from_luma:
        for v in p.ar_coeffs_cr:
            w.write_literal(v + 128, 8)
    w.write_literal(p.ar_coeff_shift - 6, 2)
    w.write_literal(p.grain_scale_shift, 2)
    if p.num_cb_points:
        w.write_literal(p.cb_mult, 8)
        w.write_literal(p.cb_luma_mult, 8)
        w.write_literal(p.cb_offset, 9)
    if p.num_cr_points:
        w.write_literal(p.cr_mult, 8)
        w.write_literal(p.cr_luma_mult, 8)
        w.write_literal(p.cr_offset, 9)
    w.write_bit(p.overlap_flag)
    w.write_bit(p.clip_to_restricted_range)


def _recenter_nonneg(ref: int, v: int) -> int:
    if v > 2 * ref:
        return v
    if v >= ref:
        return (v - ref) << 1
    return ((ref - v) << 1) - 1


def _recenter_finite_nonneg(n: int, ref: int, v: int) -> int:
    if 2 * ref <= n:
        return _recenter_nonneg(ref, v)
    return _recenter_nonneg(n - 1 - ref, n - 1 - v)


def _write_primitive_quniform(w: BitWriter, n: int, v: int) -> None:
    if n <= 1:
        return
    lbits = n.bit_length()
    m = (1 << lbits) - n
    if v < m:
        w.write_literal(v, lbits - 1)
    else:
        w.write_literal(m + ((v - m) >> 1), lbits - 1)
        w.write_bit((v - m) & 1)


def _write_primitive_subexpfin(w: BitWriter, n: int, k: int,
                               v: int) -> None:
    i = 0
    mk = 0
    while True:
        b = k + i - 1 if i else k
        a = 1 << b
        if n <= mk + 3 * a:
            _write_primitive_quniform(w, n - mk, v - mk)
            return
        t = int(v >= mk + a)
        w.write_bit(t)
        if not t:
            w.write_literal(v - mk, b)
            return
        i += 1
        mk += a


def _write_signed_primitive_refsubexpfin(w: BitWriter, n: int, k: int,
                                         ref: int, v: int) -> None:
    """aom_wb_write_signed_primitive_refsubexpfin
    (bitwriter_buffer.c:133)."""
    ref += n - 1
    v += n - 1
    scaled_n = (n << 1) - 1
    _write_primitive_subexpfin(w, scaled_n, k,
                               _recenter_finite_nonneg(scaled_n, ref, v))


def _write_global_motion(fh: FrameHeader, w: BitWriter) -> None:
    """write_global_motion_params (bitstream.c): mirror of
    _parse_global_motion.  With a primary ref, params are coded relative
    to that slot's stored params (fh.prev_gm_params, threaded by the
    encoder from its ref-slot state mirror)."""
    prev = getattr(fh, "prev_gm_params", None)
    assert (fh.primary_ref_frame == PRIMARY_REF_NONE or prev is not None
            or all(p[0] == c.IDENTITY for p in fh.gm_params)), \
        "gm write with a primary ref needs prev_gm_params"
    for ref in range(7):
        wmtype, mat, _inv = fh.gm_params[ref]
        ref_mat = _GM_IDENTITY_MAT
        if prev is not None and fh.primary_ref_frame != PRIMARY_REF_NONE:
            ref_mat = prev[ref][1]
        w.write_bit(wmtype != c.IDENTITY)
        if wmtype == c.IDENTITY:
            continue
        w.write_bit(wmtype == c.ROTZOOM)
        if wmtype != c.ROTZOOM:
            w.write_bit(wmtype == c.TRANSLATION)
        if wmtype >= c.ROTZOOM:
            _write_signed_primitive_refsubexpfin(
                w, GM_ALPHA_MAX + 1, 3, (ref_mat[2] >> 1) - (1 << 15),
                (mat[2] >> 1) - (1 << 15))
            _write_signed_primitive_refsubexpfin(
                w, GM_ALPHA_MAX + 1, 3, ref_mat[3] >> 1, mat[3] >> 1)
        if wmtype >= c.AFFINE:
            _write_signed_primitive_refsubexpfin(
                w, GM_ALPHA_MAX + 1, 3, ref_mat[4] >> 1, mat[4] >> 1)
            _write_signed_primitive_refsubexpfin(
                w, GM_ALPHA_MAX + 1, 3, (ref_mat[5] >> 1) - (1 << 15),
                (mat[5] >> 1) - (1 << 15))
        hp = fh.allow_high_precision_mv
        if wmtype == c.TRANSLATION:
            trans_bits = 9 - (not hp)
            trans_prec_diff = 13 + (not hp)
        else:
            trans_bits = 12
            trans_prec_diff = 10
        _write_signed_primitive_refsubexpfin(
            w, (1 << trans_bits) + 1, 3, ref_mat[0] >> trans_prec_diff,
            mat[0] >> trans_prec_diff)
        _write_signed_primitive_refsubexpfin(
            w, (1 << trans_bits) + 1, 3, ref_mat[1] >> trans_prec_diff,
            mat[1] >> trans_prec_diff)


def _write_frame_size(fh: FrameHeader, sh: SequenceHeader,
                      w: BitWriter) -> None:
    if fh.frame_size_override:
        w.write_literal(fh.frame_width - 1, sh.frame_width_bits)
        w.write_literal(fh.frame_height - 1, sh.frame_height_bits)
    if sh.enable_superres:
        if fh.superres_denom != SUPERRES_NUM:
            w.write_bit(1)
            w.write_literal(fh.superres_denom - SUPERRES_DENOM_MIN,
                            SUPERRES_DENOM_BITS)
        else:
            w.write_bit(0)
    if (fh.render_width, fh.render_height) != (fh.frame_width,
                                               fh.frame_height):
        w.write_bit(1)
        w.write_literal(fh.render_width - 1, 16)
        w.write_literal(fh.render_height - 1, 16)
    else:
        w.write_bit(0)


def _write_tile_info(fh: FrameHeader, sh: SequenceHeader,
                     w: BitWriter) -> None:
    sb_cols = fh.sb_cols(sh)
    sb_rows = fh.sb_rows(sh)
    sb_shift = sh.sb_size_log2 - 2
    sb_size = sb_shift + 2
    max_tile_width_sb = 4096 >> sb_size
    max_tile_area_sb = (4096 * 2304) >> (2 * sb_size)
    min_log2_tile_cols = _tile_log2(max_tile_width_sb, sb_cols)
    max_log2_tile_cols = _tile_log2(1, min(sb_cols, c.MAX_TILE_COLS))
    max_log2_tile_rows = _tile_log2(1, min(sb_rows, c.MAX_TILE_ROWS))
    min_log2_tiles = max(min_log2_tile_cols,
                         _tile_log2(max_tile_area_sb, sb_rows * sb_cols))
    assert fh.uniform_tile_spacing, "non-uniform tiles TBD"
    w.write_bit(1)
    lvl = min_log2_tile_cols
    while lvl < max_log2_tile_cols:
        if fh.tile_cols_log2 > lvl:
            w.write_bit(1)
            lvl += 1
        else:
            w.write_bit(0)
            break
    assert fh.tile_cols_log2 == max(lvl, min_log2_tile_cols)
    min_log2_tile_rows = max(min_log2_tiles - fh.tile_cols_log2, 0)
    lvl = min_log2_tile_rows
    while lvl < max_log2_tile_rows:
        if fh.tile_rows_log2 > lvl:
            w.write_bit(1)
            lvl += 1
        else:
            w.write_bit(0)
            break
    if fh.tile_cols_log2 > 0 or fh.tile_rows_log2 > 0:
        w.write_literal(fh.context_update_tile_id,
                        fh.tile_cols_log2 + fh.tile_rows_log2)
        w.write_literal(fh.tile_size_bytes - 1, 2)


def _tile_log2(blk_size: int, target: int) -> int:
    k = 0
    while (blk_size << k) < target:
        k += 1
    return k


def _write_quantization_params(fh: FrameHeader, sh: SequenceHeader,
                               w: BitWriter) -> None:
    w.write_literal(fh.base_q_idx, 8)
    _write_delta_q(w, fh.delta_q_y_dc)
    if not sh.mono_chrome:
        if sh.separate_uv_delta_q:
            w.write_bit(fh.diff_uv_delta)
        _write_delta_q(w, fh.delta_q_u_dc)
        _write_delta_q(w, fh.delta_q_u_ac)
        if fh.diff_uv_delta:
            _write_delta_q(w, fh.delta_q_v_dc)
            _write_delta_q(w, fh.delta_q_v_ac)
    w.write_bit(fh.using_qmatrix)
    if fh.using_qmatrix:
        w.write_literal(fh.qm_y, 4)
        w.write_literal(fh.qm_u, 4)
        if sh.separate_uv_delta_q:
            w.write_literal(fh.qm_v, 4)


def parse_frame_header(data: bytes, sh: SequenceHeader,
                       bit_offset: int = 0,
                       ref_state: dict | None = None
                       ) -> tuple[FrameHeader, int]:
    """Parse an uncompressed header; returns (fh, end_bit_offset).

    ref_state (decoder-maintained, needed for non-error-resilient
    streams): {"order_hints": [8], "ref_deltas": {slot: (ref, mode)}}."""
    r = BitReader(data, bit_offset)
    fh = FrameHeader()
    if r.read_bit():
        fh.show_existing_frame = 1
        fh.frame_to_show = r.read_literal(3)
        assert not sh.frame_id_numbers_present
        return fh, r.bit_offset
    fh.frame_type = r.read_literal(2)
    fh.show_frame = r.read_bit()
    if not fh.show_frame:
        fh.showable_frame = r.read_bit()
    forced_er = (fh.frame_type == c.SWITCH_FRAME or
                 (fh.frame_type == c.KEY_FRAME and fh.show_frame))
    fh.error_resilient_mode = 1 if forced_er else r.read_bit()
    fh.disable_cdf_update = r.read_bit()
    if sh.force_screen_content_tools == 2:
        fh.allow_screen_content_tools = r.read_bit()
    else:
        fh.allow_screen_content_tools = sh.force_screen_content_tools
    if fh.allow_screen_content_tools:
        fh.force_integer_mv = (r.read_bit() if sh.force_integer_mv == 2
                               else sh.force_integer_mv)
    if sh.frame_id_numbers_present:
        fh.current_frame_id = r.read_literal(sh.frame_id_length)
    if fh.frame_type != c.SWITCH_FRAME:
        fh.frame_size_override = r.read_bit()
    else:
        fh.frame_size_override = 1
    if sh.enable_order_hint:
        fh.order_hint = r.read_literal(sh.order_hint_bits)
    fh.primary_ref_frame = PRIMARY_REF_NONE
    if not fh.error_resilient_mode and not fh.is_intra:
        fh.primary_ref_frame = r.read_literal(3)
    keyshow = fh.frame_type == c.KEY_FRAME and fh.show_frame
    if not keyshow and fh.frame_type != c.SWITCH_FRAME:
        fh.refresh_frame_flags = r.read_literal(8)
    if not fh.is_intra or fh.refresh_frame_flags != 0xFF:
        if fh.error_resilient_mode and sh.enable_order_hint:
            fh.ref_order_hints = tuple(
                r.read_literal(sh.order_hint_bits) for _ in range(8))
        elif ref_state is not None:
            fh.ref_order_hints = tuple(ref_state.get("order_hints",
                                                     (0,) * 8))
    if fh.is_intra:
        _parse_frame_size(fh, sh, r)
        if (fh.allow_screen_content_tools
                and fh.superres_denom == SUPERRES_NUM):
            fh.allow_intrabc = r.read_bit()
    else:
        if sh.enable_order_hint:
            fh.frame_refs_short_signaling = r.read_bit()
        assert not fh.frame_refs_short_signaling, "short ref signaling TBD"
        refs = []
        for _ in range(7):
            refs.append(r.read_literal(3))
            if sh.frame_id_numbers_present:
                r.read_literal(sh.delta_frame_id_length)  # delta_frame_id
        fh.ref_frame_idx = tuple(refs)
        if fh.frame_size_override and not fh.error_resilient_mode:
            _parse_frame_size_with_refs(fh, sh, r, ref_state)
        else:
            _parse_frame_size(fh, sh, r)
        if fh.force_integer_mv:
            fh.allow_high_precision_mv = 0
        else:
            fh.allow_high_precision_mv = r.read_bit()
        fh.is_filter_switchable = r.read_bit()
        fh.interpolation_filter = (c.SWITCHABLE if fh.is_filter_switchable
                                   else r.read_literal(2))
        fh.is_motion_mode_switchable = r.read_bit()
        if (not fh.error_resilient_mode and sh.enable_ref_frame_mvs
                and sh.enable_order_hint):
            fh.allow_ref_frame_mvs = r.read_bit()
    fh.disable_frame_end_update_cdf = (1 if fh.disable_cdf_update
                                       else r.read_bit())
    _parse_tile_info(fh, sh, r)
    _parse_quantization_params(fh, sh, r)
    _parse_segmentation(fh, r, ref_state)
    if fh.base_q_idx > 0:
        fh.delta_q_present = r.read_bit()
        if fh.delta_q_present:
            fh.delta_q_res_log2 = r.read_literal(2)
    if fh.delta_q_present:
        if not fh.allow_intrabc:
            fh.delta_lf_present = r.read_bit()
        if fh.delta_lf_present:
            fh.delta_lf_res_log2 = r.read_literal(2)
            fh.delta_lf_multi = r.read_bit()
    coded_lossless = fh.coded_lossless(sh)
    if not (coded_lossless or fh.allow_intrabc):
        f0 = r.read_literal(6)
        f1 = r.read_literal(6)
        fh.filter_level = (f0, f1)
        if not sh.mono_chrome and (f0 or f1):
            fh.filter_level_u = r.read_literal(6)
            fh.filter_level_v = r.read_literal(6)
        fh.sharpness_level = r.read_literal(3)
        # deltas inherit from the primary reference frame (setup_loopfilter)
        if (fh.primary_ref_frame != PRIMARY_REF_NONE
                and ref_state is not None):
            slot = fh.ref_frame_idx[fh.primary_ref_frame]
            prev = ref_state.get("deltas", {}).get(slot)
            if prev is not None:
                fh.ref_deltas, fh.mode_deltas = prev
        fh.loop_filter_delta_enabled = r.read_bit()
        if fh.loop_filter_delta_enabled:
            fh.loop_filter_delta_update = r.read_bit()
            if fh.loop_filter_delta_update:
                rd = list(fh.ref_deltas)
                for i in range(8):
                    if r.read_bit():
                        rd[i] = r.read_inv_signed_literal(6)
                fh.ref_deltas = tuple(rd)
                md = list(fh.mode_deltas)
                for i in range(2):
                    if r.read_bit():
                        md[i] = r.read_inv_signed_literal(6)
                fh.mode_deltas = tuple(md)
    if not (coded_lossless or fh.allow_intrabc) and sh.enable_cdef:
        fh.cdef_damping = r.read_literal(2) + 3
        fh.cdef_bits = r.read_literal(2)
        n = 1 << fh.cdef_bits
        yp, ys, up, us = [], [], [], []
        for _ in range(n):
            yp.append(r.read_literal(4))
            ys.append(r.read_literal(2))
            if not sh.mono_chrome:
                up.append(r.read_literal(4))
                us.append(r.read_literal(2))
        fh.cdef_y_pri, fh.cdef_y_sec = tuple(yp), tuple(ys)
        fh.cdef_uv_pri, fh.cdef_uv_sec = tuple(up), tuple(us)
    all_lossless = coded_lossless and fh.superres_denom == SUPERRES_NUM
    if not (all_lossless or fh.allow_intrabc) and sh.enable_restoration:
        # decode_restoration_mode (decodeframe.c:1494)
        types = []
        for _ in range(3 if not sh.mono_chrome else 1):
            if r.read_bit():
                types.append(c.RESTORE_SGRPROJ if r.read_bit()
                             else c.RESTORE_WIENER)
            else:
                types.append(c.RESTORE_SWITCHABLE if r.read_bit()
                             else c.RESTORE_NONE)
        fh.lr_type = tuple(types + [0] * (3 - len(types)))
        if any(types):
            if sh.use_128x128_superblock:
                # spec 5.9.20: unit >= 128, one shift bit
                shift = r.read_bit() + 1
            else:
                shift = r.read_bit()
                if shift:
                    shift += r.read_bit()
            fh.lr_unit_shift = shift
            if sh.subsampling_x and sh.subsampling_y and any(types[1:]):
                fh.lr_uv_shift = r.read_bit()
    if coded_lossless:
        fh.tx_mode = c.ONLY_4X4
    else:
        fh.tx_mode = c.TX_MODE_SELECT if r.read_bit() else c.TX_MODE_LARGEST
    if not fh.is_intra:
        fh.reference_mode = r.read_bit()
        _setup_skip_mode(fh, sh)
        if fh.skip_mode_refs:
            fh.skip_mode_flag = r.read_bit()
        if (not fh.error_resilient_mode and sh.enable_warped_motion):
            fh.allow_warped_motion = r.read_bit()
    fh.reduced_tx_set = r.read_bit()
    if not fh.is_intra:
        _parse_global_motion(fh, r, ref_state)
    if sh.film_grain_params_present and (fh.show_frame or fh.showable_frame):
        _parse_film_grain(fh, sh, r, ref_state)
    return fh, r.bit_offset


def _parse_film_grain(fh: FrameHeader, sh: SequenceHeader, r: BitReader,
                      ref_state: dict | None) -> None:
    """av1_read_film_grain_params (decodeframe.c:3870)."""
    from ..decoder.grain import FilmGrainParams
    if not r.read_bit():                       # apply_grain
        fh.film_grain = None
        return
    p = FilmGrainParams(apply_grain=1, bit_depth=sh.bit_depth)
    p.random_seed = r.read_literal(16)
    p.update_parameters = (r.read_bit()
                           if fh.frame_type == c.INTER_FRAME else 1)
    if not p.update_parameters:
        ref_idx = r.read_literal(3)
        assert ref_state is not None
        prev = ref_state.get("grain", {}).get(ref_idx)
        assert prev is not None, "film grain ref params unavailable"
        seed = p.random_seed
        p = FilmGrainParams(**{f: getattr(prev, f) for f in
                               ("apply_grain", "num_y_points",
                                "scaling_points_y",
                                "chroma_scaling_from_luma",
                                "num_cb_points", "scaling_points_cb",
                                "num_cr_points", "scaling_points_cr",
                                "scaling_shift", "ar_coeff_lag",
                                "ar_coeffs_y", "ar_coeffs_cb",
                                "ar_coeffs_cr", "ar_coeff_shift",
                                "grain_scale_shift", "cb_mult",
                                "cb_luma_mult", "cb_offset", "cr_mult",
                                "cr_luma_mult", "cr_offset",
                                "overlap_flag",
                                "clip_to_restricted_range",
                                "bit_depth")})
        p.random_seed = seed
        p.update_parameters = 0
        fh.film_grain = p
        return
    p.num_y_points = r.read_literal(4)
    assert p.num_y_points <= 14
    p.scaling_points_y = tuple(
        (r.read_literal(8), r.read_literal(8))
        for _ in range(p.num_y_points))
    p.chroma_scaling_from_luma = (0 if sh.mono_chrome else r.read_bit())
    if (sh.mono_chrome or p.chroma_scaling_from_luma
            or (sh.subsampling_x and sh.subsampling_y
                and p.num_y_points == 0)):
        p.num_cb_points = p.num_cr_points = 0
    else:
        p.num_cb_points = r.read_literal(4)
        p.scaling_points_cb = tuple(
            (r.read_literal(8), r.read_literal(8))
            for _ in range(p.num_cb_points))
        p.num_cr_points = r.read_literal(4)
        p.scaling_points_cr = tuple(
            (r.read_literal(8), r.read_literal(8))
            for _ in range(p.num_cr_points))
    p.scaling_shift = r.read_literal(2) + 8
    p.ar_coeff_lag = r.read_literal(2)
    num_pos_luma = 2 * p.ar_coeff_lag * (p.ar_coeff_lag + 1)
    num_pos_chroma = num_pos_luma + (1 if p.num_y_points else 0)
    if p.num_y_points:
        p.ar_coeffs_y = tuple(r.read_literal(8) - 128
                              for _ in range(num_pos_luma))
    if p.num_cb_points or p.chroma_scaling_from_luma:
        p.ar_coeffs_cb = tuple(r.read_literal(8) - 128
                               for _ in range(num_pos_chroma))
    if p.num_cr_points or p.chroma_scaling_from_luma:
        p.ar_coeffs_cr = tuple(r.read_literal(8) - 128
                               for _ in range(num_pos_chroma))
    p.ar_coeff_shift = r.read_literal(2) + 6
    p.grain_scale_shift = r.read_literal(2)
    if p.num_cb_points:
        p.cb_mult = r.read_literal(8)
        p.cb_luma_mult = r.read_literal(8)
        p.cb_offset = r.read_literal(9)
    if p.num_cr_points:
        p.cr_mult = r.read_literal(8)
        p.cr_luma_mult = r.read_literal(8)
        p.cr_offset = r.read_literal(9)
    p.overlap_flag = r.read_bit()
    p.clip_to_restricted_range = r.read_bit()
    fh.film_grain = p


# seg_feature_data_signed / _max (seg_common.c:19)
SEG_FEATURE_SIGNED = (1, 1, 1, 1, 1, 0, 0, 0)
SEG_FEATURE_MAX = (255, 63, 63, 63, 63, 7, 0, 0)
SEG_FEATURE_BITS = (8, 6, 6, 6, 6, 3, 0, 0)


def _write_segmentation(fh: FrameHeader, w: BitWriter) -> None:
    """Mirror of _parse_segmentation (encoder write_segmentation,
    bitstream.c).  Primary-ref-less frames imply update_map/update_data."""
    w.write_bit(fh.segmentation_enabled)
    if not fh.segmentation_enabled:
        return
    if fh.primary_ref_frame != PRIMARY_REF_NONE:
        w.write_bit(fh.seg_update_map)
        if fh.seg_update_map:
            w.write_bit(fh.seg_temporal_update)
        w.write_bit(fh.seg_update_data)
    if fh.primary_ref_frame == PRIMARY_REF_NONE or fh.seg_update_data:
        for i in range(8):
            for j in range(8):
                active = bool(fh.seg_feature_mask[i] & (1 << j))
                w.write_bit(active)
                if not active:
                    continue
                bits = SEG_FEATURE_BITS[j]
                val = fh.seg_feature_data[i][j]
                if SEG_FEATURE_SIGNED[j]:
                    w.write_literal(val & ((1 << (bits + 1)) - 1),
                                    bits + 1)
                else:
                    w.write_literal(val, bits)


def _parse_segmentation(fh: FrameHeader, r: BitReader,
                        ref_state: dict | None) -> None:
    """setup_segmentation (decodeframe.c:1419)."""
    fh.segmentation_enabled = r.read_bit()
    if not fh.segmentation_enabled:
        return
    if fh.primary_ref_frame == PRIMARY_REF_NONE:
        fh.seg_update_map = 1
        fh.seg_temporal_update = 0
        fh.seg_update_data = 1
    else:
        fh.seg_update_map = r.read_bit()
        fh.seg_temporal_update = r.read_bit() if fh.seg_update_map else 0
        fh.seg_update_data = r.read_bit()
    if fh.seg_update_data:
        mask = [0] * 8
        data = [[0] * 8 for _ in range(8)]
        for i in range(8):
            for j in range(8):
                val = 0
                if r.read_bit():
                    mask[i] |= 1 << j
                    bits = SEG_FEATURE_BITS[j]
                    if SEG_FEATURE_SIGNED[j]:
                        # aom_rb_read_inv_signed_literal: (bits+1)-bit
                        # two's complement
                        raw = r.read_literal(bits + 1)
                        val = raw - (1 << (bits + 1))                             if raw >= (1 << bits) else raw
                        val = max(-SEG_FEATURE_MAX[j],
                                  min(SEG_FEATURE_MAX[j], val))
                    else:
                        val = min(r.read_literal(bits), SEG_FEATURE_MAX[j])
                data[i][j] = val
        fh.seg_feature_mask = tuple(mask)
        fh.seg_feature_data = tuple(tuple(row) for row in data)
    elif ref_state is not None and fh.primary_ref_frame != PRIMARY_REF_NONE:
        slot = fh.ref_frame_idx[fh.primary_ref_frame]
        prev = ref_state.get("seg", {}).get(slot)
        if prev is not None:
            fh.seg_feature_mask, fh.seg_feature_data = prev
    # av1_calculate_segdata
    preskip = 0
    last_active = 0
    for i in range(8):
        for j in range(8):
            if fh.seg_feature_mask[i] & (1 << j):
                if j >= 5:          # SEG_LVL_REF_FRAME
                    preskip = 1
                last_active = i
    fh.seg_preskip = preskip
    fh.seg_last_active = last_active


def _inv_recenter_nonneg(ref: int, v: int) -> int:
    if v > 2 * ref:
        return v
    if v & 1:
        return ref - ((v + 1) >> 1)
    return (v >> 1) + ref


def _inv_recenter_finite_nonneg(n: int, ref: int, v: int) -> int:
    if 2 * ref <= n:
        return _inv_recenter_nonneg(ref, v)
    return n - 1 - _inv_recenter_nonneg(n - 1 - ref, v)


def _read_primitive_quniform(r: BitReader, n: int) -> int:
    if n <= 1:
        return 0
    lbits = n.bit_length()
    m = (1 << lbits) - n
    v = r.read_literal(lbits - 1)
    return v if v < m else (v << 1) - m + r.read_bit()


def _read_primitive_subexpfin(r: BitReader, n: int, k: int) -> int:
    i = 0
    mk = 0
    while True:
        b = k + i - 1 if i else k
        a = 1 << b
        if n <= mk + 3 * a:
            return _read_primitive_quniform(r, n - mk) + mk
        if not r.read_bit():
            return r.read_literal(b) + mk
        i += 1
        mk += a


def _read_signed_primitive_refsubexpfin(r: BitReader, n: int, k: int,
                                        ref: int) -> int:
    """aom_rb_read_signed_primitive_refsubexpfin
    (bitreader_buffer.c:111)."""
    ref += n - 1
    scaled_n = (n << 1) - 1
    return _inv_recenter_finite_nonneg(
        scaled_n, ref, _read_primitive_subexpfin(r, scaled_n, k)) - n + 1


GM_ALPHA_MAX = 1 << 12
GM_TRANS_MAX = 1 << 12
_GM_IDENTITY_MAT = (0, 0, 65536, 0, 0, 65536)


def _parse_global_motion(fh: FrameHeader, r: BitReader,
                         ref_state: dict | None) -> None:
    """read_global_motion (decodeframe.c:4335): per-ref warp model coded
    as subexp diffs relative to the primary-ref frame's stored params."""
    from ..common import warp as WP
    prev = None
    if (fh.primary_ref_frame != PRIMARY_REF_NONE and ref_state is not None):
        slot = fh.ref_frame_idx[fh.primary_ref_frame]
        prev = ref_state.get("gm", {}).get(slot)
    gm_types = []
    gm_params = []
    for ref in range(7):
        ref_mat = prev[ref][1] if prev is not None else _GM_IDENTITY_MAT
        wmtype = c.IDENTITY
        if r.read_bit():
            if r.read_bit():
                wmtype = c.ROTZOOM
            else:
                wmtype = c.TRANSLATION if r.read_bit() else c.AFFINE
        mat = [0, 0, 1 << 16, 0, 0, 1 << 16]
        if wmtype >= c.ROTZOOM:
            # GM_ALPHA_PREC_DIFF=1, GM_ALPHA_DECODE_FACTOR=2
            mat[2] = _read_signed_primitive_refsubexpfin(
                r, GM_ALPHA_MAX + 1, 3,
                (ref_mat[2] >> 1) - (1 << 15)) * 2 + (1 << 16)
            mat[3] = _read_signed_primitive_refsubexpfin(
                r, GM_ALPHA_MAX + 1, 3, ref_mat[3] >> 1) * 2
        if wmtype >= c.AFFINE:
            mat[4] = _read_signed_primitive_refsubexpfin(
                r, GM_ALPHA_MAX + 1, 3, ref_mat[4] >> 1) * 2
            mat[5] = _read_signed_primitive_refsubexpfin(
                r, GM_ALPHA_MAX + 1, 3,
                (ref_mat[5] >> 1) - (1 << 15)) * 2 + (1 << 16)
        elif wmtype == c.ROTZOOM:
            mat[4] = -mat[3]
            mat[5] = mat[2]
        if wmtype >= c.TRANSLATION:
            hp = fh.allow_high_precision_mv
            if wmtype == c.TRANSLATION:
                # GM_ABS_TRANS_ONLY_BITS=9, GM_TRANS_ONLY_PREC_DIFF=13
                trans_bits = 9 - (not hp)
                trans_dec = 1 << (13 + (not hp))
                trans_prec_diff = 13 + (not hp)
            else:
                trans_bits = 12
                trans_dec = 1 << 10
                trans_prec_diff = 10
            mat[0] = _read_signed_primitive_refsubexpfin(
                r, (1 << trans_bits) + 1, 3,
                ref_mat[0] >> trans_prec_diff) * trans_dec
            mat[1] = _read_signed_primitive_refsubexpfin(
                r, (1 << trans_bits) + 1, 3,
                ref_mat[1] >> trans_prec_diff) * trans_dec
        invalid = 0
        if wmtype > c.TRANSLATION:
            ok, *_ = WP.get_shear_params(mat)
            invalid = 0 if ok else 1
        gm_types.append(wmtype)
        gm_params.append((wmtype, tuple(mat), invalid))
    fh.gm_type = tuple(gm_types)
    fh.gm_params = tuple(gm_params)


def _parse_frame_size_with_refs(fh: FrameHeader, sh: SequenceHeader,
                                r, ref_state) -> None:
    """spec 5.9.7 frame_size_with_refs: found_ref copies the ref's
    upscaled + render size, then superres_params derives the coded
    width."""
    found = False
    for i in range(7):
        if r.read_bit():
            found = True
            sizes = (ref_state or {}).get("sizes", {}) \
                .get(fh.ref_frame_idx[i])
            assert sizes is not None, "ref size unavailable for found_ref"
            (fh.upscaled_width, fh.frame_height,
             fh.render_width, fh.render_height) = sizes
            fh.frame_width = fh.upscaled_width
            break
    if not found:
        _parse_frame_size(fh, sh, r)
        return
    # superres_params + compute_image_size
    fh.superres_denom = SUPERRES_NUM
    if sh.enable_superres and r.read_bit():
        fh.superres_denom = r.read_literal(SUPERRES_DENOM_BITS) + \
            SUPERRES_DENOM_MIN
    fh.upscaled_width = fh.frame_width
    if fh.superres_denom != SUPERRES_NUM:
        fh.frame_width = (fh.upscaled_width * SUPERRES_NUM
                          + fh.superres_denom // 2) // fh.superres_denom


def _parse_frame_size(fh: FrameHeader, sh: SequenceHeader,
                      r: BitReader) -> None:
    if fh.frame_size_override:
        fh.frame_width = r.read_literal(sh.frame_width_bits) + 1
        fh.frame_height = r.read_literal(sh.frame_height_bits) + 1
    else:
        fh.frame_width, fh.frame_height = sh.max_frame_width, \
            sh.max_frame_height
    # superres_params (spec 5.9.8): the parsed width is UpscaledWidth;
    # the coded FrameWidth is derived from the denominator
    fh.superres_denom = SUPERRES_NUM
    if sh.enable_superres and r.read_bit():
        fh.superres_denom = r.read_literal(SUPERRES_DENOM_BITS) + \
            SUPERRES_DENOM_MIN
    fh.upscaled_width = fh.frame_width
    if fh.superres_denom != SUPERRES_NUM:
        fh.frame_width = (fh.upscaled_width * SUPERRES_NUM
                          + fh.superres_denom // 2) // fh.superres_denom
    if r.read_bit():
        fh.render_width = r.read_literal(16) + 1
        fh.render_height = r.read_literal(16) + 1
    else:
        fh.render_width = fh.upscaled_width
        fh.render_height = fh.frame_height


def get_relative_dist(sh: SequenceHeader, a: int, b: int) -> int:
    """Signed order-hint distance a-b (spec 5.9.3 get_relative_dist)."""
    if not sh.enable_order_hint:
        return 0
    m = 1 << (sh.order_hint_bits - 1)
    diff = a - b
    return (diff & (m - 1)) - (diff & m)


def _setup_skip_mode(fh: FrameHeader, sh: SequenceHeader) -> None:
    """av1_setup_skip_mode_allowed (av1/common/mvref_common.c:1237):
    nearest fwd + nearest bwd ref, else two nearest fwd refs."""
    fh.skip_mode_refs = ()
    if (not sh.enable_order_hint or fh.is_intra
            or fh.reference_mode == c.SINGLE_REFERENCE):
        return
    cur = fh.order_hint
    fwd = bwd = -1
    fwd_hint, bwd_hint = -1, 1 << 30
    for i in range(7):
        hint = fh.ref_order_hints[fh.ref_frame_idx[i]]
        if get_relative_dist(sh, hint, cur) < 0:
            if fwd < 0 or get_relative_dist(sh, hint, fwd_hint) > 0:
                fwd, fwd_hint = i, hint
        elif get_relative_dist(sh, hint, cur) > 0:
            if bwd < 0 or get_relative_dist(sh, hint, bwd_hint) < 0:
                bwd, bwd_hint = i, hint
    if fwd >= 0 and bwd >= 0:
        fh.skip_mode_refs = (min(fwd, bwd) + 1, max(fwd, bwd) + 1)
    elif fwd >= 0:
        snd, snd_hint = -1, -1
        for i in range(7):
            hint = fh.ref_order_hints[fh.ref_frame_idx[i]]
            if (get_relative_dist(sh, hint, fwd_hint) < 0 and
                    (snd < 0 or get_relative_dist(sh, hint, snd_hint) > 0)):
                snd, snd_hint = i, hint
        if snd >= 0:
            fh.skip_mode_refs = (min(fwd, snd) + 1, max(fwd, snd) + 1)


def _parse_tile_info(fh: FrameHeader, sh: SequenceHeader,
                     r: BitReader) -> None:
    sb_cols = fh.sb_cols(sh)
    sb_rows = fh.sb_rows(sh)
    sb_size = sh.sb_size_log2 - 2 + 2
    max_tile_width_sb = 4096 >> sb_size
    max_tile_area_sb = (4096 * 2304) >> (2 * sb_size)
    min_log2_tile_cols = _tile_log2(max_tile_width_sb, sb_cols)
    max_log2_tile_cols = _tile_log2(1, min(sb_cols, c.MAX_TILE_COLS))
    max_log2_tile_rows = _tile_log2(1, min(sb_rows, c.MAX_TILE_ROWS))
    min_log2_tiles = max(min_log2_tile_cols,
                         _tile_log2(max_tile_area_sb, sb_rows * sb_cols))
    fh.uniform_tile_spacing = r.read_bit()
    assert fh.uniform_tile_spacing, "non-uniform tiles TBD"
    lvl = min_log2_tile_cols
    while lvl < max_log2_tile_cols and r.read_bit():
        lvl += 1
    fh.tile_cols_log2 = lvl
    min_log2_tile_rows = max(min_log2_tiles - fh.tile_cols_log2, 0)
    lvl = min_log2_tile_rows
    while lvl < max_log2_tile_rows and r.read_bit():
        lvl += 1
    fh.tile_rows_log2 = lvl
    if fh.tile_cols_log2 > 0 or fh.tile_rows_log2 > 0:
        fh.context_update_tile_id = r.read_literal(
            fh.tile_cols_log2 + fh.tile_rows_log2)
        fh.tile_size_bytes = r.read_literal(2) + 1


def _parse_quantization_params(fh: FrameHeader, sh: SequenceHeader,
                               r: BitReader) -> None:
    fh.base_q_idx = r.read_literal(8)
    fh.delta_q_y_dc = _read_delta_q(r)
    if not sh.mono_chrome:
        fh.diff_uv_delta = r.read_bit() if sh.separate_uv_delta_q else 0
        fh.delta_q_u_dc = _read_delta_q(r)
        fh.delta_q_u_ac = _read_delta_q(r)
        if fh.diff_uv_delta:
            fh.delta_q_v_dc = _read_delta_q(r)
            fh.delta_q_v_ac = _read_delta_q(r)
        else:
            fh.delta_q_v_dc = fh.delta_q_u_dc
            fh.delta_q_v_ac = fh.delta_q_u_ac
    fh.using_qmatrix = r.read_bit()
    if fh.using_qmatrix:
        fh.qm_y = r.read_literal(4)
        fh.qm_u = r.read_literal(4)
        fh.qm_v = (r.read_literal(4) if sh.separate_uv_delta_q else fh.qm_u)


# ---------------------------------------------------------------------------
# OBU assembly
# ---------------------------------------------------------------------------


def wrap_obu(obu_type: int, payload: bytes, temporal_id: int = 0,
             spatial_id: int = 0) -> bytes:
    """OBU header (has_size_field=1) + leb128 size + payload.  A nonzero
    temporal/spatial id adds the extension byte (spec 5.3.3)."""
    hdr = ((obu_type & 0xF) << 3) | 0x02  # has_size_field
    if temporal_id or spatial_id:
        hdr |= 0x04                       # obu_extension_flag
        ext = ((temporal_id & 7) << 5) | ((spatial_id & 3) << 3)
        return bytes([hdr, ext]) + leb128_encode(len(payload)) + payload
    return bytes([hdr]) + leb128_encode(len(payload)) + payload


def temporal_delimiter() -> bytes:
    return wrap_obu(c.OBU_TEMPORAL_DELIMITER, b"")


def show_existing_frame_obu(map_idx: int) -> bytes:
    """Standalone frame-header OBU displaying ref slot map_idx (spec 5.9.2
    show_existing_frame path; the ARF display mechanism — reference
    behavior: av1/encoder/bitstream.c write_frame_header_obu when
    show_existing_frame).  Assumes no decoder model + no film grain."""
    w = BitWriter()
    w.write_bit(1)                    # show_existing_frame
    w.write_literal(map_idx, 3)       # frame_to_show_map_idx
    w.write_bit(1)                    # trailing one bit
    w.byte_align()
    return wrap_obu(c.OBU_FRAME_HEADER, w.data())


def split_obus(data: bytes):
    """Yield (obu_type, payload) for each OBU in a temporal unit."""
    for obu_type, payload, _tid, _sid in split_obus_ext(data):
        yield obu_type, payload


def split_obus_ext(data: bytes):
    """Yield (obu_type, payload, temporal_id, spatial_id) per OBU."""
    pos = 0
    while pos < len(data):
        hdr = data[pos]
        assert (hdr & 0x80) == 0, "forbidden bit set"
        obu_type = (hdr >> 3) & 0xF
        has_ext = (hdr >> 2) & 1
        has_size = (hdr >> 1) & 1
        pos += 1
        tid = sid = 0
        if has_ext:
            tid = data[pos] >> 5
            sid = (data[pos] >> 3) & 3
            pos += 1
        assert has_size, "size-field-less OBU unsupported"
        size, pos = leb128_decode(data, pos)
        yield obu_type, data[pos:pos + size], tid, sid
        pos += size
