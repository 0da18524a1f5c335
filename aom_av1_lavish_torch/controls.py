"""Encoder control registry — the AV1E_SET_* / arg_defs surface.

Re-designs the reference's control-ID plumbing (aom/aomcx.h AV1E_SET_*,
~390 IDs dispatched through av1/av1_cx_iface.c ctrl handlers, and the
CLI argument table av1/arg_defs.c) as one declarative registry:

  * every control has a canonical name (``AV1E_SET_AQ_MODE``), a CLI /
    set_option key (``aq-mode``), a type + range, and the
    ``EncoderConfig`` field it sets;
  * ``apply_control(cfg, key, value)`` is the aom_codec_control analog;
  * apps/enc.py generates its argparse flags from this table, the way
    aomenc builds its arg list from arg_defs.c.

Each entry records how the value is CONSUMED:

  'encode'   — changes the search / emitted stream (threaded into the
               GOP / all-intra / RT encoders via resolve_tools());
  'header'   — lands in sequence/frame-header bits only;
  'rc'       — consumed by the rate controller;
  'advisory' — validated + stored; the semantics are subsumed by this
               framework's design (e.g. *_COST_UPD_FREQ: the reference
               throttles cost-table refreshes for CPU reasons, while
               our batched device trials recompute costs every frame —
               equivalent to the highest-quality setting 0).

Tool-gate fields default to None = "auto": the speed preset / usage
decides, exactly like the reference where an unset control leaves the
tool available and the speed features prune it.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields

# -- typed control spec ------------------------------------------------------

ENCODE, HEADER, RC, ADVISORY = "encode", "header", "rc", "advisory"


@dataclass(frozen=True)
class Control:
    """One control: canonical ID name + CLI key + range + target field."""
    name: str                 # AV1E_SET_* / AOME_SET_* canonical name
    key: str                  # aomenc-style CLI / set_option key
    field: str                # EncoderConfig attribute it sets
    kind: str = "int"         # int | bool | float | str | enum
    lo: float | None = None
    hi: float | None = None
    choices: tuple = ()
    consumed: str = ENCODE
    help: str = ""

    def parse(self, value):
        """Parse a string (or passthrough) value to the control's type."""
        if self.kind == "bool":
            if isinstance(value, str):
                return value.strip().lower() in ("1", "true", "yes", "on")
            return bool(value)
        if self.kind == "int":
            return int(value)
        if self.kind == "float":
            return float(value)
        if self.kind == "enum":
            v = value.strip() if isinstance(value, str) else value
            if v not in self.choices:
                raise ValueError(
                    f"{self.key}={v!r} not in {self.choices}")
            return v
        if self.kind == "obj":
            return value          # struct/map payload, passed through
        return str(value)

    def check(self, v):
        if self.kind in ("int", "float"):
            if self.lo is not None and v < self.lo:
                raise ValueError(f"{self.key}={v} below minimum {self.lo}")
            if self.hi is not None and v > self.hi:
                raise ValueError(f"{self.key}={v} above maximum {self.hi}")


def _C(name, key, fld, kind="int", lo=None, hi=None, choices=(),
       consumed=ENCODE, help=""):
    return Control(name, key, fld, kind, lo, hi, choices, consumed, help)


# -- the registry ------------------------------------------------------------
# Grouped as aomcx.h groups them.  `field` names match ToolsConfig below.

_CONTROL_LIST = [
    # --- core encode knobs (AOME_*) -----------------------------------
    _C("AOME_SET_CPUUSED", "cpu-used", "cpu_used", "int", 0, 9,
       help="speed preset (speed_features.c:2240 analog)"),
    _C("AOME_SET_CQ_LEVEL", "cq-level", "qindex", "int", 0, 255,
       consumed=RC),
    _C("AOME_SET_SHARPNESS", "sharpness", "sharpness", "int", 0, 7,
       consumed=HEADER,
       help="loop-filter sharpness_level (3-bit header field)"),
    _C("AOME_SET_QUANT_SHARPNESS", "quant-sharpness", "quant_sharpness",
       "int", -7, 7,
       help="lavish: bias zbin/round toward sharpness (quant.py:66)"),
    _C("AOME_SET_ENABLEAUTOALTREF", "auto-alt-ref", "use_arf", "bool"),
    _C("AOME_SET_ENABLEAUTOBWDREF", "auto-bwd-ref", "auto_bwd_ref",
       "int", 0, 2, consumed=ADVISORY,
       help="BWDREF usage rides the GF-group pyramid here"),
    _C("AOME_SET_ARNR_MAXFRAMES", "arnr-maxframes", "arnr_max_frames",
       "int", 0, 15),
    _C("AOME_SET_ARNR_STRENGTH", "arnr-strength", "arnr_strength",
       "int", 0, 6),
    _C("AOME_SET_STATIC_THRESHOLD", "static-thresh", "static_threshold",
       "int", 0, None,
       help="RT early skip: blocks whose prediction SAD/px falls below "
            "force zero-residual coding (nonrd early-skip analog)"),
    _C("AOME_SET_TUNING", "tune", "tune", "enum",
       choices=("psnr", "ssim", "butteraugli", "vmaf", "lavish")),
    _C("AOME_SET_MAX_INTRA_BITRATE_PCT", "max-intra-rate",
       "max_intra_bitrate_pct", "int", 0, None, consumed=RC),
    _C("AV1E_SET_MAX_INTER_BITRATE_PCT", "max-inter-rate",
       "max_inter_bitrate_pct", "int", 0, None, consumed=RC),
    _C("AOME_SET_NUMBER_SPATIAL_LAYERS", "spatial-layers",
       "spatial_layers", "int", 1, 4),
    _C("AOME_SET_SCALEMODE", "scale-mode", "scale_mode", "int", 0, 3,
       consumed=ENCODE,
       help="pre-scale input (1=4/5, 2=3/5, 3=1/2; av1_set_internal_"
            "size analog — Encoder.flush scales and codes that size)"),
    # structured controls (struct/map payloads in the reference ABI);
    # the equivalent functionality lives on explicit encoder APIs here
    _C("AOME_SET_ROI_MAP", "roi-map", "roi_map", "obj",
       consumed=ENCODE,
       help="region-of-interest segment map (aom_roi_map_t analog: "
            "per-16x16 segment ids + per-segment q deltas; lowered "
            "onto AV1 segmentation)"),
    _C("AOME_SET_ACTIVEMAP", "active-map", "active_map", "obj",
       consumed=ENCODE,
       help="active/skip map (aom_active_map_t analog: per-16x16 "
            "flags; inactive blocks code as zero-MV skip on RT inter "
            "frames — av1_apply_active_map)"),
    _C("AOME_SET_SPATIAL_LAYER_ID", "spatial-layer-id",
       "spatial_layer_id", "int", 0, 3, consumed=ADVISORY,
       help="per-frame layer id (the layered encoders in encoder/svc.py "
            "manage ids internally)"),
    _C("AV1E_SET_SVC_LAYER_ID", "svc-layer-id", "svc_layer_id", "obj",
       consumed=ADVISORY, help="aom_svc_layer_id_t analog"),
    _C("AV1E_SET_SVC_PARAMS", "svc-params", "svc_params", "obj",
       consumed=ENCODE,
       help="aom_svc_params_t analog: number_spatial_layers / "
            "number_temporal_layers route Encoder.flush onto the "
            "layered encoders (encoder/svc.py); max_quantizers[0] sets "
            "the base q"),
    _C("AV1E_SET_SVC_REF_FRAME_CONFIG", "svc-ref-frame-config",
       "svc_ref_frame_config", "obj", consumed=ADVISORY),
    _C("AV1E_SET_SVC_REF_FRAME_COMP_PRED", "svc-ref-frame-comp-pred",
       "svc_ref_frame_comp_pred", "obj", consumed=ADVISORY),

    # --- lavish psy / luma-bias family (AOME_*) -----------------------
    _C("AOME_SET_LUMA_BIAS", "luma-bias", "luma_bias", "float", 0, 100,
       help="dark-region rdmult bias (lavish)"),
    _C("AOME_SET_LUMA_BIAS_STRENGTH", "luma-bias-strength",
       "luma_bias_strength", "float", 0, 100),
    _C("AOME_SET_LUMA_BIAS_MIDPOINT", "luma-bias-midpoint",
       "luma_bias_midpoint", "int", 0, 255),
    _C("AOME_SET_LUMA_BIAS_OVERRIDE", "luma-bias-override",
       "luma_bias_override", "bool"),
    _C("AOME_SET_INVERT_LUMA_BIAS", "invert-luma-bias",
       "invert_luma_bias", "bool"),
    _C("AOME_SET_SSIM_RD_MULT", "ssim-rd-mult", "ssim_rd_mult",
       "float", 0, 10),
    _C("AOME_SET_TPL_STRENGTH", "tpl-strength", "tpl_strength",
       "float", 0, 10),
    _C("AOME_SET_DQ_MODULATE", "dq-modulate", "dq_modulate", "bool"),
    _C("AOME_SET_DELTA_QINDEX_MULT", "delta-qindex-mult",
       "delta_qindex_mult", "float", 0, 10),
    _C("AOME_SET_DELTA_QINDEX_MULT_POS", "delta-qindex-mult-pos",
       "delta_qindex_mult_pos", "float", 0, 10),
    _C("AOME_SET_DELTA_QINDEX_MULT_NEG", "delta-qindex-mult-neg",
       "delta_qindex_mult_neg", "float", 0, 10),
    _C("AOME_SET_ENABLE_EXPERIMENTAL_PSY", "enable-experimental-psy",
       "experimental_psy", "bool"),
    _C("AV1E_SET_CHROMA_Q_OFFSET_V", "chroma-q-offset-v",
       "chroma_q_offset_v", "int", -64, 63),
    _C("AV1E_SET_CHROMA_Q_OFFSET_U", "chroma-q-offset-u",
       "chroma_q_offset_u", "int", -64, 63),

    # --- butteraugli tune family --------------------------------------
    _C("AOME_SET_BUTTERAUGLI_HF_ASYMMETRY", "butteraugli-hf-asymmetry",
       "butteraugli_hf_asymmetry", "float", 0, 10),
    _C("AOME_SET_BUTTERAUGLI_INTENSITY_TARGET",
       "butteraugli-intensity-target", "butteraugli_intensity_target",
       "float", 0, 10000),
    _C("AOME_SET_BUTTERAUGLI_LOOP_COUNT", "butteraugli-loop-count",
       "butteraugli_loop_count", "int", 0, 10, consumed=ADVISORY,
       help="our butteraugli rdmult map is computed in one batched pass"),
    _C("AOME_SET_BUTTERAUGLI_QUANT_MULT", "butteraugli-quant-mult",
       "butteraugli_quant_mult", "float", 0, 10),
    _C("AOME_SET_BUTTERAUGLI_QUANT_MULT_POS",
       "butteraugli-quant-mult-pos", "butteraugli_quant_mult_pos",
       "float", 0, 10),
    _C("AOME_SET_BUTTERAUGLI_QUANT_MULT_NEG",
       "butteraugli-quant-mult-neg", "butteraugli_quant_mult_neg",
       "float", 0, 10),
    _C("AOME_SET_BUTTERAUGLI_RDO_BSIZE", "butteraugli-rdo-bsize",
       "butteraugli_rdo_bsize", "int", 4, 128),
    _C("AOME_SET_BUTTERAUGLI_RD_MULT", "butteraugli-rd-mult",
       "butteraugli_rd_mult", "float", 0, 10),
    _C("AOME_SET_BUTTERAUGLI_RESIZE_FACTOR", "butteraugli-resize-factor",
       "butteraugli_resize_factor", "int", 1, 4),

    # --- vmaf tune family ---------------------------------------------
    _C("AOME_SET_VMAF_MOTION_MULT", "vmaf-motion-mult",
       "vmaf_motion_mult", "float", 0, 10),
    _C("AOME_SET_VMAF_PREPROCESSING", "vmaf-preprocessing",
       "vmaf_preprocessing", "bool"),
    _C("AOME_SET_VMAF_QUANTIZATION", "vmaf-quantization",
       "vmaf_quantization", "bool"),
    _C("AOME_SET_VMAF_RD_MULT", "vmaf-rd-mult", "vmaf_rd_mult",
       "float", 0, 10),
    _C("AOME_SET_VMAF_RESIZE_FACTOR", "vmaf-resize-factor",
       "vmaf_resize_factor", "int", 1, 4),
    _C("AV1E_SET_VMAF_MODEL_PATH", "vmaf-model-path", "vmaf_model_path",
       "str", consumed=ADVISORY,
       help="our VIF-based vmaf proxy has no external model file"),

    # --- rate control / GOP (AV1E_*) ----------------------------------
    _C("AV1E_SET_LOSSLESS", "lossless", "lossless", "bool"),
    _C("AV1E_SET_AQ_MODE", "aq-mode", "aq_mode", "int", 0, 3,
       help="0 off, 1 variance, 2 complexity, 3 cyclic refresh"),
    _C("AV1E_SET_DELTAQ_MODE", "deltaq-mode", "deltaq_mode", "int", 0, 6),
    _C("AV1E_SET_DELTAQ_STRENGTH", "deltaq-strength", "deltaq_strength",
       "int", 0, 1000),
    _C("AV1E_SET_DELTALF_MODE", "delta-lf-mode", "deltalf_mode", "bool",
       consumed=ADVISORY, help="per-SB delta-LF syntax not emitted yet"),
    _C("AV1E_SET_MIN_GF_INTERVAL", "min-gf-interval", "min_gf_interval",
       "int", 0, 32),
    _C("AV1E_SET_MAX_GF_INTERVAL", "max-gf-interval", "max_gf_interval",
       "int", 0, 32),
    _C("AV1E_SET_GF_MIN_PYRAMID_HEIGHT", "gf-min-pyr-height",
       "gf_min_pyramid_height", "int", 0, 5, consumed=ADVISORY),
    _C("AV1E_SET_GF_MAX_PYRAMID_HEIGHT", "gf-max-pyr-height",
       "gf_max_pyramid_height", "int", 0, 5, consumed=ADVISORY),
    _C("AV1E_SET_GF_CBR_BOOST_PCT", "gf-cbr-boost", "gf_cbr_boost_pct",
       "int", 0, None, consumed=RC),
    _C("AV1E_SET_MIN_CR", "min-cr", "min_cr", "int", 0, None,
       consumed=ADVISORY),
    _C("AV1E_SET_QUANTIZER_ONE_PASS", "quantizer-one-pass",
       "quantizer_one_pass", "bool", consumed=ADVISORY),
    _C("AV1E_SET_VBR_CORPUS_COMPLEXITY_LAP", "vbr-corpus-complexity-lap",
       "vbr_corpus_complexity_lap", "int", 0, 10000, consumed=ADVISORY),
    _C("AV1E_SET_FRAME_PERIODIC_BOOST", "frame-boost",
       "frame_periodic_boost", "bool", consumed=ADVISORY),
    _C("AV1E_SET_ENABLE_KEYFRAME_FILTERING", "enable-keyframe-filtering",
       "enable_keyframe_filtering", "int", 0, 2,
       help="0 disables the temporal filter on KF/ARF"),
    _C("AV1E_SET_ENABLE_TPL_MODEL", "enable-tpl-model", "enable_tpl",
       "bool"),
    _C("AV1E_SET_ENABLE_OVERLAY", "enable-overlay", "enable_overlay",
       "bool", consumed=ADVISORY,
       help="hidden-ARF groups always emit show_existing overlays"),
    _C("AV1E_SET_RTC_EXTERNAL_RC", "rtc-external-rc", "rtc_external_rc",
       "bool", consumed=ADVISORY,
       help="the RTC rate-control library is a separate public class"),

    # --- quantization matrices ----------------------------------------
    _C("AV1E_SET_ENABLE_QM", "enable-qm", "enable_qm", "bool"),
    _C("AV1E_SET_QM_MIN", "qm-min", "qm_min", "int", 0, 15),
    _C("AV1E_SET_QM_MAX", "qm-max", "qm_max", "int", 0, 15),
    _C("AV1E_SET_QM_Y", "qm-y", "qm_y", "int", 0, 15),
    _C("AV1E_SET_QM_U", "qm-u", "qm_u", "int", 0, 15),
    _C("AV1E_SET_QM_V", "qm-v", "qm_v", "int", 0, 15),
    _C("AV1E_SET_QUANT_B_ADAPT", "quant-b-adapt", "quant_b_adapt",
       "bool", consumed=ADVISORY),
    _C("AV1E_SET_ENABLE_CHROMA_DELTAQ", "enable-chroma-deltaq",
       "enable_chroma_deltaq", "bool"),

    # --- partitions ----------------------------------------------------
    _C("AV1E_SET_ENABLE_RECT_PARTITIONS", "enable-rect-partitions",
       "enable_rect_partitions", "bool"),
    _C("AV1E_SET_ENABLE_AB_PARTITIONS", "enable-ab-partitions",
       "enable_ab_partitions", "bool"),
    _C("AV1E_SET_ENABLE_1TO4_PARTITIONS", "enable-1to4-partitions",
       "enable_1to4_partitions", "bool"),
    _C("AV1E_SET_MIN_PARTITION_SIZE", "min-partition-size",
       "min_partition_size", "int", 4, 128),
    _C("AV1E_SET_MAX_PARTITION_SIZE", "max-partition-size",
       "max_partition_size", "int", 4, 128),
    _C("AV1E_SET_SUPERBLOCK_SIZE", "sb-size", "superblock_size", "enum",
       choices=("dynamic", "64", "128"), consumed=HEADER),
    _C("AV1E_SET_EXTERNAL_PARTITION", "external-partition",
       "external_partition", "str", consumed=ADVISORY,
       help="the Python API takes a callback (lossy.py ext_partition)"),
    _C("AV1E_SET_PARTITION_INFO_PATH", "partition-info-path",
       "partition_info_path", "str", consumed=ADVISORY),

    # --- intra tools ----------------------------------------------------
    _C("AV1E_SET_ENABLE_FILTER_INTRA", "enable-filter-intra",
       "enable_filter_intra", "bool"),
    _C("AV1E_SET_ENABLE_SMOOTH_INTRA", "enable-smooth-intra",
       "enable_smooth_intra", "bool"),
    _C("AV1E_SET_ENABLE_PAETH_INTRA", "enable-paeth-intra",
       "enable_paeth_intra", "bool"),
    _C("AV1E_SET_ENABLE_DIRECTIONAL_INTRA", "enable-directional-intra",
       "enable_directional_intra", "bool"),
    _C("AV1E_SET_ENABLE_DIAGONAL_INTRA", "enable-diagonal-intra",
       "enable_diagonal_intra", "bool"),
    _C("AV1E_SET_ENABLE_ANGLE_DELTA", "enable-angle-delta",
       "enable_angle_delta", "bool"),
    _C("AV1E_SET_ENABLE_CFL_INTRA", "enable-cfl-intra",
       "enable_cfl_intra", "bool"),
    _C("AV1E_SET_ENABLE_INTRA_EDGE_FILTER", "enable-intra-edge-filter",
       "enable_intra_edge_filter", "bool", consumed=HEADER),
    _C("AV1E_SET_ENABLE_PALETTE", "enable-palette", "enable_palette",
       "bool"),
    _C("AV1E_SET_ENABLE_INTRABC", "enable-intrabc", "enable_intrabc",
       "bool"),
    _C("AV1E_SET_AUTO_INTRA_TOOLS_OFF", "auto-intra-tools-off",
       "auto_intra_tools_off", "bool", consumed=ADVISORY),
    _C("AV1E_SET_ENABLE_DIST_8X8", "enable-dist-8x8", "enable_dist_8x8",
       "bool", consumed=ADVISORY, help="removed experiment upstream"),

    # --- transforms -----------------------------------------------------
    _C("AV1E_SET_ENABLE_TX64", "enable-tx64", "enable_tx64", "bool",
       consumed=ADVISORY, help="our RD tx sizes cap at 32x32 today"),
    _C("AV1E_SET_ENABLE_RECT_TX", "enable-rect-tx", "enable_rect_tx",
       "bool", consumed=ADVISORY),
    _C("AV1E_SET_ENABLE_TX_SIZE_SEARCH", "enable-tx-size-search",
       "enable_tx_size_search", "bool"),
    _C("AV1E_SET_ENABLE_FLIP_IDTX", "enable-flip-idtx",
       "enable_flip_idtx", "bool"),
    _C("AV1E_SET_INTRA_DCT_ONLY", "intra-dct-only", "intra_dct_only",
       "bool"),
    _C("AV1E_SET_INTER_DCT_ONLY", "inter-dct-only", "inter_dct_only",
       "bool", consumed=ADVISORY,
       help="inter vartx RD already codes DCT_DCT only"),
    _C("AV1E_SET_INTRA_DEFAULT_TX_ONLY", "intra-default-tx-only",
       "intra_default_tx_only", "bool"),
    _C("AV1E_SET_REDUCED_TX_TYPE_SET", "reduced-tx-type-set",
       "reduced_tx_type_set", "bool"),
    _C("AV1E_SET_DISABLE_TRELLIS_QUANT", "disable-trellis-quant",
       "disable_trellis_quant", "int", 0, 3,
       help=">=1 disables the trellis coeff optimizer"),

    # --- inter tools -----------------------------------------------------
    _C("AV1E_SET_ENABLE_OBMC", "enable-obmc", "enable_obmc", "bool"),
    _C("AV1E_SET_ENABLE_WARPED_MOTION", "enable-warped-motion",
       "enable_warped_motion", "bool", consumed=HEADER),
    _C("AV1E_SET_ALLOW_WARPED_MOTION", "allow-warped-motion",
       "allow_warped_motion", "bool"),
    _C("AV1E_SET_ENABLE_GLOBAL_MOTION", "enable-global-motion",
       "enable_global_motion", "bool"),
    _C("AV1E_SET_ENABLE_MASKED_COMP", "enable-masked-comp",
       "enable_masked_comp", "bool"),
    _C("AV1E_SET_ENABLE_INTERINTER_WEDGE", "enable-interinter-wedge",
       "enable_interinter_wedge", "bool"),
    _C("AV1E_SET_ENABLE_DIFF_WTD_COMP", "enable-diff-wtd-comp",
       "enable_diff_wtd_comp", "bool"),
    _C("AV1E_SET_ENABLE_DIST_WTD_COMP", "enable-dist-wtd-comp",
       "enable_dist_wtd_comp", "bool", consumed=ENCODE,
       help="distance-weighted averaging is not searched yet"),
    _C("AV1E_SET_ENABLE_INTERINTRA_COMP", "enable-interintra-comp",
       "enable_interintra_comp", "bool"),
    _C("AV1E_SET_ENABLE_INTERINTRA_WEDGE", "enable-interintra-wedge",
       "enable_interintra_wedge", "bool"),
    _C("AV1E_SET_ENABLE_SMOOTH_INTERINTRA", "enable-smooth-interintra",
       "enable_smooth_interintra", "bool"),
    _C("AV1E_SET_ENABLE_ONESIDED_COMP", "enable-onesided-comp",
       "enable_onesided_comp", "bool", consumed=ADVISORY),
    _C("AV1E_SET_ENABLE_ORDER_HINT", "enable-order-hint",
       "enable_order_hint", "bool"),
    _C("AV1E_SET_ENABLE_REF_FRAME_MVS", "enable-ref-frame-mvs",
       "enable_ref_frame_mvs", "bool", consumed=HEADER),
    _C("AV1E_SET_ALLOW_REF_FRAME_MVS", "allow-ref-frame-mvs",
       "allow_ref_frame_mvs", "bool", consumed=HEADER),
    _C("AV1E_SET_MAX_REFERENCE_FRAMES", "max-reference-frames",
       "max_reference_frames", "int", 3, 7),
    _C("AV1E_SET_REDUCED_REFERENCE_SET", "reduced-reference-set",
       "reduced_reference_set", "bool"),
    _C("AV1E_SET_ENABLE_DUAL_FILTER", "enable-dual-filter",
       "enable_dual_filter", "bool", consumed=ADVISORY,
       help="interp-filter search is per-frame, not per-direction"),

    # --- in-loop filters --------------------------------------------------
    _C("AV1E_SET_ENABLE_CDEF", "enable-cdef", "enable_cdef", "bool"),
    _C("AV1E_SET_ENABLE_RESTORATION", "enable-restoration",
       "enable_restoration", "bool"),
    _C("AV1E_SET_LOOPFILTER_CONTROL", "loopfilter-control",
       "loopfilter_control", "int", 0, 3,
       help="0 disables deblocking; 1 enables (2/3 map to 1)"),
    _C("AOME_SET_LOOPFILTER_SHARPNESS", "loopfilter-sharpness",
       "sharpness", "int", 0, 7, consumed=HEADER),
    _C("AV1E_SET_SKIP_POSTPROC_FILTERING", "skip-postproc-filtering",
       "skip_postproc_filtering", "bool", consumed=ADVISORY),

    # --- screen / superres / scaling ---------------------------------------
    _C("AV1E_SET_TUNE_CONTENT", "tune-content", "tune_content", "enum",
       choices=("default", "screen", "film")),
    _C("AV1E_SET_ENABLE_SUPERRES", "enable-superres", "enable_superres",
       "bool"),
    _C("AV1E_SET_RENDER_SIZE", "render-size", "render_size", "str",
       consumed=HEADER, help="WxH render_size frame-header field"),
    _C("AV1E_SET_FORCE_VIDEO_MODE", "force-video-mode",
       "force_video_mode", "bool", consumed=ADVISORY),

    # --- film grain / noise -----------------------------------------------
    _C("AV1E_SET_FILM_GRAIN_TEST_VECTOR", "film-grain-test",
       "film_grain_test_vector", "int", 0, 16),
    _C("AV1E_SET_FILM_GRAIN_TABLE", "film-grain-table",
       "film_grain_table", "str"),
    _C("AV1E_SET_DENOISE_NOISE_LEVEL", "denoise-noise-level",
       "denoise_noise_level", "int", 0, 50),
    _C("AV1E_SET_DENOISE_BLOCK_SIZE", "denoise-block-size",
       "denoise_block_size", "int", 16, 128, consumed=ADVISORY),
    _C("AV1E_SET_ENABLE_DNL_DENOISING", "enable-dnl-denoising",
       "enable_dnl_denoising", "bool"),
    _C("AV1E_SET_NOISE_SENSITIVITY", "noise-sensitivity",
       "noise_sensitivity", "int", 0, 6),

    # --- tiles / threading / packetization ---------------------------------
    _C("AV1E_SET_TILE_COLUMNS", "tile-columns", "tile_cols_log2",
       "int", 0, 6),
    _C("AV1E_SET_TILE_ROWS", "tile-rows", "tile_rows_log2", "int", 0, 6),
    _C("AV1E_SET_NUM_TG", "num-tile-groups", "num_tg", "int", 1, 128,
       consumed=HEADER),
    _C("AV1E_SET_MTU", "mtu-size", "mtu", "int", 0, None,
       consumed=ADVISORY),
    _C("AV1E_SET_ROW_MT", "row-mt", "row_mt", "bool", consumed=ADVISORY,
       help="row parallelism is the device wavefront here"),
    _C("AV1E_SET_FP_MT", "fp-mt", "fp_mt", "bool", consumed=ENCODE,
       help="frame-parallel GF groups (FPMT): the GOP encoder runs the "
            "sharded group program (parallel/sharding.py)"),
    _C("AV1E_SET_FP_MT_UNIT_TEST", "fp-mt-unit-test", "fp_mt_unit_test",
       "bool", consumed=ENCODE,
       help="fpmt_unit_test_cfg analog: the FPMT program on one device "
            "(byte-identical to the serial chain by contract)"),
    _C("AV1E_SET_FRAME_PARALLEL_DECODING", "frame-parallel",
       "frame_parallel_decoding", "bool", consumed=HEADER,
       help="1 keeps error-resilient-style CDF independence"),
    _C("AV1E_SET_SINGLE_TILE_DECODING", "single-tile-decoding",
       "single_tile_decoding", "bool", consumed=ADVISORY),

    # --- bitstream state ----------------------------------------------------
    _C("AV1E_SET_ERROR_RESILIENT_MODE", "error-resilient",
       "error_resilient_mode", "bool", consumed=HEADER),
    _C("AV1E_SET_CDF_UPDATE_MODE", "cdf-update-mode", "cdf_update_mode",
       "int", 0, 2,
       help="0: disable_cdf_update in every frame header"),
    _C("AV1E_SET_S_FRAME_MODE", "sframe-mode", "s_frame_mode", "bool",
       consumed=ADVISORY),
    _C("AV1E_SET_MODE_COST_UPD_FREQ", "mode-cost-upd-freq",
       "mode_cost_upd_freq", "int", 0, 3, consumed=ADVISORY,
       help="batched trials recompute costs every frame (== setting 0)"),
    _C("AV1E_SET_MV_COST_UPD_FREQ", "mv-cost-upd-freq",
       "mv_cost_upd_freq", "int", 0, 3, consumed=ADVISORY),
    _C("AV1E_SET_COEFF_COST_UPD_FREQ", "coeff-cost-upd-freq",
       "coeff_cost_upd_freq", "int", 0, 3, consumed=ADVISORY),
    _C("AV1E_SET_DV_COST_UPD_FREQ", "dv-cost-upd-freq",
       "dv_cost_upd_freq", "int", 0, 3, consumed=ADVISORY),

    # --- color / metadata ---------------------------------------------------
    _C("AV1E_SET_COLOR_PRIMARIES", "color-primaries", "color_primaries",
       "int", 0, 25, consumed=HEADER),
    _C("AV1E_SET_TRANSFER_CHARACTERISTICS", "transfer-characteristics",
       "transfer_characteristics", "int", 0, 22, consumed=HEADER),
    _C("AV1E_SET_MATRIX_COEFFICIENTS", "matrix-coefficients",
       "matrix_coefficients", "int", 0, 15, consumed=HEADER),
    _C("AV1E_SET_COLOR_RANGE", "color-range", "color_range", "int",
       0, 1, consumed=HEADER),
    _C("AV1E_SET_CHROMA_SAMPLE_POSITION", "chroma-sample-position",
       "chroma_sample_position", "int", 0, 3, consumed=HEADER),
    _C("AV1E_SET_CHROMA_SUBSAMPLING_X", "chroma-subsampling-x",
       "chroma_subsampling_x", "int", 0, 1, consumed=HEADER),
    _C("AV1E_SET_CHROMA_SUBSAMPLING_Y", "chroma-subsampling-y",
       "chroma_subsampling_y", "int", 0, 1, consumed=HEADER),
    _C("AV1E_SET_TIMING_INFO_TYPE", "timing-info", "timing_info_type",
       "int", 0, 2, consumed=ADVISORY),

    # --- levels / conformance -----------------------------------------------
    _C("AV1E_SET_TARGET_SEQ_LEVEL_IDX", "target-seq-level-idx", "level",
       "int", -1, 31, consumed=HEADER),
    _C("AV1E_SET_TIER_MASK", "tier-mask", "tier_mask", "int", 0, None,
       consumed=ADVISORY),
    _C("AV1E_SET_RATE_DISTRIBUTION_INFO", "rate-distribution-info",
       "rate_distribution_info", "str", consumed=ADVISORY),
]

CONTROLS: dict[str, Control] = {ctl.name: ctl for ctl in _CONTROL_LIST}
BY_KEY: dict[str, Control] = {ctl.key: ctl for ctl in _CONTROL_LIST}
assert len(CONTROLS) == len(_CONTROL_LIST), "duplicate control name"


# alternate macro spellings the reference header also defines for the
# same control IDs (aomcx.h AOM_CTRL_AOME_SET_* duplicate defines)
ALIASES = {
    "AOME_SET_MAX_INTER_BITRATE_PCT": "AV1E_SET_MAX_INTER_BITRATE_PCT",
    "AOME_SET_CHROMA_Q_OFFSET_V": "AV1E_SET_CHROMA_Q_OFFSET_V",
}


def apply_control(cfg, name_or_key: str, value) -> None:
    """aom_codec_control / aom_codec_set_option analog: parse, range
    check, and set the mapped EncoderConfig field."""
    name_or_key = ALIASES.get(name_or_key, name_or_key)
    ctl = CONTROLS.get(name_or_key) or BY_KEY.get(name_or_key)
    if ctl is None:
        raise KeyError(f"unknown control {name_or_key!r}")
    v = ctl.parse(value)
    ctl.check(v)
    setattr(cfg, ctl.field, v)
    if ctl.field == "svc_params" and isinstance(v, dict):
        # AV1E_SET_SVC_PARAMS (aom_svc_params_t): the layer counts
        # drive the layered encode path directly (Encoder.flush routes
        # to encoder/svc.py when either exceeds 1); per-layer q lands
        # on the base qindex
        if "number_spatial_layers" in v:
            cfg.spatial_layers = int(v["number_spatial_layers"])
        if "number_temporal_layers" in v:
            cfg.temporal_layers = int(v["number_temporal_layers"])
        qs = v.get("max_quantizers")
        if qs:
            cfg.qindex = int(qs[0]) * 4 if int(qs[0]) <= 63 \
                else int(qs[0])


# -- the tool-gate config block ----------------------------------------------
# EncoderConfig inherits this; every Control.field above must exist here
# or on EncoderConfig itself.  None = auto (usage/speed preset decides).


@dataclass
class ToolsConfig:
    """Tool gates + tuning knobs the control registry writes into.

    Mirrors the union of aom_codec_enc_cfg_t extension fields and the
    AV1E_SET_* control state (av1/encoder/encoder.h AV1EncoderConfig);
    resolve_tools() lowers these onto the encoders' search knobs."""

    # speed/quality + psy
    sharpness: int = 0
    quant_sharpness: int = 0
    luma_bias_strength: float | None = None
    luma_bias_midpoint: int | None = None
    luma_bias_override: bool = False
    invert_luma_bias: bool = False
    ssim_rd_mult: float | None = None
    tpl_strength: float | None = None
    dq_modulate: bool = False
    delta_qindex_mult: float | None = None
    delta_qindex_mult_pos: float | None = None
    delta_qindex_mult_neg: float | None = None
    experimental_psy: bool = False
    butteraugli_hf_asymmetry: float | None = None
    butteraugli_intensity_target: float | None = None
    butteraugli_loop_count: int = 1
    butteraugli_quant_mult: float | None = None
    butteraugli_quant_mult_pos: float | None = None
    butteraugli_quant_mult_neg: float | None = None
    butteraugli_rdo_bsize: int | None = None
    butteraugli_rd_mult: float | None = None
    butteraugli_resize_factor: int = 1
    vmaf_motion_mult: float | None = None
    vmaf_preprocessing: bool = False
    vmaf_quantization: bool = False
    vmaf_rd_mult: float | None = None
    vmaf_resize_factor: int = 1
    vmaf_model_path: str = ""
    # GOP / rc extensions
    auto_bwd_ref: int = 0
    arnr_max_frames: int = 7
    arnr_strength: int = 5
    static_threshold: int = 0
    max_intra_bitrate_pct: int = 0
    max_inter_bitrate_pct: int = 0
    min_gf_interval: int = 0
    max_gf_interval: int = 0
    gf_min_pyramid_height: int = 0
    gf_max_pyramid_height: int = 5
    gf_cbr_boost_pct: int = 0
    min_cr: int = 0
    quantizer_one_pass: bool = False
    vbr_corpus_complexity_lap: int = 0
    frame_periodic_boost: bool = False
    enable_keyframe_filtering: int = 1
    enable_tpl: bool = True
    enable_overlay: bool = True
    rtc_external_rc: bool = False
    scale_mode: int = 0
    spatial_layers: int = 1
    # structured controls (struct/map payloads)
    roi_map: object = None
    active_map: object = None
    spatial_layer_id: int = 0
    svc_layer_id: object = None
    svc_params: object = None
    svc_ref_frame_config: object = None
    svc_ref_frame_comp_pred: object = None
    temporal_layers: int = 1
    # quantization
    aq_mode: int = 0
    deltaq_mode: int = 0
    deltaq_strength: int = 100
    deltalf_mode: bool = False
    enable_qm: bool = False
    qm_min: int = 5
    qm_max: int = 9
    qm_y: int | None = None
    qm_u: int | None = None
    qm_v: int | None = None
    quant_b_adapt: bool = False
    enable_chroma_deltaq: bool = False
    chroma_q_offset_u: int = 0
    chroma_q_offset_v: int = 0
    # partitions
    enable_rect_partitions: bool | None = None
    enable_ab_partitions: bool | None = None
    enable_1to4_partitions: bool | None = None
    min_partition_size: int = 4
    max_partition_size: int = 128
    superblock_size: str = "dynamic"
    external_partition: str = ""
    partition_info_path: str = ""
    # intra tools
    enable_filter_intra: bool | None = None
    enable_smooth_intra: bool | None = None
    enable_paeth_intra: bool | None = None
    enable_directional_intra: bool | None = None
    enable_diagonal_intra: bool | None = None
    enable_angle_delta: bool | None = None
    enable_cfl_intra: bool | None = None
    enable_intra_edge_filter: bool = False
    enable_palette: bool | None = None
    enable_intrabc: bool | None = None
    auto_intra_tools_off: bool = False
    enable_dist_8x8: bool = False
    # transforms
    enable_tx64: bool = True
    enable_rect_tx: bool = True
    enable_tx_size_search: bool | None = None
    enable_flip_idtx: bool | None = None
    intra_dct_only: bool = False
    inter_dct_only: bool = False
    intra_default_tx_only: bool = False
    reduced_tx_type_set: bool = False
    disable_trellis_quant: int = 0
    # inter tools
    enable_obmc: bool | None = None
    enable_warped_motion: bool | None = None
    allow_warped_motion: bool | None = None
    enable_global_motion: bool | None = None
    enable_masked_comp: bool | None = None
    enable_interinter_wedge: bool | None = None
    enable_diff_wtd_comp: bool | None = None
    enable_dist_wtd_comp: bool | None = None
    enable_interintra_comp: bool | None = None
    enable_interintra_wedge: bool | None = None
    enable_smooth_interintra: bool | None = None
    enable_onesided_comp: bool = True
    enable_order_hint: bool | None = None
    enable_ref_frame_mvs: bool | None = None
    allow_ref_frame_mvs: bool | None = None
    max_reference_frames: int = 7
    reduced_reference_set: bool = False
    enable_dual_filter: bool = True
    # in-loop filters
    enable_restoration: bool | None = None
    loopfilter_control: int = 1
    skip_postproc_filtering: bool = False
    # screen / superres / scaling
    tune_content: str = "default"
    enable_superres: bool = False
    superres_denom: int = 8
    render_size: str = ""
    force_video_mode: bool = False
    # film grain / noise
    film_grain_test_vector: int = 0
    film_grain_table: str = ""
    denoise_noise_level: int = 0
    denoise_block_size: int = 32
    enable_dnl_denoising: bool = True
    noise_sensitivity: int = 0
    # tiles / threading / packetization
    num_tg: int = 1
    mtu: int = 0
    row_mt: bool = True
    fp_mt: bool = False
    fp_mt_unit_test: bool = False
    frame_parallel_decoding: bool = False
    single_tile_decoding: bool = False
    # bitstream state
    error_resilient_mode: bool = False
    cdf_update_mode: int = 1
    s_frame_mode: bool = False
    mode_cost_upd_freq: int = 0
    mv_cost_upd_freq: int = 0
    coeff_cost_upd_freq: int = 0
    dv_cost_upd_freq: int = 0
    # color / metadata
    color_primaries: int = 2
    transfer_characteristics: int = 2
    matrix_coefficients: int = 2
    color_range: int = 0
    chroma_sample_position: int = 0
    chroma_subsampling_x: int = 1
    chroma_subsampling_y: int = 1
    timing_info_type: int = 0
    # levels / misc
    tier_mask: int = 0
    rate_distribution_info: str = ""


def validate_tools(cfg) -> None:
    """Registry-driven range validation of every control-backed field
    (the RANGE_CHECK block of av1_cx_iface.c:805 for extension state)."""
    for ctl in _CONTROL_LIST:
        v = getattr(cfg, ctl.field, None)
        if v is None:
            continue
        if ctl.kind in ("int", "float") and not isinstance(v, bool):
            ctl.check(v)
        elif ctl.kind == "enum" and v not in ctl.choices:
            raise ValueError(f"{ctl.key}={v!r} not in {ctl.choices}")
    if cfg.qm_min > cfg.qm_max:
        raise ValueError("qm-min > qm-max")
    if cfg.min_partition_size > cfg.max_partition_size:
        raise ValueError("min-partition-size > max-partition-size")
    for f in ("min_partition_size", "max_partition_size"):
        v = getattr(cfg, f)
        if v & (v - 1):
            raise ValueError(f"{f}={v} must be a power of two")
    if cfg.render_size:
        try:
            w, h = cfg.render_size.lower().split("x")
            int(w), int(h)
        except Exception:
            raise ValueError("render-size must be WxH") from None


# -- lowering onto the encoders' knobs ----------------------------------------

def resolve_mode_set(cfg):
    """Intra tool gates -> the lossy searcher's candidate mode tuple.
    None when every gate is auto (preset keeps its own set).
    Mirrors intra_mode_cfg consumption in av1/encoder/rdopt.c."""
    from .bitstream import constants as c
    gates = (cfg.enable_smooth_intra, cfg.enable_paeth_intra,
             cfg.enable_directional_intra, cfg.enable_diagonal_intra)
    if all(g is None for g in gates):
        return None
    modes = set(range(c.INTRA_MODES))
    if cfg.enable_smooth_intra is False:
        modes -= {c.SMOOTH_PRED, c.SMOOTH_V_PRED, c.SMOOTH_H_PRED}
    if cfg.enable_paeth_intra is False:
        modes -= {c.PAETH_PRED}
    directional = set(range(c.V_PRED, c.D67_PRED + 1))
    if cfg.enable_directional_intra is False:
        modes -= directional
    elif cfg.enable_diagonal_intra is False:
        modes -= directional - {c.V_PRED, c.H_PRED}
    return tuple(sorted(modes))


def resolve_tools(cfg) -> dict:
    """Lower the control state onto encoder kwargs.

    Returns a dict split by consumer:
      'gop'    — GopEncoder(...) keyword overrides
      'search' — per-frame searcher overrides (LossyAllIntraEncoder /
                 InterEncoder kwargs, applied after the speed preset)
      'seq'    — make_sequence_header extras
    """
    gop, search, seq = {}, {}, {}

    mode_set = resolve_mode_set(cfg)
    if mode_set is not None:
        search["mode_set"] = mode_set
    if cfg.enable_cfl_intra is not None:
        search["enable_cfl"] = cfg.enable_cfl_intra
    if cfg.enable_rect_partitions is not None:
        search["rect_parts"] = cfg.enable_rect_partitions
    if (cfg.enable_ab_partitions is not None
            or cfg.enable_1to4_partitions is not None):
        # one geometry gate covers both shape families in this searcher
        search["ext_parts"] = bool(cfg.enable_ab_partitions
                                   or cfg.enable_1to4_partitions)
    if cfg.disable_trellis_quant:
        search["trellis"] = False
    if cfg.enable_tx_size_search is not None:
        gop["tx_select"] = cfg.enable_tx_size_search
    if (cfg.intra_dct_only or cfg.intra_default_tx_only
            or cfg.reduced_tx_type_set
            or cfg.enable_flip_idtx is False):
        # collapse the tx-type gates to "skip the tx-type RD search"
        # (the default tx type is DCT_DCT, what intra_dct_only wants)
        search["tx_search"] = False
    if cfg.quant_sharpness:
        search["sharpness"] = cfg.quant_sharpness

    mm_gates = (cfg.enable_obmc, cfg.allow_warped_motion,
                cfg.enable_warped_motion)
    if any(g is not None for g in mm_gates):
        # one motion-mode knob covers OBMC + WARPED_CAUSAL here: stay on
        # unless every explicitly-set gate is off
        gop["motion_modes"] = any(g for g in mm_gates if g is not None)
    masked_gates = (cfg.enable_masked_comp, cfg.enable_interinter_wedge,
                    cfg.enable_diff_wtd_comp)
    if any(g is not None for g in masked_gates):
        gop["compound_types"] = not any(g is False for g in masked_gates)
    ii_gates = (cfg.enable_interintra_comp, cfg.enable_interintra_wedge,
                cfg.enable_smooth_interintra)
    if any(g is not None for g in ii_gates):
        gop["interintra"] = cfg.enable_interintra_comp is not False
    if cfg.enable_dist_wtd_comp is not None:
        gop["jnt_comp"] = bool(cfg.enable_dist_wtd_comp)
    if cfg.enable_order_hint is not None:
        gop["order_hint"] = cfg.enable_order_hint
    if cfg.error_resilient_mode or cfg.frame_parallel_decoding:
        gop["order_hint"] = False      # ER frames reset CDFs / hints

    if cfg.sharpness:
        gop["lf_sharpness"] = cfg.sharpness
    if cfg.enable_keyframe_filtering == 0:
        gop["enable_tf"] = False
    gop["enable_tpl"] = cfg.enable_tpl
    if cfg.enable_chroma_deltaq or cfg.chroma_q_offset_u \
            or cfg.chroma_q_offset_v:
        gop["q_offsets"] = (0, cfg.chroma_q_offset_u,
                            cfg.chroma_q_offset_v)

    from .bitstream import constants as c
    bsz = {4: c.BLOCK_4X4, 8: c.BLOCK_8X8, 16: c.BLOCK_16X16,
           32: c.BLOCK_32X32, 64: c.BLOCK_64X64, 128: c.BLOCK_128X128}
    if cfg.min_partition_size > 4:
        gop["block_size"] = bsz[min(cfg.min_partition_size, 64)]

    if cfg.enable_intra_edge_filter:
        seq["intra_edge_filter"] = True
    for f in ("color_primaries", "transfer_characteristics",
              "matrix_coefficients", "color_range",
              "chroma_sample_position"):
        v = getattr(cfg, f)
        if v not in (2, 0) or (f == "color_range" and v):
            seq[f] = v
    return {"gop": gop, "search": search, "seq": seq}
