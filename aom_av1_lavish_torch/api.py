"""Public encoder/decoder API — the codec-ABI analog.

Counterpart of aom_av1_lavish_tpu/api.py: the device work of an encode
runs on `EncoderConfig.device` (the card when None, and an error when there
is none; "cpu" runs the kernels' plain versions).

Re-designs the reference's C ABI surface (aom/aom_encoder.h
aom_codec_enc_init_ver/aom_codec_encode/aom_codec_get_cx_data,
aom/aom_decoder.h aom_codec_dec_init_ver/aom_codec_decode, config
validation av1/av1_cx_iface.c:805) as a small Python-native API:

    cfg = EncoderConfig(width=1280, height=720, target_bps=2_000_000)
    enc = Encoder(cfg)
    for frame in frames:
        enc.encode(frame)           # (y, u, v) uint8 planes
    packets = enc.flush()           # display-ordered TU payloads

    dec = Decoder()
    for pkt in packets:
        for planes in dec.decode(pkt):
            ...

Controls (the 391 AV1E_SET_* IDs of aom/aomcx.h) live in the
controls.py registry: EncoderConfig inherits the full tool-gate block
(controls.ToolsConfig) and `Encoder.control("AV1E_SET_AQ_MODE", 1)` /
`cfg.set_option("aq-mode", "1")` both dispatch through it.  flush()
routes to the matching encoder — GOP, all-intra, screen, SVC, superres,
realtime — so every shipped encode mode is reachable from this API.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np

from . import resolve_device
from .bitstream import constants as c
from .controls import (CONTROLS, ToolsConfig, apply_control,
                       resolve_tools, validate_tools)
from .encoder.ratectrl import (MODE_CBR, MODE_CQ, MODE_Q, MODE_VBR,
                               RateControlConfig)

USAGE_GOOD_QUALITY = 0
USAGE_REALTIME = 1
USAGE_ALL_INTRA = 2


@dataclass
class EncoderConfig(ToolsConfig):
    """Validated encode configuration (aom_codec_enc_cfg_t analog).

    Core stream/rc fields below; the full AV1E_SET_* tool-gate block is
    inherited from controls.ToolsConfig."""

    width: int = 0
    height: int = 0
    fps: float = 30.0
    usage: int = USAGE_GOOD_QUALITY
    cpu_used: int | None = None      # speed preset (speed_features.c)
    # rate control
    rc_mode: int = MODE_Q            # MODE_Q | MODE_CBR | MODE_VBR
    target_bps: int = 0              # used by CBR/VBR
    qindex: int = 60                 # used by MODE_Q
    best_q: int = 4
    worst_q: int = 255
    # GOP
    kf_interval: int = 120
    gf_length: int = 8
    #: SWITCH_FRAME cadence (aom_codec_enc_cfg_t g_sframe_dist)
    sframe_dist: int = 0
    use_arf: bool = True
    lossless: bool = False
    bit_depth: int = 8               # 8 | 10 | 12 (10/12 use uint16 planes)
    subsampling: str = "420"         # "420" | "422" | "444"
    # tools (headline knobs; the rest live in ToolsConfig)
    enable_cdef: bool = True
    deblock: bool = True
    tune: str = "psnr"
    luma_bias: float = 0.0           # lavish dark-region rdmult bias
    tile_cols_log2: int = 0
    tile_rows_log2: int = 0
    # platform
    use_tpu: bool = False            # batched device encode paths
    #: torch device of the device work; None = the card
    device: object = None
    use_native: bool | None = None   # native C entropy coder
    #: target level (AV1 Annex A); -1 = auto-pick, 31 = max-parameters.
    #: Enforced at validate() (av1/encoder/level.c analog).
    level: int = -1

    def validate(self) -> None:
        """RANGE_CHECK analog (av1_cx_iface.c:805) + level enforcement
        (encoder/levels.py) + registry-driven tool-gate validation; last,
        the device (None is the card: an error when there is none)."""
        def rng(name, v, lo, hi):
            if not (lo <= v <= hi):
                raise ValueError(f"{name}={v} out of range [{lo},{hi}]")
        rng("width", self.width, 4, 65536)
        rng("height", self.height, 4, 65536)
        from .encoder.levels import check_level, pick_level
        if self.level == -1:
            self.level = pick_level(self.width, self.height, self.fps,
                                    float(self.target_bps))
        else:
            bad = check_level(self.level, self.width, self.height,
                              self.fps, float(self.target_bps))
            if bad:
                raise ValueError(
                    f"stream exceeds level {self.level}: " + "; ".join(bad))
        rng("qindex", self.qindex, 0, 255)
        rng("best_q", self.best_q, 0, 255)
        rng("worst_q", self.worst_q, self.best_q, 255)
        rng("kf_interval", self.kf_interval, 1, 1 << 30)
        rng("gf_length", self.gf_length, 1, 32)
        rng("tile_cols_log2", self.tile_cols_log2, 0, 6)
        rng("tile_rows_log2", self.tile_rows_log2, 0, 6)
        if self.bit_depth not in (8, 10, 12):
            raise ValueError(f"bit_depth={self.bit_depth} not in (8,10,12)")
        if self.subsampling not in ("420", "422", "444"):
            raise ValueError(f"bad subsampling {self.subsampling!r}")
        if self.rc_mode in (MODE_CBR, MODE_VBR) and self.target_bps <= 0:
            raise ValueError("CBR/VBR needs target_bps > 0")
        if self.fps <= 0:
            raise ValueError("fps must be positive")
        if self.usage not in (USAGE_GOOD_QUALITY, USAGE_REALTIME,
                              USAGE_ALL_INTRA):
            raise ValueError(f"bad usage {self.usage}")
        if self.enable_superres and not (
                9 <= self.superres_denom <= 16 or self.superres_denom == 8):
            raise ValueError("superres_denom must be 8 (off) or 9..16")
        validate_tools(self)
        resolve_device(self.device)

    def set_option(self, key: str, value: str) -> None:
        """String key-value control (aom_codec_set_option analog).
        Accepts registry keys/names (controls.py) and raw field names."""
        from .controls import BY_KEY
        if key in CONTROLS or key in BY_KEY:
            apply_control(self, key, value)
            return
        names = {f.name: f for f in fields(self)}
        if key not in names:
            raise KeyError(f"unknown option {key!r}")
        cur = getattr(self, key)
        if cur is None:
            v = value.strip()
            setattr(self, key,
                    int(v) if v.lstrip("+-").isdigit() else v)
        elif isinstance(cur, bool):
            setattr(self, key, value.lower() in ("1", "true", "yes"))
        elif isinstance(cur, int):
            setattr(self, key, int(value))
        elif isinstance(cur, float):
            setattr(self, key, float(value))
        else:
            setattr(self, key, value)


class Encoder:
    """Stream encoder (aom_codec_encode surface)."""

    def __init__(self, cfg: EncoderConfig):
        cfg.validate()
        self.cfg = cfg
        self._frames = []
        self._packets = []

    #: GET-control accessors (aom_codec_control GET ids; the last 8
    #: reference ids not coverable by the set-registry)
    _GET_CONTROLS = (
        "AOME_GET_LAST_QUANTIZER", "AOME_GET_LAST_QUANTIZER_64",
        "AOME_GET_LOOPFILTER_LEVEL", "AV1E_GET_ACTIVEMAP",
        "AV1E_GET_BASELINE_GF_INTERVAL", "AV1E_GET_NUM_OPERATING_POINTS",
        "AV1E_GET_SEQ_LEVEL_IDX", "AV1E_GET_TARGET_SEQ_LEVEL_IDX")

    def get_control(self, name: str):
        """Query-side controls (aomcx.h AV1E_GET_* / AOME_GET_*)."""
        cfg = self.cfg
        st = getattr(self, "_stats", {})
        if name == "AOME_GET_LAST_QUANTIZER":
            return st.get("last_quantizer", cfg.qindex)
        if name == "AOME_GET_LAST_QUANTIZER_64":
            return st.get("last_quantizer", cfg.qindex) >> 2
        if name == "AOME_GET_LOOPFILTER_LEVEL":
            return st.get("loopfilter_level", 0)
        if name == "AV1E_GET_ACTIVEMAP":
            return cfg.active_map
        if name == "AV1E_GET_BASELINE_GF_INTERVAL":
            return cfg.gf_length
        if name == "AV1E_GET_NUM_OPERATING_POINTS":
            return max(cfg.temporal_layers, 1) * max(cfg.spatial_layers, 1)
        if name in ("AV1E_GET_SEQ_LEVEL_IDX",
                    "AV1E_GET_TARGET_SEQ_LEVEL_IDX"):
            from .encoder.levels import pick_level
            return pick_level(cfg.width, cfg.height, cfg.fps,
                              cfg.target_bps)
        raise KeyError(f"unknown GET control {name!r}")

    def control(self, name: str, value) -> None:
        """aom_codec_control analog: AV1E_SET_* name or CLI key."""
        apply_control(self.cfg, name, value)
        self.cfg.validate()

    def encode(self, planes) -> None:
        """Queue one (y, u, v) frame.  Encoding is deferred so GOP
        structure (ARF lookahead) sees the full group; packets drain via
        get_packets()/flush()."""
        y, u, v = planes
        if y.shape != (self.cfg.height, self.cfg.width):
            raise ValueError(
                f"luma shape {y.shape} != configured "
                f"{(self.cfg.height, self.cfg.width)}")
        pix = np.uint8 if self.cfg.bit_depth == 8 else np.uint16
        self._frames.append((np.asarray(y, pix), np.asarray(u, pix),
                             np.asarray(v, pix)))

    # -- mode routing ------------------------------------------------------

    def _qm_tuple(self):
        cfg = self.cfg
        if not cfg.enable_qm:
            return None
        lv = (cfg.qm_min + cfg.qm_max) // 2
        y = cfg.qm_y if cfg.qm_y is not None else lv
        u = cfg.qm_u if cfg.qm_u is not None else lv
        v = cfg.qm_v if cfg.qm_v is not None else u
        return (y, u, v)

    def _flush_lossless(self):
        cfg = self.cfg
        from .encoder.encoder import (LosslessEncoder,
                                      make_lossless_frame_header,
                                      make_sequence_header)
        from .ops.lossless import analyze_frames_for_encoder
        device = resolve_device(cfg.device)
        sh = make_sequence_header(cfg.width, cfg.height,
                                  bit_depth=cfg.bit_depth)
        encs = []
        srcs = []
        for f in self._frames:
            fh = make_lossless_frame_header(
                sh, tile_cols_log2=cfg.tile_cols_log2,
                tile_rows_log2=cfg.tile_rows_log2)
            e = LosslessEncoder(sh, fh, use_native=cfg.use_native)
            e.device = device
            srcs.append(e.pad_planes(f))
            encs.append(e)
        if (cfg.tile_cols_log2 or cfg.tile_rows_log2
                or cfg.bit_depth > 8):
            # the batched device analyze is 8-bit single-tile; tiles
            # and high bitdepth use the host walk
            return [e.encode_frame(f, use_jax=cfg.bit_depth == 8)
                    for e, f in zip(encs, self._frames)]
        analyses = analyze_frames_for_encoder(srcs, device=device)
        return [e.encode_frame(f, analysis=a) for e, f, a in
                zip(encs, self._frames, analyses)]

    def _via_ivf(self, drive, **kw):
        """Run a file-based encode entry in a temp dir, return
        payloads (the ivf container is only transport here)."""
        import os
        import tempfile
        from .bitstream.ivf import read_ivf
        cfg = self.cfg
        with tempfile.TemporaryDirectory() as td:
            p = os.path.join(td, "out.ivf")
            drive(p, self._frames, cfg.width, cfg.height, **kw)
            return [pay for pay, _pts in read_ivf(p)]

    def _flush_realtime(self):
        cfg = self.cfg
        from .encoder.nonrd import encode_realtime_ivf
        return self._via_ivf(
            encode_realtime_ivf, qindex=cfg.qindex,
            aq_mode=cfg.aq_mode,
            active_map=(cfg.active_map.get("map")
                        if isinstance(cfg.active_map, dict)
                        else cfg.active_map),
            static_threshold=int(cfg.static_threshold or 0),
            denoise=bool(cfg.noise_sensitivity
                         or cfg.denoise_noise_level))

    def _flush_svc(self):
        cfg = self.cfg
        if cfg.spatial_layers > 1:
            # L2T1 (two spatial layers); >2 requested layers clamp
            from .encoder.svc import encode_svc_spatial_ivf
            return self._via_ivf(encode_svc_spatial_ivf,
                                 qindex=cfg.qindex)
        from .encoder.svc import encode_svc_ivf
        return self._via_ivf(encode_svc_ivf,
                             temporal_layers=cfg.temporal_layers,
                             qindex=cfg.qindex)

    def _flush_superres(self):
        cfg = self.cfg
        from .encoder.lossy import encode_superres_ivf
        return self._via_ivf(encode_superres_ivf, qindex=cfg.qindex,
                             denom=cfg.superres_denom,
                             enable_cdef=int(cfg.enable_cdef))

    def _flush_allintra(self, tools):
        """All-intra frames path: QM / AQ / grain / screen / 4:2:2 /
        4:4:4 / HBD tools (the encode_lossy_ivf engine)."""
        cfg = self.cfg
        from .encoder.lossy import encode_lossy_ivf
        screen = (cfg.tune_content == "screen"
                  or bool(cfg.enable_palette) or bool(cfg.enable_intrabc))
        search = dict(tools["search"])
        if cfg.enable_filter_intra:
            search["filter_intra"] = True
        seg = None
        if cfg.roi_map is not None:
            # AOME_SET_ROI_MAP: {'map': per-16x16 segment ids,
            # 'delta_q': per-segment q deltas} lowered onto AV1
            # segmentation (SEG_LVL_ALT_Q)
            roi = cfg.roi_map
            seg = list(roi["delta_q"])
            search["roi_seg_map"] = roi["map"]
        return self._via_ivf(
            encode_lossy_ivf, qindex=cfg.qindex, seg=seg,
            enable_cdef=int(cfg.enable_cdef),
            enable_restoration=int(bool(cfg.enable_restoration)),
            bit_depth=cfg.bit_depth, screen=screen,
            qm=self._qm_tuple(), aq=cfg.aq_mode != 0,
            grain=bool(cfg.film_grain_test_vector
                       or cfg.film_grain_table),
            intrabc=bool(cfg.enable_intrabc),
            subsampling=cfg.subsampling,
            sb128=cfg.superblock_size == "128",
            tune=cfg.tune, luma_bias=cfg.luma_bias,
            use_native=cfg.use_native, lf_sharpness=cfg.sharpness,
            seq_tools=tools["seq"] or None, **search)

    def _apply_scale_mode(self):
        """AOME_SET_SCALEMODE: pre-scale the input to the mode's ratio
        (1 = 4/5, 2 = 3/5, 3 = 1/2; aom_scale_mode_t) and encode at the
        scaled size — the reference's av1_set_internal_size +
        av1_resize_plane path."""
        cfg = self.cfg
        num_den = {1: (4, 5), 2: (3, 5), 3: (1, 2)}.get(cfg.scale_mode)
        if num_den is None or not self._frames:
            return None
        from .common.resize import downscale_plane_horz
        num, den = num_den
        sw = max(2, (cfg.width * num // den) & ~1)
        sh_ = max(2, (cfg.height * num // den) & ~1)

        def scale(p, w, h):
            p = downscale_plane_horz(np.asarray(p), w)
            return np.ascontiguousarray(
                downscale_plane_horz(p.T, h).T)

        self._frames = [
            (scale(y, sw, sh_),
             scale(u, (sw + 1) // 2, (sh_ + 1) // 2),
             scale(v, (sw + 1) // 2, (sh_ + 1) // 2))
            for (y, u, v) in self._frames]
        old = (cfg.width, cfg.height)
        cfg.width, cfg.height = sw, sh_
        return old

    def flush(self) -> list:
        """Encode all queued frames; returns display-ordered payloads."""
        cfg = self.cfg
        tools = resolve_tools(cfg)
        restore_dims = self._apply_scale_mode()
        try:
            if cfg.lossless:
                return self._flush_lossless()
            if cfg.usage == USAGE_REALTIME:
                return self._flush_realtime()
            if cfg.temporal_layers > 1 or cfg.spatial_layers > 1:
                return self._flush_svc()
            if cfg.enable_superres and cfg.superres_denom != 8:
                return self._flush_superres()
            if (cfg.usage == USAGE_ALL_INTRA or cfg.enable_qm
                    or cfg.aq_mode or cfg.film_grain_test_vector
                    or cfg.film_grain_table
                    or cfg.tune_content == "screen"
                    or cfg.enable_palette or cfg.enable_intrabc
                    or cfg.roi_map is not None
                    or cfg.subsampling != "420"):
                return self._flush_allintra(tools)
            rc_cfg = RateControlConfig(
                target_bps=cfg.target_bps, fps=cfg.fps, width=cfg.width,
                height=cfg.height, mode=cfg.rc_mode, worst_q=cfg.worst_q,
                best_q=cfg.best_q, fixed_qindex=cfg.qindex)
            gop_kw = dict(tools["gop"])
            tx_sel = gop_kw.pop("tx_select", None)
            # AV1E_SET_FP_MT / FP_MT_UNIT_TEST: the frame-parallel
            # group path (FPMT, av1_compress_parallel_frames analog;
            # mesh=None = the fpmt_unit_test_cfg single-device
            # cross-check, encoder.h:2607 — byte-identical contract)
            fpmt = bool((cfg.fp_mt or cfg.fp_mt_unit_test)
                        and cfg.use_tpu)
            genc = GopEncoderWithTools(
                cfg.width, cfg.height, tx_select=tx_sel, rc_cfg=rc_cfg,
                gf_length=cfg.gf_length, kf_interval=cfg.kf_interval,
                sframe_dist=cfg.sframe_dist,
                use_arf=cfg.use_arf, use_tpu=cfg.use_tpu,
                frame_parallel=fpmt, mesh=None, device=cfg.device,
                use_native=cfg.use_native, enable_cdef=cfg.enable_cdef,
                tune=cfg.tune, luma_bias=cfg.luma_bias,
                bit_depth=cfg.bit_depth, cpu_used=cfg.cpu_used,
                seq_tools=tools["seq"] or None,
                search_overrides=tools["search"] or None, **gop_kw)
            out = genc.encode_sequence(self._frames)
            self._stats = {
                "last_quantizer": genc.rc.last_q_inter,
                "loopfilter_level": 0,
            }
            return out
        finally:
            self._frames = []
            if restore_dims is not None:
                cfg.width, cfg.height = restore_dims


def GopEncoderWithTools(*args, search_overrides=None, tx_select=None,
                        **kw):
    """GopEncoder + per-frame searcher overrides from the control
    registry (the av1_cx_iface ctrl state -> cpi->oxcf lowering)."""
    from .encoder.gop import GopEncoder
    genc = GopEncoder(*args, **kw)
    if search_overrides:
        genc.search_overrides = dict(search_overrides)
    if tx_select is not None:
        genc.force_tx_select = tx_select
    return genc


class Decoder:
    """Stream decoder (aom_codec_decode surface) with the aomdx.h
    control surface: AV1D_SET_* via control(), AOMD_/AV1D_GET_* via
    get_control()."""

    def __init__(self):
        self._sh = None
        self._state = {"slots": [None] * 8}
        self._annexb = False
        self._corrupted = False

    def decode(self, payload: bytes) -> list:
        """Decode one temporal unit; returns the list of shown frames
        (each a (y, u, v) tuple)."""
        from .decoder.decoder import decode_frame_obus, CorruptFrameError
        if self._annexb:
            from .bitstream.obu import annexb_tu_to_obus
            payload, _ = annexb_tu_to_obus(payload)
        try:
            frames, self._sh = decode_frame_obus(payload, self._sh,
                                                 self._state)
        except CorruptFrameError:
            self._corrupted = True
            raise
        self._corrupted = False
        return frames

    # -- aom_codec_control, decoder side ---------------------------------

    def control(self, name: str, value) -> None:
        """AV1D_SET_* controls (aomdx.h; av1/av1_dx_iface.c handlers)."""
        st = self._state
        if name == "AV1D_SET_IS_ANNEXB":
            self._annexb = bool(value)
        elif name == "AV1D_SET_OPERATING_POINT":
            st["operating_point"] = int(value)
        elif name == "AV1D_SET_OUTPUT_ALL_LAYERS":
            # we already output every shown frame of every decoded
            # layer; False additionally drops non-top spatial layers
            st["output_all_layers"] = bool(value)
        elif name == "AV1D_SET_ROW_MT":
            # host threads are not the parallelism axis of this design
            # (tiles fan out over tile_workers / device batches);
            # accepted for API parity
            st["row_mt"] = bool(value)
        elif name == "AV1D_SET_SKIP_FILM_GRAIN":
            st["skip_film_grain"] = bool(value)
        elif name == "AV1D_SET_EXT_REF_PTR":
            # large-scale-tile flow (lightfield_tile_list_decoder.c):
            # preload camera/anchor frames into reference slots.
            # value: {slot_index: (y, u, v)} or a list of plane tuples.
            items = (value.items() if isinstance(value, dict)
                     else enumerate(value))
            for slot, planes in items:
                st["slots"][int(slot)] = {
                    "planes": tuple(planes), "order_hint": 0,
                    "fc": None, "deltas": None, "frame_type": 0,
                    "mi_dims": (planes[0].shape[0] >> 2,
                                planes[0].shape[1] >> 2),
                    "mvs": None, "seg_map": None,
                    "ref_order_hints": (0,) * 7, "grain": None}
        elif name in ("AOMD_SET_TILE_WORKERS",):   # extension
            st["tile_workers"] = int(value)
        else:
            raise KeyError(f"unknown decoder control {name!r}")

    def get_control(self, name: str, *args):
        """Query-side controls (aomdx.h AOMD_GET_* / AV1D_GET_*), read
        from the last decoded frame's header/state."""
        sh, st = self._sh, self._state
        fh = st.get("last_fh")
        if name == "AOMD_GET_FRAME_CORRUPTED":
            return int(self._corrupted)
        if fh is None:
            raise RuntimeError("no frame decoded yet")
        if name in ("AOMD_GET_BASE_Q_IDX", "AOMD_GET_LAST_QUANTIZER"):
            return fh.base_q_idx
        if name == "AOMD_GET_FRAME_FLAGS":
            # aom_codec_frame_flags_t (aom_codec.h AOM_FRAME_IS_*)
            flags = 0
            if fh.frame_type == 0 and fh.show_frame:
                flags |= 0x1                     # AOM_FRAME_IS_KEY
            if fh.refresh_frame_flags == 0:
                flags |= 0x2                     # AOM_FRAME_IS_DROPPABLE
            if fh.frame_type == 2:
                flags |= 0x10                    # AOM_FRAME_IS_INTRAONLY
            if fh.frame_type == 3:
                flags |= 0x20                    # AOM_FRAME_IS_SWITCH
            if fh.error_resilient_mode:
                flags |= 0x40                    # ..._ERROR_RESILIENT
            if fh.frame_type == 0 and not fh.show_frame:
                flags |= 0x80                    # delayed random access
            return flags
        if name == "AOMD_GET_ALTREF_PRESENT":
            return int(st.get("altref_seen", False))
        if name == "AOMD_GET_FWD_KF_PRESENT":
            return int(st.get("fwd_kf_seen", False))
        if name == "AOMD_GET_LAST_REF_UPDATES":
            return fh.refresh_frame_flags
        if name == "AOMD_GET_LAST_REF_USED":
            # header-level mask of the 7 named references an inter
            # frame signals (LAST..ALTREF); 0 for intra frames
            if fh.frame_type in (0, 2) or fh.show_existing_frame:
                return 0
            return (1 << 7) - 1 if fh.ref_frame_idx else 0
        if name == "AOMD_GET_ORDER_HINT":
            return fh.order_hint
        if name == "AOMD_GET_SB_SIZE":
            return 128 if sh.use_128x128_superblock else 64
        if name == "AOMD_GET_SCREEN_CONTENT_TOOLS_INFO":
            return {"allow_screen_content_tools":
                    int(fh.allow_screen_content_tools),
                    "force_integer_mv": int(fh.force_integer_mv)}
        if name == "AOMD_GET_SHOW_EXISTING_FRAME_FLAG":
            return int(fh.show_existing_frame)
        if name == "AOMD_GET_SHOW_FRAME_FLAG":
            return int(fh.show_frame or fh.show_existing_frame)
        if name == "AOMD_GET_STILL_PICTURE":
            return {"is_still_picture": int(sh.still_picture),
                    "is_reduced_still_picture_hdr":
                    int(sh.reduced_still_picture_header)}
        if name == "AOMD_GET_S_FRAME_INFO":
            return {"is_s_frame": int(fh.frame_type == 3),
                    "is_s_frame_at_altref":
                    int(fh.frame_type == 3 and not fh.show_frame)}
        if name == "AV1D_GET_BIT_DEPTH":
            return (12 if sh.twelve_bit else 10) if sh.high_bitdepth \
                else 8
        if name == "AV1D_GET_IMG_FORMAT":
            if sh.mono_chrome:
                return "MONO"
            return {(1, 1): "I420", (1, 0): "I422",
                    (0, 0): "I444"}[(sh.subsampling_x, sh.subsampling_y)]
        if name == "AV1D_GET_FRAME_SIZE":
            return (fh.upscaled_width, fh.frame_height)
        if name == "AV1D_GET_DISPLAY_SIZE":
            return (fh.render_width, fh.render_height)
        if name == "AV1D_GET_FRAME_HEADER_INFO":
            return fh
        if name == "AV1D_GET_TILE_COUNT":
            t = st.get("last_tiles") or {"cols": 1, "rows": 1}
            return t["cols"] * t["rows"]
        if name in ("AV1D_GET_TILE_INFO", "AOMD_GET_TILE_INFO"):
            t = st.get("last_tiles")
            if t is None:
                raise RuntimeError("no tile data recorded")
            return {"tile_cols": t["cols"], "tile_rows": t["rows"],
                    "tile_cols_log2": t["cols_log2"],
                    "tile_rows_log2": t["rows_log2"]}
        if name == "AV1D_GET_TILE_SIZE":
            t = st.get("last_tiles")
            if t is None:
                raise RuntimeError("no tile data recorded")
            sb = 128 if sh.use_128x128_superblock else 64
            w = -(-fh.frame_width // sb) * sb // t["cols"]
            h = -(-fh.frame_height // sb) * sb // t["rows"]
            return (w, h)
        if name == "AV1D_GET_TILE_DATA":
            t = st.get("last_tiles")
            if t is None:
                raise RuntimeError("no tile data recorded")
            if args:
                return dict(t["payloads"])[int(args[0])]
            return list(t["payloads"])
        if name == "AV1D_GET_MI_INFO":
            mi = st.get("last_mi")
            if mi is None:
                raise RuntimeError("no frame decoded yet")
            r, c_ = (int(args[0]), int(args[1])) if args else (0, 0)
            return {"mode": int(mi["mode"][r, c_]),
                    "ref0": int(mi["ref0"][r, c_]),
                    "mv": tuple(int(x) for x in
                                np.asarray(mi["mv"][r, c_]).reshape(-1)[:2]),
                    "bsize": int(mi["bsize"][r, c_]),
                    "skip": int(mi["skip"][r, c_]),
                    "segment_id": int(mi["seg"][r, c_])}
        raise KeyError(f"unknown decoder GET control {name!r}")
