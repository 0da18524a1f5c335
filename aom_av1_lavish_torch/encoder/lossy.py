"""Lossy all-intra encoder: RD partition search + full intra mode RDO.

SURVEY.md §7 step 4: recon-in-the-loop intra coding with
  * top-down NONE-vs-SPLIT partition RDO (64x64 .. min block),
  * all 13 intra modes for luma (angle deltas 0 for now),
  * chroma DC-vs-CfL decision with least-squares alpha fit,
  * rate-aware costs (token-level bit estimates, lambda from qindex).
Deblocking runs on recon (level from q); seq cdef/restoration still off.

Reference analog: av1/encoder/partition_search.c av1_rd_pick_partition +
rdopt.c av1_rd_pick_intra_mode_sb (recast: trial encodes over recon
snapshots instead of context trees).
"""

from __future__ import annotations

import numpy as np

from ..bitstream import constants as c
from ..bitstream import headers as H
from ..bitstream import tables
from ..bitstream.tables import FrameContext
from ..common import blockd, coeffs as CF, intra, quant as Q
from ..common import palette as PAL
from ..common import txfm2d as T2
from ..common import txtype as TT
from .encoder import (INTRA_MODE_CONTEXT, LosslessEncoder,
                      make_sequence_header)

MAX_ANGLE_DELTA = 3

ALL_Y_MODES = tuple(range(c.INTRA_MODES))


def _neg_interleave(x: int, ref: int, mx: int) -> int:
    """av1_neg_interleave (encodemv-side inverse of
    decoder._neg_deinterleave)."""
    diff = x - ref
    if not ref:
        return x
    if ref >= mx - 1:
        return -x + mx - 1
    if 2 * ref < mx:
        if abs(diff) <= ref:
            return (diff << 1) - 1 if diff > 0 else (-diff) << 1
        return x
    if abs(diff) <= mx - ref - 1:
        return (diff << 1) - 1 if diff > 0 else (-diff) << 1
    return (mx - x) - 1


def make_lossy_frame_header(sh: H.SequenceHeader, qindex: int,
                            deblock: bool = True,
                            screen: bool = False,
                            qm=None, aq: bool = False,
                            intrabc: bool = False,
                            seg=None, tx_select: bool = False,
                            order_hint: int = 0,
                            backward_update: bool = False,
                            width: int | None = None,
                            height: int | None = None) -> H.FrameHeader:
    assert 0 < qindex <= 255
    assert not (tx_select and intrabc), \
        "intrabc blocks use the inter vartx tx-size syntax (TBD)"
    if intrabc:
        assert screen, "intrabc requires screen content tools"
        deblock = False   # allow_intrabc disables in-loop filters (spec)
    if deblock:
        from ..common.loopfilter import pick_filter_level_from_q
        lvl = pick_filter_level_from_q(qindex, frame_is_key=True,
                                       bd=sh.bit_depth)
    else:
        lvl = 0
    if screen:
        assert sh.force_screen_content_tools == 2, \
            "screen frames need make_sequence_header(screen=True)"
    if qm is not None and not sh.separate_uv_delta_q:
        assert qm[1] == qm[2], "qm_v == qm_u unless separate_uv_delta_q"
    if aq:
        assert qindex > 1, "delta-q needs a non-lossless base q"
    seg_kw = {}
    if seg is not None:
        assert not aq, "segment AQ and delta-q AQ are exclusive here"
        assert 2 <= len(seg) <= 8
        mask = []
        data = []
        for d in seg:
            assert 0 < qindex + d <= 255, (qindex, d)
            mask.append(1)            # SEG_LVL_ALT_Q active
            data.append((int(d),) + (0,) * 7)
        mask += [0] * (8 - len(seg))
        data += [(0,) * 8] * (8 - len(seg))
        seg_kw = dict(segmentation_enabled=1, seg_update_map=1,
                      seg_update_data=1, seg_temporal_update=0,
                      seg_feature_mask=tuple(mask),
                      seg_feature_data=tuple(data),
                      seg_preskip=0, seg_last_active=len(seg) - 1)
    cw = width or sh.max_frame_width
    ch = height or sh.max_frame_height
    override = int((cw, ch) != (sh.max_frame_width, sh.max_frame_height))
    return H.FrameHeader(
        frame_type=c.KEY_FRAME, show_frame=1, error_resilient_mode=1,
        disable_cdf_update=0,
        disable_frame_end_update_cdf=0 if backward_update else 1,
        order_hint=order_hint,
        frame_size_override=override,
        frame_width=cw, frame_height=ch,
        render_width=cw, render_height=ch,
        base_q_idx=qindex,
        tx_mode=c.TX_MODE_SELECT if tx_select else c.TX_MODE_LARGEST,
        reduced_tx_set=0,
        allow_screen_content_tools=int(screen),
        force_integer_mv=int(screen),
        allow_intrabc=int(intrabc),
        using_qmatrix=int(qm is not None),
        qm_y=qm[0] if qm else 0, qm_u=qm[1] if qm else 0,
        qm_v=qm[2] if qm else 0,
        delta_q_present=int(aq), delta_q_res_log2=2 if aq else 0,
        filter_level=(lvl, lvl), filter_level_u=lvl, filter_level_v=lvl,
        **seg_kw)


class LossyAllIntraEncoder(LosslessEncoder):
    """Key-frame encoder at base_q_idx > 0 (inherits partition machinery)."""

    PAD = 64

    def __init__(self, sh, fh, use_native=None, block_size=c.BLOCK_16X16,
                 mode_set=ALL_Y_MODES, enable_cfl=True, tune="psnr",
                 luma_bias=0.0, trellis=True, rect_parts=True, speed=0,
                 saliency=0.0, tx_search=None, seg_flavor="variance",
                 roi_seg_map=None,
                 ext_parts=False, sharpness=0):
        super().__init__(sh, fh, use_native=use_native)
        self.min_bsize = block_size
        self.mode_set = mode_set
        self.enable_cfl = enable_cfl
        #: full UV-mode RD sweep (rdopt.c av1_rd_pick_intra_sbuv_mode);
        #: False restores the old DC+CfL-only chroma decision
        self.uv_mode_search = True
        self.trellis = trellis
        self.rect_parts = rect_parts
        self.speed = speed   # >=1: ML partition pruning (models/)
        # tx-type RD search on the winning mode (tx_search.c analog);
        # defaults on at speed 0, off at higher speeds
        self.tx_search = (speed == 0) if tx_search is None else tx_search
        # AB/4:1 partition shapes in the RD search (speed<=1 feature in
        # the reference; opt-in here since it ~2.5x's trial work)
        self.ext_parts = ext_parts
        # TX_MODE_SELECT: per-block tx depth coding + RD search
        # (av1_pick_uniform_tx_size_type_yrd analog, intra-only here)
        self.tx_select = fh.tx_mode == c.TX_MODE_SELECT
        self.saliency = saliency  # saliency-map rdmult strength
        self.tune = tune
        self.luma_bias = luma_bias
        self.lam_map = None
        # screen content: palette mode (av1_rd_pick_palette_intra_sby)
        self.screen = bool(getattr(fh, "allow_screen_content_tools", 0))
        self.pal_size_y = np.zeros((self.mi_rows, self.mi_cols), np.uint8)
        self.pal_colors_y = {}   # (mi_r, mi_c) -> tuple of luma colors
        # variance AQ (aq_variance.c / DELTA_Q_PERCEPTUAL analog)
        self.sb_qmap = None
        self._emit_cur_q = fh.base_q_idx
        # segmentation (segment-based AQ: SEG_LVL_ALT_Q per segment)
        self.seg_on = bool(getattr(fh, "segmentation_enabled", 0))
        self.seg_flavor = seg_flavor  # "variance" | "complexity"
        #: user region-of-interest segment-id map (AOME_SET_ROI_MAP
        #: analog): per-16x16 units, values < n_segments
        self.roi_seg_map = roi_seg_map
        self.seg_plan = None      # planned per-mi segment ids
        self.seg_emit_map = None  # decoder-mirrored ids (skip => pred)
        # intraBC (hash-MV search; encoder/intrabc.py)
        self.intrabc = bool(getattr(fh, "allow_intrabc", 0))
        self._ibc_index = None
        if self.intrabc:
            from ..common import mvref as MRR
            self.g = MRR.MiGrids(self.mi_rows, self.mi_cols)
        #: lavish quant sharpness (AOME_SET_QUANT_SHARPNESS): biases
        #: zbin/round toward keeping detail (quant.py:66)
        self.sharpness = sharpness
        self.pq = []
        for (dcd, acd) in ((fh.delta_q_y_dc, 0),
                           (fh.delta_q_u_dc, fh.delta_q_u_ac),
                           (fh.delta_q_v_dc, fh.delta_q_v_ac)):
            self.pq.append(Q.build_plane_quant(fh.base_q_idx, dcd, acd,
                                               bd=sh.bit_depth,
                                               sharpness=sharpness))
        qstep = Q.ac_quant_qtx(fh.base_q_idx, 0, sh.bit_depth) / 8.0
        self.lam = 0.12 * qstep * qstep  # lambda in (SSE per bit)

    def _lam(self, mi_row, mi_col):
        """Per-block lambda: global rdmult scaled by the psy tune map
        (av1_set_ssim_rdmult analog) and the AQ delta-q of the SB."""
        lam = self.lam
        if self.sb_qmap is not None or self.seg_plan is not None:
            qstep = Q.ac_quant_qtx(self._block_qindex(mi_row, mi_col), 0,
                                   self.sh.bit_depth) / 8.0
            lam = 0.12 * qstep * qstep
        if self.lam_map is None:
            return lam
        m = self.lam_map
        return lam * m[min(mi_row >> 2, m.shape[0] - 1),
                       min(mi_col >> 2, m.shape[1] - 1)]

    #: subclasses that cannot replay their emit pass (e.g. inter, which
    #: builds MV-ref state during emit) set this False until supported
    _lr_capable = True
    #: LR state; None unless encode_frame initialized a searchable frame
    #: (subclasses with their own encode_frame loops inherit the off
    #: state rather than crashing in _post_tile)
    _lr = None
    _sb_plans = None

    def encode_frame(self, planes, use_jax: bool = False) -> bytes:
        self.analysis = None
        self._sb_plans = []
        self._lr = None
        if self.tx_select:
            # per-mi luma tx dims for the deblock edge rules
            self.txw4_grid = np.zeros((self.mi_rows, self.mi_cols),
                                      np.int64)
            self.txh4_grid = np.zeros((self.mi_rows, self.mi_cols),
                                      np.int64)
        self._setup_tune_map(planes)
        self._setup_aq(planes)
        if self.tune in ("butteraugli", "vmaf"):
            self._setup_perceptual_tune(planes)
        if self.seg_on:
            self._setup_segmentation(planes)
        self._emit_cur_q = self.fh.base_q_idx
        return super().encode_frame(planes, use_jax=False)

    def _setup_segmentation(self, planes) -> None:
        """Assign mi cells to segments by 16x16 activity quantiles
        (av1 aq_cyclicrefresh/variance segment maps analog): bucket k
        maps to segment k, whose SEG_LVL_ALT_Q the caller chose.
        A user ROI map (AOME_SET_ROI_MAP) overrides the automatic
        assignment."""
        n_seg = self.fh.seg_last_active + 1
        if self.roi_seg_map is not None:
            m = np.asarray(self.roi_seg_map, np.uint8)
            assert m.max() < n_seg, "ROI segment id out of range"
            self.seg_plan = np.zeros((self.mi_rows, self.mi_cols),
                                     np.uint8)
            for r in range(self.mi_rows):
                for cc in range(self.mi_cols):
                    self.seg_plan[r, cc] = m[min(r // 4, m.shape[0] - 1),
                                             min(cc // 4, m.shape[1] - 1)]
            self.seg_emit_map = np.zeros((self.mi_rows, self.mi_cols),
                                         np.uint8)
            return
        y = np.asarray(planes[0], np.float64)
        b = 16
        hb = max(y.shape[0] // b, 1)
        wb = max(y.shape[1] // b, 1)
        v = y[:hb * b, :wb * b].reshape(hb, b, wb, b)
        if self.seg_flavor == "complexity":
            # aq_complexity.c:62 analog: weight local variance by edge
            # energy so busy-but-structured blocks keep quality while
            # noise-like blocks absorb the coarser segments
            gy, gx = np.gradient(y[:hb * b, :wb * b])
            e = (np.abs(gx) + np.abs(gy)).reshape(hb, b, wb, b) \
                .mean(axis=(1, 3))
            var = v.var(axis=(1, 3)) / (1.0 + e)
        else:
            var = v.var(axis=(1, 3))
        qs = np.quantile(var, [(k + 1) / n_seg for k in range(n_seg - 1)])
        bucket = np.digitize(var, qs)
        self.seg_plan = np.zeros((self.mi_rows, self.mi_cols), np.uint8)
        for r in range(self.mi_rows):
            for cc in range(self.mi_cols):
                self.seg_plan[r, cc] = bucket[min(r // 4, hb - 1),
                                              min(cc // 4, wb - 1)]
        self.seg_emit_map = np.zeros((self.mi_rows, self.mi_cols),
                                     np.uint8)

    def _setup_perceptual_tune(self, planes) -> None:
        """tune=butteraugli/vmaf: trial-encode the frame, measure the
        perceptual-vs-MSE damage ratio per block on the recon
        (tune_butteraugli.c:26 av1_set_mb_butteraugli_rdmult_scaling
        flow), and realize it as a PER-SB DELTA-Q map when the frame
        header carries delta-q (the tune_vmaf.c qindex-adjustment route:
        with a fixed base q a lambda-only redistribution cannot move
        bits between blocks) — else fold it into the lambda map."""
        from ..dsp.butteraugli import perceptual_rdmult_map
        trial = LossyAllIntraEncoder(
            self.sh, self.fh, use_native=self.use_native,
            block_size=self.min_bsize, mode_set=(c.DC_PRED, c.SMOOTH_PRED),
            enable_cfl=False, tune="psnr", trellis=False,
            rect_parts=False, speed=1)
        trial.sb_qmap = None
        trial.encode_frame(planes)
        h, w = np.asarray(planes[0]).shape
        m = perceptual_rdmult_map(np.asarray(planes[0]),
                                  trial.recon[0][:h, :w], self.tune, 16)
        fh = self.fh
        if fh.delta_q_present:
            # lambda mult -> qindex offset: lambda ~ qstep^2 and qstep
            # doubles every ~24 qindex steps, so dq = 12*log2(mult)
            n_r = (self.mi_rows + self.sb_mi - 1) // self.sb_mi
            n_c = (self.mi_cols + self.sb_mi - 1) // self.sb_mi
            blk_per_sb = self.sb_mi >> 2
            logm = np.zeros((n_r, n_c))
            for r in range(n_r):
                for cc in range(n_c):
                    blk = m[r * blk_per_sb:(r + 1) * blk_per_sb,
                            cc * blk_per_sb:(cc + 1) * blk_per_sb]
                    if blk.size:
                        logm[r, cc] = np.mean(np.log2(blk))
            step = 1 << fh.delta_q_res_log2
            base = fh.base_q_idx
            k = np.round(12.0 * logm / step).astype(np.int64)
            k_min = -((base - 1) // step)
            k_max = (255 - base) // step
            self.sb_qmap = base + np.clip(k, k_min, k_max) * step
            return
        if self.lam_map is None:
            self.lam_map = m
        else:
            hh = min(self.lam_map.shape[0], m.shape[0])
            ww = min(self.lam_map.shape[1], m.shape[1])
            self.lam_map = self.lam_map.copy()
            self.lam_map[:hh, :ww] *= m[:hh, :ww]

    def _setup_aq(self, planes) -> None:
        """Per-SB qindex map for delta-q (variance AQ: quantize flat SBs
        finer; av1 DELTA_Q_PERCEPTUAL / aq_variance.c analog).  Targets sit
        on the delta_q_res grid relative to base so the sequentially-coded
        deltas realize them exactly."""
        fh = self.fh
        if not fh.delta_q_present:
            self.sb_qmap = None
            return
        step = 1 << fh.delta_q_res_log2
        base = fh.base_q_idx
        sb_px = self.sb_mi * 4
        y = np.asarray(planes[0], np.float64)
        h, w = y.shape
        n_r = (self.mi_rows + self.sb_mi - 1) // self.sb_mi
        n_c = (self.mi_cols + self.sb_mi - 1) // self.sb_mi
        logv = np.zeros((n_r, n_c))
        for r in range(n_r):
            for cc in range(n_c):
                blk = y[r * sb_px:(r + 1) * sb_px,
                        cc * sb_px:(cc + 1) * sb_px]
                logv[r, cc] = np.log2(blk.var() + 1.0)
        off = 6.0 * (logv - logv.mean())
        k = np.round(off / step).astype(np.int64)
        k_min = -((base - 1) // step)
        k_max = (255 - base) // step
        self.sb_qmap = base + np.clip(k, k_min, k_max) * step

    def _block_qindex(self, mi_row, mi_col) -> int:
        if self.seg_plan is not None:
            seg = int(self.seg_plan[mi_row, mi_col])
            d = self.fh.seg_feature_data[seg][0]
            return max(0, min(255, self.fh.base_q_idx + d))
        if self.sb_qmap is None:
            return self.fh.base_q_idx
        return int(self.sb_qmap[mi_row // self.sb_mi,
                                mi_col // self.sb_mi])

    def _pq_at(self, plane, mi_row, mi_col):
        if self.sb_qmap is None and self.seg_plan is None:
            return self.pq[plane]
        q = self._block_qindex(mi_row, mi_col)
        fh = self.fh
        deltas = ((fh.delta_q_y_dc, 0),
                  (fh.delta_q_u_dc, fh.delta_q_u_ac),
                  (fh.delta_q_v_dc, fh.delta_q_v_ac))[plane]
        return Q.build_plane_quant(q, deltas[0], deltas[1],
                                   bd=self.sh.bit_depth,
                                   sharpness=self.sharpness)

    #: search deblock levels against the source (picklpf.c analog);
    #: RT paths disable it and keep the q-derived level
    #: (LPF_PICK_FROM_Q at high speeds)
    lf_search = True

    def _post_tile(self, tile_data: bytes) -> bytes:
        if self.intrabc:
            # allow_intrabc disables all in-loop filters (spec 5.9.11)
            return tile_data
        self._filter_recon(search=self.lf_search)
        if self._lr is not None and any(self.fh.lr_type):
            # LR unit symbols are interleaved per superblock inside the
            # tile, so the tile must be re-emitted from the saved plans
            tile_data = self._reemit_tile()
        return tile_data

    #: optional externally-supplied per-16x16 rdmult multipliers
    #: (TPL dependency map, av1_tpl_rdmult_setup analog)
    ext_rdmult_map = None

    #: external partition model (aom_ext_part_funcs analog,
    #: av1/encoder/external_partition.c): callable(mi_row, mi_col, bsize,
    #: features dict) -> "NONE" | "SPLIT" | "HORZ" | "VERT" | None.
    #: None falls back to the built-in RD search for that node.
    ext_partition = None

    def _ext_partition_decision(self, mi_row, mi_col, bsize):
        if self.ext_partition is None:
            return None
        feats = dict(
            qindex=self._block_qindex(mi_row, mi_col),
            block_size_px=blockd.block_wide(bsize),
            source_var=float(self.src[0][
                mi_row * 4:mi_row * 4 + blockd.block_high(bsize),
                mi_col * 4:mi_col * 4 + blockd.block_wide(bsize)]
                .astype(np.float64).var()))
        return self.ext_partition(mi_row, mi_col, bsize, feats)

    def _setup_tune_map(self, planes) -> None:
        from .tune import combined_rdmult_map
        self.lam_map = combined_rdmult_map(
            np.asarray(planes[0]), self.tune, 16, self.luma_bias,
            saliency=self.saliency)
        if self.ext_rdmult_map is not None:
            m = np.asarray(self.ext_rdmult_map, np.float64)
            if self.lam_map is None:
                self.lam_map = m
            else:
                h = min(self.lam_map.shape[0], m.shape[0])
                w = min(self.lam_map.shape[1], m.shape[1])
                self.lam_map = self.lam_map.copy()
                self.lam_map[:h, :w] *= m[:h, :w]

    def _filter_recon(self, search: bool = True):
        """Deblock-level search + apply, then CDEF search (when the
        sequence enables it).  Mirrors av1/encoder/picklpf.c +
        pickcdef.c at frame level; recon afterwards equals what the
        decoder reconstructs."""
        fh = self.fh
        if fh.base_q_idx == 0:
            return
        import numpy as np
        from ..common import loopfilter as LF

        def plane_tx(plane, bsize):
            return self._plane_tx(plane, bsize)

        bsg = self.mi_bsize.astype(np.int32)
        mh, mw = bsg.shape
        if self.tx_select:
            # per-block selected tx dims recorded during the emit pass
            txw4 = self.txw4_grid
            txh4 = self.txh4_grid
        else:
            txw4 = np.zeros((mh, mw), np.int64)
            txh4 = np.zeros((mh, mw), np.int64)
            for b in np.unique(bsg):
                tx = self._plane_tx(0, int(b))
                txw4[bsg == b] = c.TX_WIDTH[tx] >> 2
                txh4[bsg == b] = c.TX_HEIGHT[tx] >> 2
        ref_grid, mode_grid, skip_inter = self._lf_grids(mh, mw)

        def lf_apply(planes, lvl):
            old = (fh.filter_level, fh.filter_level_u, fh.filter_level_v)
            fh.filter_level = (lvl, lvl)
            fh.filter_level_u = lvl
            fh.filter_level_v = lvl
            LF.loop_filter_frame(planes, fh, self.sh, txw4, txh4, bsg,
                                 ref_grid, mode_grid, skip_inter,
                                 plane_tx, bd=self.bd)
            (fh.filter_level, fh.filter_level_u, fh.filter_level_v) = old

        from .pickfilters import pick_cdef, pick_filter_level
        if fh.filter_level[0] == 0:
            lvl = 0          # caller disabled deblocking
        elif search:
            lvl = pick_filter_level(self.src, self.recon, fh, self.sh,
                                    lf_apply)
        else:
            lvl = fh.filter_level[0]
        if lvl:
            lf_apply(self.recon, lvl)
        use_lr = self.sh.enable_restoration and self._lr_capable
        if use_lr:
            # mirror the decoder's sequencing: deblock -> save LR
            # boundaries(0) -> CDEF -> save(1) -> LR
            self._init_lr()
            self._save_lr_boundaries(0)
        if self.sh.enable_cdef:
            pick_cdef(self.src, self.recon, self.mi_rows, self.mi_cols,
                      self.ss_x, self.ss_y, self.num_planes,
                      self.mi_skip, fh, self.bd)
        if use_lr:
            self._save_lr_boundaries(1)
            self._search_lr()

    def _lf_grids(self, mh, mw):
        import numpy as np
        zeros = np.zeros((mh, mw), np.int32)
        return zeros, zeros, zeros.astype(np.uint8)

    # ------------------------------------------------------------------
    # loop restoration search (av1_pick_filter_restoration, pickrst.c:1779)
    # ------------------------------------------------------------------

    def _init_lr(self):
        from ..common import restoration as LR
        fh = self.fh
        fh.lr_unit_shift = 1            # 128-px luma units (aom default)
        ysize = 64 << fh.lr_unit_shift
        ss = min(self.ss_x, self.ss_y) if self.num_planes > 1 else 0
        fh.lr_uv_shift = 1 if ss else 0
        uvsize = ysize >> (fh.lr_uv_shift * ss)
        sizes = (ysize, uvsize, uvsize)
        self._lr = []
        self._lr_bounds = [{"above": {}, "below": {}}
                           for _ in range(self.num_planes)]
        for p in range(self.num_planes):
            ph, pw = self._plane_dims(p)
            self._lr.append(LR.PlaneRestoration(
                LR.RESTORE_SWITCHABLE, sizes[p], pw, ph))

    def _plane_dims(self, p):
        ss_x = self.ss_x if p else 0
        ss_y = self.ss_y if p else 0
        return ((self.fh.frame_height + ss_y) >> ss_y,
                (self.fh.frame_width + ss_x) >> ss_x)

    def _save_lr_boundaries(self, after_cdef):
        from ..common import restoration as LR
        for p in range(self.num_planes):
            ph, pw = self._plane_dims(p)
            LR.save_boundary_lines(self.recon[p][:ph, :pw],
                                   self.ss_y if p else 0, after_cdef,
                                   self._lr_bounds[p])

    def _search_lr(self):
        """Per-unit NONE/WIENER/SGR RD decisions; sets fh.lr_type and
        applies the chosen filters to recon (decoder-identical)."""
        from ..common import restoration as LR
        from .pickrst import pick_restoration_plane
        fh = self.fh
        do_cdef = (fh.cdef_bits
                   or (fh.cdef_y_pri and (fh.cdef_y_pri[0]
                                          or fh.cdef_y_sec[0]))
                   or (fh.cdef_uv_pri and (fh.cdef_uv_pri[0]
                                           or fh.cdef_uv_sec[0])))
        self._lr_optimized = not do_cdef
        types = []
        for p in range(self.num_planes):
            pr = self._lr[p]
            ss_y = self.ss_y if p else 0
            ph, pw = self._plane_dims(p)
            win = LR.WIENER_WIN if p == 0 else LR.WIENER_WIN - 2
            used = pick_restoration_plane(
                self.src[p], self.recon[p], pr, ss_y,
                self._lr_bounds[p], self._lr_optimized, self.lam,
                win=win, bd=self.bd)
            used.discard(LR.RESTORE_NONE)
            if not used:
                ftype = LR.RESTORE_NONE
            elif used == {LR.RESTORE_WIENER}:
                ftype = LR.RESTORE_WIENER
            elif used == {LR.RESTORE_SGRPROJ}:
                ftype = LR.RESTORE_SGRPROJ
            else:
                ftype = LR.RESTORE_SWITCHABLE
            pr.frame_rtype = ftype
            types.append(ftype)
        fh.lr_type = tuple(types + [0] * (3 - len(types)))
        for p in range(self.num_planes):
            pr = self._lr[p]
            if pr.frame_rtype == LR.RESTORE_NONE:
                continue
            ph, pw = self._plane_dims(p)
            view = self.recon[p][:ph, :pw]
            out = LR.filter_frame_plane(view, pr, self.ss_y if p else 0,
                                        self._lr_bounds[p],
                                        self._lr_optimized, self.bd)
            view[:] = out

    def _reemit_tile(self) -> bytes:
        """Replay the emit pass with LR unit symbols interleaved per
        superblock (loop_restoration_read_sb_coeffs write analog)."""
        from ..common import restoration as LR
        from .encoder import NativeSink, PySink
        self.fc = (self.fc0.copy() if getattr(self, "fc0", None) is not None
                   else FrameContext(self.fh.base_q_idx))
        self.sink = NativeSink(self.fc) if self.use_native \
            else PySink(self.fc)
        self.above_partition = np.zeros(self.mi_cols + 32, dtype=np.uint8)
        self.left_partition = np.zeros(self.mi_rows + 32, dtype=np.uint8)
        self.above_entropy = [np.zeros(self.mi_cols + 32, dtype=np.uint8)
                              for _ in range(self.num_planes)]
        self.left_entropy = [np.zeros(self.mi_rows + 32, dtype=np.uint8)
                             for _ in range(self.num_planes)]
        # tx-size context spans (decoder TileState above_txfm/left_txfm)
        self.above_txfm = np.full(self.mi_cols + 32, 64, dtype=np.uint8)
        self.left_txfm = np.full(self.mi_rows + 32, 64, dtype=np.uint8)
        self._emit_cur_q = self.fh.base_q_idx
        # av1_reset_loop_restoration: per-tile coeff prediction refs
        self._lr_wiener_ref = [{"v": LR.default_wiener(),
                                "h": LR.default_wiener()}
                               for _ in range(self.num_planes)]
        self._lr_sgr_ref = [LR.default_sgrproj()
                            for _ in range(self.num_planes)]
        it = iter(self._sb_plans)
        for mi_row in range(0, self.mi_rows, self.sb_mi):
            self.left_partition[:] = 0
            for le in self.left_entropy:
                le[:] = 0
            self.left_txfm[:] = 64
            for mi_col in range(0, self.mi_cols, self.sb_mi):
                self._write_lr_units(mi_row, mi_col)
                self._emit(next(it))
        return self.sink.finish()

    def _write_lr_units(self, mi_row, mi_col):
        """Write analog of decoder._read_lr_units
        (av1_loop_restoration_corners_in_sb, restoration.c:1316)."""
        from ..common import restoration as LR
        for plane in range(self.num_planes):
            pr = self._lr[plane]
            if pr.frame_rtype == LR.RESTORE_NONE:
                continue
            ss_x = self.ss_x if plane else 0
            ss_y = self.ss_y if plane else 0
            mi_sz_x = 4 >> ss_x
            mi_sz_y = 4 >> ss_y
            size = pr.unit_size
            sb4 = self.sb_mi
            rcol0 = (mi_col * mi_sz_x + size - 1) // size
            rrow0 = (mi_row * mi_sz_y + size - 1) // size
            rcol1 = min(((mi_col + sb4) * mi_sz_x + size - 1) // size,
                        pr.hunits)
            rrow1 = min(((mi_row + sb4) * mi_sz_y + size - 1) // size,
                        pr.vunits)
            for rrow in range(rrow0, rrow1):
                for rcol in range(rcol0, rcol1):
                    self._write_lr_unit(
                        plane, pr.frame_rtype,
                        pr.unit_info[rrow * pr.hunits + rcol])

    def _write_lr_unit(self, plane, frame_rtype, ui):
        from ..common import restoration as LR
        rtype, info = ui
        if frame_rtype == LR.RESTORE_SWITCHABLE:
            self.sink.symbol(rtype, LR.RESTORE_SWITCHABLE_TYPES,
                             "switchable_restore_cdf")
            if rtype == LR.RESTORE_WIENER:
                self._write_wiener(plane, info)
            elif rtype == LR.RESTORE_SGRPROJ:
                self._write_sgrproj(plane, info)
        elif frame_rtype == LR.RESTORE_WIENER:
            on = int(rtype == LR.RESTORE_WIENER)
            self.sink.symbol(on, 2, "wiener_restore_cdf")
            if on:
                self._write_wiener(plane, info)
        else:
            on = int(rtype == LR.RESTORE_SGRPROJ)
            self.sink.symbol(on, 2, "sgrproj_restore_cdf")
            if on:
                self._write_sgrproj(plane, info)

    def _write_wiener(self, plane, info):
        """write_wiener_filter (bitstream.c analog of decodeframe.c:1551)."""
        from ..common import restoration as LR
        from .pickrst import write_refsubexpfin
        hf, vf = info
        win = LR.WIENER_WIN if plane == 0 else LR.WIENER_WIN - 2
        ref = self._lr_wiener_ref[plane]
        for key, filt in (("v", vf), ("h", hf)):
            reff = ref[key]
            for tap in range(3):
                if tap == 0 and win != LR.WIENER_WIN:
                    continue
                mn = LR.WIENER_TAP_MIN[tap]
                mx = LR.WIENER_TAP_MAX[tap]
                write_refsubexpfin(self.sink, mx - mn + 1,
                                   LR.WIENER_TAP_K[tap],
                                   reff[tap] - mn, filt[tap] - mn)
        self._lr_wiener_ref[plane] = {"v": list(vf), "h": list(hf)}

    def _write_sgrproj(self, plane, info):
        """write_sgrproj_filter (decodeframe.c:1612 analog)."""
        from ..common import restoration as LR
        from .pickrst import write_literal, write_refsubexpfin
        ep, xqd = info
        write_literal(self.sink, ep, LR.SGRPROJ_PARAMS_BITS)
        r0, r1, _, _ = LR.SGR_PARAMS[ep]
        ref = self._lr_sgr_ref[plane]
        if r0 == 0:
            write_refsubexpfin(
                self.sink, LR.SGRPROJ_PRJ_MAX1 - LR.SGRPROJ_PRJ_MIN1 + 1,
                LR.SGRPROJ_PRJ_SUBEXP_K, ref[1] - LR.SGRPROJ_PRJ_MIN1,
                xqd[1] - LR.SGRPROJ_PRJ_MIN1)
        elif r1 == 0:
            write_refsubexpfin(
                self.sink, LR.SGRPROJ_PRJ_MAX0 - LR.SGRPROJ_PRJ_MIN0 + 1,
                LR.SGRPROJ_PRJ_SUBEXP_K, ref[0] - LR.SGRPROJ_PRJ_MIN0,
                xqd[0] - LR.SGRPROJ_PRJ_MIN0)
        else:
            write_refsubexpfin(
                self.sink, LR.SGRPROJ_PRJ_MAX0 - LR.SGRPROJ_PRJ_MIN0 + 1,
                LR.SGRPROJ_PRJ_SUBEXP_K, ref[0] - LR.SGRPROJ_PRJ_MIN0,
                xqd[0] - LR.SGRPROJ_PRJ_MIN0)
            write_refsubexpfin(
                self.sink, LR.SGRPROJ_PRJ_MAX1 - LR.SGRPROJ_PRJ_MIN1 + 1,
                LR.SGRPROJ_PRJ_SUBEXP_K, ref[1] - LR.SGRPROJ_PRJ_MIN1,
                xqd[1] - LR.SGRPROJ_PRJ_MIN1)
        self._lr_sgr_ref[plane] = list(xqd)

    # ------------------------------------------------------------------
    # partition: RD search pass builds a plan tree, then emit pass codes it
    # ------------------------------------------------------------------

    def _encode_partition(self, mi_row, mi_col, bsize):
        if mi_row >= self.mi_rows or mi_col >= self.mi_cols:
            return
        _, plan = self._search(mi_row, mi_col, bsize)
        if getattr(self, "_sb_plans", None) is not None:
            self._sb_plans.append(plan)   # kept for LR tile re-emit
        self._emit(plan)

    def _fits(self, mi_row, mi_col, bsize):
        n = blockd.mi_size_wide(bsize)
        return (mi_row + n <= self.mi_rows) and (mi_col + n <= self.mi_cols)

    def _subsize_valid(self, sub) -> bool:
        """av1_ss_size_lookup validity: 4:2:2 has no tall-rect chroma
        blocks (common_data.c:17), 4:4:0 no wide rects."""
        if self.ss_x and not self.ss_y:
            return blockd.block_wide(sub) >= blockd.block_high(sub)
        if self.ss_y and not self.ss_x:
            return blockd.block_high(sub) >= blockd.block_wide(sub)
        return True

    def _search(self, mi_row, mi_col, bsize):
        """Return (cost, plan).  Leaves recon holding the chosen branch."""
        if mi_row >= self.mi_rows or mi_col >= self.mi_cols:
            return 0.0, None
        bw = blockd.mi_size_wide(bsize)
        hbs = bw // 2
        has_rows = mi_row + hbs < self.mi_rows
        has_cols = mi_col + hbs < self.mi_cols
        fits = self._fits(mi_row, mi_col, bsize)

        if bsize > c.BLOCK_64X64:
            # encoder policy under 128 superblocks: always split to 64,
            # so no coding block needs the 64x64-chunk residual
            # interleave (spec 5.11.34) on the emit side
            sub = blockd.partition_subsize(bsize, c.PARTITION_SPLIT)
            kids = []
            cost = self._lam(mi_row, mi_col) * 8
            for (r, cc) in ((mi_row, mi_col), (mi_row, mi_col + hbs),
                            (mi_row + hbs, mi_col),
                            (mi_row + hbs, mi_col + hbs)):
                k_cost, k_plan = self._search(r, cc, sub)
                cost += k_cost
                kids.append(k_plan)
            return cost, ("SPLIT", mi_row, mi_col, bsize, kids)

        if not fits:
            # frame-edge structure (no RD choice): prefer HORZ/VERT slab
            # when the half fits, else SPLIT (mirrors the lossless chooser)
            fits_rows = mi_row + bw <= self.mi_rows
            fits_cols = mi_col + bw <= self.mi_cols
            sub_h = blockd.partition_subsize(bsize, c.PARTITION_HORZ)
            sub_v = blockd.partition_subsize(bsize, c.PARTITION_VERT)
            if (bsize > c.BLOCK_8X8 and not has_rows and fits_cols
                    and self._subsize_valid(sub_h)):
                cost, bplan = self._trial_block(mi_row, mi_col, sub_h,
                                                partition=c.PARTITION_HORZ)
                return cost, ("HORZ", mi_row, mi_col, bsize, [bplan])
            if (bsize > c.BLOCK_8X8 and not has_cols and fits_rows
                    and self._subsize_valid(sub_v)):
                cost, bplan = self._trial_block(mi_row, mi_col, sub_v,
                                                partition=c.PARTITION_VERT)
                return cost, ("VERT", mi_row, mi_col, bsize, [bplan])
            # split
            sub = blockd.partition_subsize(bsize, c.PARTITION_SPLIT)
            kids = []
            cost = 0.0
            for (r, cc) in ((mi_row, mi_col), (mi_row, mi_col + hbs),
                            (mi_row + hbs, mi_col), (mi_row + hbs,
                                                     mi_col + hbs)):
                k_cost, k_plan = self._search(r, cc, sub)
                cost += k_cost
                kids.append(k_plan)
            return cost, ("SPLIT", mi_row, mi_col, bsize, kids)

        if bsize <= self.min_bsize or bsize == c.BLOCK_4X4:
            # 4x4 has no partition syntax; min_bsize floors the search
            # (speed feature).  8x8 falls through to the generic trials
            # when min_bsize < 8x8: NONE vs 8x4/4x8 rects vs 4x4 SPLIT
            # (partition_search.c codes these; the old hard floor at
            # 8x8 cost ~5x chroma bits on block-structured content).
            cost, bplan = self._trial_block(mi_row, mi_col, bsize)
            return cost + self._lam(mi_row, mi_col) * 2, ("NONE", mi_row, mi_col, bsize,
                                         [bplan])

        # external partition model decision (external_partition.c)
        ext = self._ext_partition_decision(mi_row, mi_col, bsize)
        if ext == "NONE":
            cost, bplan = self._trial_block(mi_row, mi_col, bsize)
            return cost + self._lam(mi_row, mi_col) * 2, \
                ("NONE", mi_row, mi_col, bsize, [bplan])
        if ext in ("HORZ", "VERT"):
            part = c.PARTITION_HORZ if ext == "HORZ" else c.PARTITION_VERT
            sub = blockd.partition_subsize(bsize, part)
            offs = ((mi_row, mi_col),
                    (mi_row + hbs, mi_col) if ext == "HORZ"
                    else (mi_row, mi_col + hbs))
            cost = self._lam(mi_row, mi_col) * 4
            plans = []
            for (r, cc) in offs:
                k_cost, k_bplan = self._trial_block(r, cc, sub,
                                                    partition=part)
                cost += k_cost
                plans.append(k_bplan)
            return cost, (ext, mi_row, mi_col, bsize, plans)

        # ML partition pruning (models/partition_prune, speed feature:
        # av1_simple_motion_search_prune analog)
        skip_split = False
        skip_none = ext == "SPLIT"
        if self.speed >= 1 and bsize >= c.BLOCK_16X16 and ext is None:
            from ..models.partition_prune import (block_features,
                                                  prob_split)
            p = prob_split(block_features(
                self.src[0], mi_col * 4, mi_row * 4,
                blockd.block_wide(bsize), self.fh.base_q_idx))
            skip_split = p < 0.10
            skip_none = p > 0.93

        if skip_none:
            sub = blockd.partition_subsize(bsize, c.PARTITION_SPLIT)
            kids = []
            cost_split = self._lam(mi_row, mi_col) * 8
            for (r, cc) in ((mi_row, mi_col), (mi_row, mi_col + hbs),
                            (mi_row + hbs, mi_col),
                            (mi_row + hbs, mi_col + hbs)):
                k_cost, k_plan = self._search(r, cc, sub)
                cost_split += k_cost
                kids.append(k_plan)
            return cost_split, ("SPLIT", mi_row, mi_col, bsize, kids)

        # trial NONE with snapshot
        snap = self._save_region(mi_row, mi_col, bsize)
        cost_none, bplan = self._trial_block(mi_row, mi_col, bsize)
        none_recon = self._save_region(mi_row, mi_col, bsize)
        self._restore_region(mi_row, mi_col, bsize, snap)
        best = (cost_none + self._lam(mi_row, mi_col) * 2,
                ("NONE", mi_row, mi_col, bsize, [bplan]), none_recon)

        # trial HORZ / VERT (rect candidates of the 10-type search,
        # partition_search.c:5310; AB/4-way pending)
        if self.rect_parts:
            for part, kind in ((c.PARTITION_HORZ, "HORZ"),
                               (c.PARTITION_VERT, "VERT")):
                sub = blockd.partition_subsize(bsize, part)
                if (blockd.mi_size_wide(sub) < 2 and self.ss_x
                        and bsize > c.BLOCK_8X8):
                    # sub-2-mi-wide rects only exist at 8x8 (4x8),
                    # where chroma rides the 8x8-aligned chroma-ref
                    # rule the decoder already implements
                    continue
                if not self._subsize_valid(sub):
                    continue
                offs = ((mi_row, mi_col),
                        (mi_row + hbs, mi_col)
                        if part == c.PARTITION_HORZ
                        else (mi_row, mi_col + hbs))
                cost = self._lam(mi_row, mi_col) * 4
                plans = []
                for (r, cc) in offs:
                    k_cost, k_bplan = self._trial_block(r, cc, sub,
                                                        partition=part)
                    cost += k_cost
                    plans.append(k_bplan)
                if cost < best[0]:
                    best = (cost, (kind, mi_row, mi_col, bsize, plans),
                            self._save_region(mi_row, mi_col, bsize))
                self._restore_region(mi_row, mi_col, bsize, snap)

        # AB + 4:1 shapes (the rest of the 10-type search,
        # partition_search.c:5310 EXT_PARTITION_TYPES)
        if (self.rect_parts and self.ext_parts
                and c.BLOCK_16X16 <= bsize <= c.BLOCK_64X64):
            bsize2 = blockd.partition_subsize(bsize, c.PARTITION_SPLIT)
            sub_h = blockd.partition_subsize(bsize, c.PARTITION_HORZ)
            sub_v = blockd.partition_subsize(bsize, c.PARTITION_VERT)
            sub_h4 = blockd.partition_subsize(bsize, c.PARTITION_HORZ_4)
            sub_v4 = blockd.partition_subsize(bsize, c.PARTITION_VERT_4)
            qbs = bw // 4
            shapes = [
                ("HORZ_A", [(mi_row, mi_col, bsize2),
                            (mi_row, mi_col + hbs, bsize2),
                            (mi_row + hbs, mi_col, sub_h)]),
                ("HORZ_B", [(mi_row, mi_col, sub_h),
                            (mi_row + hbs, mi_col, bsize2),
                            (mi_row + hbs, mi_col + hbs, bsize2)]),
                ("VERT_A", [(mi_row, mi_col, bsize2),
                            (mi_row + hbs, mi_col, bsize2),
                            (mi_row, mi_col + hbs, sub_v)]),
                ("VERT_B", [(mi_row, mi_col, sub_v),
                            (mi_row, mi_col + hbs, bsize2),
                            (mi_row + hbs, mi_col + hbs, bsize2)]),
                ("HORZ_4", [(mi_row + i * qbs, mi_col, sub_h4)
                            for i in range(4)]),
                ("VERT_4", [(mi_row, mi_col + i * qbs, sub_v4)
                            for i in range(4)]),
            ]
            abmap = {"HORZ_A": c.PARTITION_HORZ_A,
                     "HORZ_B": c.PARTITION_HORZ_B,
                     "VERT_A": c.PARTITION_VERT_A,
                     "VERT_B": c.PARTITION_VERT_B,
                     "HORZ_4": c.PARTITION_HORZ_4,
                     "VERT_4": c.PARTITION_VERT_4}
            for kind, kids_geo in shapes:
                if any(k[2] < 0 or not self._subsize_valid(k[2])
                       for k in kids_geo):
                    continue
                cost = self._lam(mi_row, mi_col) * 6
                plans = []
                for (r, cc, sub) in kids_geo:
                    k_cost, k_bplan = self._trial_block(
                        r, cc, sub, partition=abmap[kind])
                    cost += k_cost
                    plans.append(k_bplan)
                if cost < best[0]:
                    best = (cost, (kind, mi_row, mi_col, bsize, plans),
                            self._save_region(mi_row, mi_col, bsize))
                self._restore_region(mi_row, mi_col, bsize, snap)

        if skip_split:
            self._restore_region(mi_row, mi_col, bsize, best[2])
            return best[0], best[1]

        # trial SPLIT (children keep their recon)
        sub = blockd.partition_subsize(bsize, c.PARTITION_SPLIT)
        kids = []
        cost_split = self._lam(mi_row, mi_col) * 8  # partition signaling overhead
        for (r, cc) in ((mi_row, mi_col), (mi_row, mi_col + hbs),
                        (mi_row + hbs, mi_col), (mi_row + hbs,
                                                 mi_col + hbs)):
            k_cost, k_plan = self._search(r, cc, sub)
            cost_split += k_cost
            kids.append(k_plan)

        if best[0] <= cost_split:
            self._restore_region(mi_row, mi_col, bsize, best[2])
            return best[0], best[1]
        return cost_split, ("SPLIT", mi_row, mi_col, bsize, kids)

    def _save_region(self, mi_row, mi_col, bsize):
        out = []
        for plane in range(self.num_planes):
            ss_x = self.ss_x if plane else 0
            ss_y = self.ss_y if plane else 0
            px = ((mi_col - (mi_col & ss_x)) * 4) >> ss_x
            py = ((mi_row - (mi_row & ss_y)) * 4) >> ss_y
            w = blockd.block_wide(bsize) >> ss_x
            h = blockd.block_high(bsize) >> ss_y
            out.append(self.recon[plane][py:py + h + 4,
                                         px:px + w + 4].copy())
        return out

    def _restore_region(self, mi_row, mi_col, bsize, snap):
        for plane in range(self.num_planes):
            ss_x = self.ss_x if plane else 0
            ss_y = self.ss_y if plane else 0
            px = ((mi_col - (mi_col & ss_x)) * 4) >> ss_x
            py = ((mi_row - (mi_row & ss_y)) * 4) >> ss_y
            s = snap[plane]
            self.recon[plane][py:py + s.shape[0], px:px + s.shape[1]] = s

    # ------------------------------------------------------------------
    # emit pass
    # ------------------------------------------------------------------

    def _emit(self, plan):
        if plan is None:
            return
        kind, mi_row, mi_col, bsize, kids = plan
        hbs = blockd.mi_size_wide(bsize) // 2
        pmap = {"NONE": c.PARTITION_NONE, "HORZ": c.PARTITION_HORZ,
                "VERT": c.PARTITION_VERT, "SPLIT": c.PARTITION_SPLIT,
                "HORZ_A": c.PARTITION_HORZ_A, "HORZ_B": c.PARTITION_HORZ_B,
                "VERT_A": c.PARTITION_VERT_A, "VERT_B": c.PARTITION_VERT_B,
                "HORZ_4": c.PARTITION_HORZ_4, "VERT_4": c.PARTITION_VERT_4}
        partition = pmap[kind]
        if bsize >= c.BLOCK_8X8:
            self._write_partition(mi_row, mi_col, bsize, partition)
        subsize = blockd.partition_subsize(bsize, partition)
        if kind == "NONE":
            self._emit_block(kids[0], partition)
        elif kind == "SPLIT":
            for k in kids:
                self._emit(k)
        else:
            # rect / AB / 4:1: leaves in the decoder's coding order
            for k in kids:
                self._emit_block(k, partition)
        self._update_ext_partition_ctx(mi_row, mi_col, subsize, bsize,
                                       partition)

    # ------------------------------------------------------------------
    # block trial + emit
    # ------------------------------------------------------------------

    def _plane_tx(self, plane, bsize):
        pb = blockd.plane_block_size(bsize, self.ss_x, self.ss_y) \
            if plane else bsize
        tx = blockd.max_tx_size_rect(pb)
        if plane:
            w = min(32, c.TX_WIDTH[tx])
            h = min(32, c.TX_HEIGHT[tx])
            tx = blockd.tx_size_of(w, h)
        return tx

    def _est_txb_bits(self, qcoeff, eob):
        """Crude token bit estimate for RD (skip + eob + levels)."""
        if eob == 0:
            return 0.6
        aq = np.abs(qcoeff)
        nz = aq[aq > 0].astype(np.float64)
        bits = 2.0 + 0.9 * np.log2(eob + 1.0)
        bits += 0.55 * (eob - len(nz))
        bits += float(np.sum(1.7 + 2.0 * np.log2(nz + 1.0)))
        return bits

    def _trial_block(self, mi_row, mi_col, bsize,
                     partition=c.PARTITION_NONE):
        """Mode-search + encode one block; writes recon; returns
        (rd_cost, block_plan).  partition: the partition context the
        block will be coded under (decoder passes bi.partition into
        RefMvContext; inter trials must match it for has_top_right
        parity, mvref_common.c:259)."""
        up_avail = mi_row > 0
        left_avail = mi_col > 0
        # --- luma mode search ---
        best = None
        for mode in self.mode_set:
            dist, bits, txbs = self._code_plane(
                0, mode, mi_row, mi_col, bsize, up_avail, left_avail,
                write_recon=False)
            cost = dist + self._lam(mi_row, mi_col) * (bits + 4.0)
            if best is None or cost < best[0]:
                best = (cost, mode, txbs)
        y_cost, y_mode, y_txbs = best
        pal_y = None
        if self.screen and self._allow_palette_enc(bsize):
            r = self._try_palette_y(mi_row, mi_col, bsize, up_avail,
                                    left_avail)
            if r is not None and r[0] < y_cost:
                y_cost, pal_y, y_txbs = r
                y_mode = c.DC_PRED

        # angle-delta refinement for the winning directional mode
        # (intra_mode_search.c angle_estimation analog: deltas only on
        # the best base angle, not the full mode x delta product)
        y_angle = 0
        if bsize >= c.BLOCK_8X8 and intra.is_directional(y_mode):
            for delta in (-3, -2, -1, 1, 2, 3):
                dist, bits, txbs = self._code_plane(
                    0, y_mode, mi_row, mi_col, bsize, up_avail,
                    left_avail, write_recon=False, angle_delta=delta)
                cost = dist + self._lam(mi_row, mi_col) * (
                    bits + 4.0 + 1.0 + 0.9 * abs(delta))
                if cost < y_cost:
                    y_cost, y_angle, y_txbs = cost, delta, txbs
        # tx-type RD search on the survivor only (tx_search.c is also
        # gated on the winning mode, not run inside the mode loop)
        if self.tx_search and pal_y is None:
            dist, bits, txbs = self._code_plane(
                0, y_mode, mi_row, mi_col, bsize, up_avail, left_avail,
                write_recon=False, angle_delta=y_angle, tx_search=True)
            cost = dist + self._lam(mi_row, mi_col) * (bits + 4.0)
            if cost < y_cost:
                y_cost, y_txbs = cost, txbs
        # filter intra (av1_handle_filter_intra_mode analog): 5 modes,
        # coded as DC + use_filter_intra + fim symbol
        y_fim = -1
        if (self.sh.enable_filter_intra and pal_y is None
                and blockd.block_wide(bsize) <= 32
                and blockd.block_high(bsize) <= 32):
            for fim in range(c.FILTER_INTRA_MODES):
                dist, bits, txbs = self._code_plane(
                    0, c.DC_PRED, mi_row, mi_col, bsize, up_avail,
                    left_avail, write_recon=False, fim=fim)
                cost = dist + self._lam(mi_row, mi_col) * (bits + 7.0)
                if cost < y_cost:
                    y_cost, y_mode, y_angle, y_fim, y_txbs = \
                        cost, c.DC_PRED, 0, fim, txbs
        # tx-size depth search under TX_MODE_SELECT
        # (av1_pick_uniform_tx_size_type_yrd: uniform depth per block)
        if self.tx_select and pal_y is None and bsize > c.BLOCK_4X4:
            from ..decoder.inter import _MAX_DEPTH, depth_to_tx_size
            for depth in range(1, min(_MAX_DEPTH[bsize], 2) + 1):
                dist, bits, txbs = self._code_plane(
                    0, y_mode, mi_row, mi_col, bsize, up_avail,
                    left_avail, write_recon=False, angle_delta=y_angle,
                    tx_search=self.tx_search, fim=y_fim,
                    tx_size_override=depth_to_tx_size(depth, bsize))
                cost = dist + self._lam(mi_row, mi_col) * (
                    bits + 4.0 + 2.0 * depth)
                if cost < y_cost:
                    y_cost, y_txbs = cost, txbs
        # write luma recon for the chosen mode (chroma CfL needs it)
        self._apply_txbs(0, y_txbs)

        # --- chroma ---
        is_chroma_ref = blockd.is_chroma_reference(
            mi_row, mi_col, bsize, self.ss_x, self.ss_y) \
            and self.num_planes > 1
        uv_mode = c.DC_PRED
        cfl = None
        uv_cost = 0.0
        uv_txbs = []
        if is_chroma_ref:
            uv_cost, uv_mode, cfl, uv_txbs = self._pick_uv(
                mi_row, mi_col, bsize, up_avail, left_avail, y_txbs)
            for plane in (1, 2):
                self._apply_txbs(plane,
                                 [t for t in uv_txbs if t["plane"] == plane])
        # intraBC candidate replaces the whole block (luma + chroma)
        if self.intrabc:
            r = self._try_intrabc(mi_row, mi_col, bsize)
            if r is not None and r[0] < y_cost + uv_cost:
                cost, dv, txbs = r
                for plane in range(self.num_planes):
                    self._apply_txbs(plane, [t for t in txbs
                                             if t["plane"] == plane])
                return cost, dict(
                    mi_row=mi_row, mi_col=mi_col, bsize=bsize,
                    y_mode=c.DC_PRED, y_angle=0, uv_mode=c.DC_PRED,
                    cfl=None, pal_y=None, intrabc_dv=dv, txbs=txbs,
                    is_chroma_ref=is_chroma_ref)

        return y_cost + uv_cost, dict(
            mi_row=mi_row, mi_col=mi_col, bsize=bsize, y_mode=y_mode,
            y_angle=y_angle, uv_mode=uv_mode, cfl=cfl, pal_y=pal_y,
            fim=y_fim,
            txbs=y_txbs + uv_txbs, is_chroma_ref=is_chroma_ref)

    def _emit_intrabc(self, bplan, dv, mi_row, mi_col, bsize, partition,
                      skip):
        """Write the DV (decoder._read_intrabc_info mirror: INTRA_FRAME
        ref-MV stack + ndvc contexts) and the inter-style residual."""
        from ..common import mvref as MR
        bw = blockd.mi_size_wide(bsize)
        bh = blockd.mi_size_high(bsize)
        ctx = MR.RefMvContext(self.g, mi_row, mi_col, bsize, self.sb_mi,
                              0, self.mi_rows, 0, self.mi_cols, partition)
        _, _, _, _, mv_list = MR.find_mv_refs(ctx, c.INTRA_FRAME)
        nearest = MR.lower_mv_precision(mv_list[0], 0, 0)
        near = MR.lower_mv_precision(mv_list[1], 0, 0)
        dv_ref = near if nearest == (0, 0) else nearest
        if dv_ref == (0, 0):
            dv_ref = MR.find_ref_dv(0, self.sb_mi, mi_row)
        dv_ref = ((dv_ref[0] >> 3) * 8, (dv_ref[1] >> 3) * 8)
        self._write_dv(dv, dv_ref)

        # bookkeeping: intrabc blocks are inter-like in the MI grids
        rmax = min(mi_row + bh, self.mi_rows)
        cmax = min(mi_col + bw, self.mi_cols)
        self.mi_skip[mi_row:rmax, mi_col:cmax] = int(skip)
        self.mi_mode[mi_row:rmax, mi_col:cmax] = c.DC_PRED
        self.mi_bsize[mi_row:rmax, mi_col:cmax] = bsize
        self.pal_size_y[mi_row:rmax, mi_col:cmax] = 0
        self.g.fill_block(mi_row, mi_col, bh, bw, MR.INTRABC_REF, -1,
                          c.DC_PRED, bsize, partition, dv, (0, 0))

        # residual: inter skip semantics (reset contexts wholesale)
        if skip:
            for plane in range(self.num_planes
                               if bplan["is_chroma_ref"] else 1):
                ss_x = self.ss_x if plane else 0
                ss_y = self.ss_y if plane else 0
                pb = blockd.plane_block_size(bsize, ss_x, ss_y) if plane \
                    else bsize
                acol = (mi_col >> ss_x) if plane else mi_col
                lrow = (mi_row >> ss_y) if plane else mi_row
                self.above_entropy[plane][
                    acol:acol + (blockd.block_wide(pb) >> 2)] = 0
                self.left_entropy[plane][
                    lrow:lrow + (blockd.block_high(pb) >> 2)] = 0
            return
        for t in bplan["txbs"]:
            plane = t["plane"]
            au = self.above_entropy[plane]
            lu = self.left_entropy[plane]
            acol, lrow = t["acol"], t["lrow"]
            txw = c.TX_WIDTH[t["tx_size"]] >> 2
            txh = c.TX_HEIGHT[t["tx_size"]] >> 2
            skip_ctx2, dc_sign_ctx = CF.txb_ctx(
                t["plane_bsize"], t["tx_size"], plane,
                au[acol:acol + txw], lu[lrow:lrow + txh])
            cul = self.sink.txb(t["qcoeff"], plane, skip_ctx2,
                                dc_sign_ctx, tx_size=t["tx_size"],
                                tx_type=t["tx_type"],
                                tx_type_sym=t["tx_type_sym"])
            CF.set_entropy_spans(
                au, lu, acol, lrow, txw, txh, cul,
                t.get("vis_w4", txw), t.get("vis_h4", txh),
                t.get("loc_c4", 0), t.get("loc_r4", 0),
                t.get("cross_r", False), t.get("cross_b", False))

    def _write_dv(self, dv, dv_ref):
        """Mirror of decoder._read_mv(dv=True) with MV_SUBPEL_NONE: no
        fp/hp symbols (assign_dv, decodemv.c:677)."""
        dr = dv[0] - dv_ref[0]
        dc = dv[1] - dv_ref[1]
        joint = (1 if dc else 0) | (2 if dr else 0)
        self.sink.symbol(joint, 4, "ndv_joints_cdf")
        for d, comp in ((dr, 0), (dc, 1)):
            if not d:
                continue
            pre = f"ndv_comp{comp}_"
            sign = 1 if d < 0 else 0
            z = abs(d) - 1
            from .inter import _mv_class
            cls, offset = _mv_class(z)
            self.sink.symbol(sign, 2, pre + "sign_cdf")
            self.sink.symbol(cls, 11, pre + "classes_cdf")
            intd = offset >> 3
            assert (offset & 7) == 7, "DV deltas are full-pel (fr=3 hp=1)"
            if cls == 0:
                self.sink.symbol(intd, 2, pre + "class0_cdf")
            else:
                for i in range(cls):
                    self.sink.symbol((intd >> i) & 1, 2,
                                     pre + "bits_cdf", i)
            # MV_SUBPEL_NONE: fr/hp not coded

    def _emit_segment_id(self, mi_row, mi_col, bsize, skip):
        """write_segment_id mirror of decoder._read_segment_id (spatial
        pred + neg_interleave; skip blocks inherit the prediction)."""
        m = self.seg_emit_map
        up = mi_row > 0
        left = mi_col > 0
        prev_ul = int(m[mi_row - 1, mi_col - 1]) if (up and left) else -1
        prev_u = int(m[mi_row - 1, mi_col]) if up else -1
        prev_l = int(m[mi_row, mi_col - 1]) if left else -1
        if prev_ul < 0:
            cdf_index = 0
        elif prev_ul == prev_u and prev_ul == prev_l:
            cdf_index = 2
        elif prev_ul == prev_u or prev_ul == prev_l or prev_u == prev_l:
            cdf_index = 1
        else:
            cdf_index = 0
        if prev_u < 0:
            pred = 0 if prev_l < 0 else prev_l
        elif prev_l < 0:
            pred = prev_u
        else:
            pred = prev_u if prev_ul == prev_u else prev_l
        if skip:
            seg = pred   # decoder adopts the prediction, uncoded
        else:
            seg = int(self.seg_plan[mi_row, mi_col])
            mx = self.fh.seg_last_active + 1
            coded = _neg_interleave(seg, pred, mx)
            self.sink.symbol(coded, c.MAX_SEGMENTS,
                             "seg_spatial_pred_cdf", cdf_index)
        h4 = min(blockd.mi_size_high(bsize), self.mi_rows - mi_row)
        w4 = min(blockd.mi_size_wide(bsize), self.mi_cols - mi_col)
        m[mi_row:mi_row + h4, mi_col:mi_col + w4] = seg

    def _write_delta_q(self, d):
        """write_delta_qindex (bitstream.c): symbol + exp-golomb tail +
        sign, mirror of decoder._read_delta_q_params.read_delta."""
        abs_v = abs(d)
        self.sink.symbol(min(abs_v, 3), 4, "delta_q_cdf")
        if abs_v >= 3:
            rem_bits = (abs_v - 1).bit_length() - 1
            thr = (1 << rem_bits) + 1
            for k in range(2, -1, -1):
                self.sink.bit(((rem_bits - 1) >> k) & 1)
            for k in range(rem_bits - 1, -1, -1):
                self.sink.bit(((abs_v - thr) >> k) & 1)
        if abs_v:
            self.sink.bit(int(d < 0))

    # --- palette (screen content) --------------------------------------

    def _allow_palette_enc(self, bsize):
        """av1_allow_palette: 8x8..64x64."""
        return (bsize >= c.BLOCK_8X8
                and blockd.block_wide(bsize) <= 64
                and blockd.block_high(bsize) <= 64)

    def _pal_neighbor(self, mi_row, mi_col):
        """Neighbor luma palette view for ctx/cache (pred_common.c:73)."""
        if mi_row < 0 or mi_col < 0:
            return None
        colors = self.pal_colors_y.get((mi_row, mi_col))
        if not colors:
            return None

        class _Nb:
            palette_size = (len(colors), 0)
            palette_colors = [list(colors), [], []]
        return _Nb

    def _pal_cache(self, mi_row, mi_col):
        """av1_get_palette_cache for luma: above gated at 64px SB rows."""
        above = self._pal_neighbor(mi_row - 1, mi_col) \
            if (mi_row * 4) % 64 else None
        left = self._pal_neighbor(mi_row, mi_col - 1)
        return PAL.get_palette_cache(above, left, 0)

    def _try_palette_y(self, mi_row, mi_col, bsize, up_avail, left_avail):
        """av1_rd_pick_palette_intra_sby analog: candidate palettes by
        exact-colors / k-means, nearest-color index map, residual coded
        like any intra block.  Returns (cost, pal_plan, txbs) or None."""
        pbw = blockd.block_wide(bsize)
        pbh = blockd.block_high(bsize)
        bw = blockd.mi_size_wide(bsize)
        bh = blockd.mi_size_high(bsize)
        mb_to_right = (self.mi_cols - bw - mi_col) * 4
        mb_to_bottom = (self.mi_rows - bh - mi_row) * 4
        cols_px = pbw + min(mb_to_right, 0)
        rows_px = pbh + min(mb_to_bottom, 0)
        py, px = mi_row * 4, mi_col * 4
        src = self.src[0][py:py + rows_px, px:px + cols_px]
        cache = self._pal_cache(mi_row, mi_col)
        lam = self._lam(mi_row, mi_col)
        best = None
        for pal in PAL.palette_candidates(src):
            n = len(pal)
            cmap = np.zeros((pbh, pbw), np.uint8)
            cmap[:rows_px, :cols_px] = np.argmin(
                np.abs(src[:, :, None].astype(np.int32)
                       - pal[None, None, :]), axis=2).astype(np.uint8)
            # edge replication (decode_color_map tail)
            if cols_px < pbw:
                cmap[:rows_px, cols_px:] = cmap[:rows_px,
                                                cols_px - 1:cols_px]
            if rows_px < pbh:
                cmap[rows_px:, :] = cmap[rows_px - 1:rows_px, :]
            pred_full = np.asarray(pal, np.int32)[cmap] \
                .astype(self.recon[0].dtype)
            dist, rbits, txbs = self._code_plane(
                0, c.DC_PRED, mi_row, mi_col, bsize, up_avail, left_avail,
                write_recon=False, pred_full=pred_full,
                tx_search=self.tx_search)
            found, out = PAL.index_color_cache(cache, list(pal))
            hdr_bits = (4.0 + len(found) + 2.0
                        + len(out) * (self.bd - 1.0))
            map_bits = PAL.map_rate_estimate(cmap, rows_px, cols_px, n)
            cost = dist + lam * (rbits + hdr_bits + map_bits)
            if best is None or cost < best[0]:
                best = (cost, dict(colors=[int(v) for v in pal],
                                   cmap=cmap, rows=rows_px, cols=cols_px),
                        txbs)
        return best

    def _cfl_allowed_enc(self, bsize):
        # spec-CfL also covers sub-8x8 blocks (shared 8x8 chroma ref),
        # but _try_cfl's luma-subsample geometry assumes the block IS
        # the chroma-ref unit — keep the encoder trial >= 8x8
        return (c.BLOCK_8X8 <= bsize
                and blockd.block_wide(bsize) <= 32
                and blockd.block_high(bsize) <= 32)

    def _apply_txbs(self, plane, txbs):
        for t in txbs:
            self.recon[plane][t["py"]:t["py"] + t["recon"].shape[0],
                              t["px"]:t["px"] + t["recon"].shape[1]] = \
                t["recon"]

    # --- intraBC --------------------------------------------------------

    def _try_intrabc(self, mi_row, mi_col, bsize):
        """Hash-search a DV and RD-code the whole block from the current
        recon (av1 intrabc encode path; encoder/intrabc.py)."""
        from . import intrabc as IBC
        if bsize < c.BLOCK_8X8:
            return None
        bw = blockd.block_wide(bsize)
        bh = blockd.block_high(bsize)
        y0, x0 = mi_row * 4, mi_col * 4
        if y0 + bh > self.mi_rows * 4 or x0 + bw > self.mi_cols * 4:
            return None
        src = self.src[0]
        if self._ibc_index is None:
            self._ibc_index = IBC.build_hash_index(
                src[:self.mi_rows * 4, :self.mi_cols * 4])
        s = min(bw, bh, 64)
        blk = src[y0:y0 + bh, x0:x0 + bw]
        sb_log2 = self.sb_mi.bit_length() - 1
        best = None
        for (cy, cx) in IBC.hash_candidates(self._ibc_index, src, y0, x0,
                                            s):
            if not np.array_equal(src[cy:cy + bh, cx:cx + bw], blk):
                continue
            dv = ((cy - y0) * 8, (cx - x0) * 8)
            if not IBC.dv_valid(dv[0], dv[1], mi_row, mi_col, bw, bh,
                                self.mi_rows, self.mi_cols, sb_log2):
                continue
            cost, txbs = self._code_intrabc(mi_row, mi_col, bsize, dv)
            if best is None or cost < best[0]:
                best = (cost, dv, txbs)
            break   # first valid hash match is an exact copy
        return best

    def _code_intrabc(self, mi_row, mi_col, bsize, dv):
        """Residual-code all planes against the DV prediction."""
        from . import intrabc as IBC
        bw4 = blockd.mi_size_wide(bsize)
        bh4 = blockd.mi_size_high(bsize)
        mi_x, mi_y = mi_col * 4, mi_row * 4
        mb_to_left = -mi_x
        mb_to_right = (self.mi_cols - bw4 - mi_col) * 4
        mb_to_top = -mi_y
        mb_to_bottom = (self.mi_rows - bh4 - mi_row) * 4
        dist = 0.0
        bits = 14.0 + (np.log2(abs(dv[0]) / 8 + 1)
                       + np.log2(abs(dv[1]) / 8 + 1)) * 2.0
        txbs = []
        for plane in range(self.num_planes):
            ss_x = self.ss_x if plane else 0
            ss_y = self.ss_y if plane else 0
            b_w = blockd.block_wide(bsize) >> ss_x
            b_h = blockd.block_high(bsize) >> ss_y
            x0 = mi_x >> ss_x
            y0 = mi_y >> ss_y
            pred = IBC.predict_intrabc(
                self.recon, plane, x0, y0, b_w, b_h, dv, ss_x, ss_y,
                mb_to_left, mb_to_right, mb_to_top, mb_to_bottom,
                self.bd).astype(self.recon[plane].dtype)
            d, b, t = self._code_plane(
                plane, c.DC_PRED, mi_row, mi_col, bsize,
                mi_row > 0, mi_col > 0, write_recon=False,
                pred_full=pred, inter_tx=True,
                tx_search=self.tx_search and plane == 0)
            dist += d
            bits += b
            txbs += t
        return dist + self._lam(mi_row, mi_col) * bits, txbs

    def _code_plane(self, plane, mode, mi_row, mi_col, bsize, up_avail,
                    left_avail, write_recon, pred_override=None,
                    angle_delta=0, pred_full=None, inter_tx=False,
                    tx_search=False, tx_size_override=None, fim=-1):
        """Predict/transform/quantize all txbs of one plane for `mode`.

        Returns (dist, bits, txb list).  Does not touch self.recon unless
        write_recon (txbs carry their recon blocks for later apply)."""
        ss_x = self.ss_x if plane else 0
        ss_y = self.ss_y if plane else 0
        bw = blockd.mi_size_wide(bsize)
        bh = blockd.mi_size_high(bsize)
        chroma_up = up_avail if not (plane and self.ss_y and bh < 2) \
            else (mi_row - 1) > 0
        chroma_left = left_avail if not (plane and self.ss_x and bw < 2) \
            else (mi_col - 1) > 0
        plane_bsize = blockd.plane_block_size(bsize, ss_x, ss_y) \
            if plane else bsize
        pbw = blockd.block_wide(plane_bsize)
        pbh = blockd.block_high(plane_bsize)
        tx_size = self._plane_tx(plane, bsize) if tx_size_override is None \
            else tx_size_override
        txw4 = c.TX_WIDTH[tx_size] >> 2
        txh4 = c.TX_HEIGHT[tx_size] >> 2
        row0 = ((mi_row - (mi_row & ss_y)) * 4) >> ss_y if plane \
            else mi_row * 4
        col0 = ((mi_col - (mi_col & ss_x)) * 4) >> ss_x if plane \
            else mi_col * 4
        mb_to_right = (self.mi_cols - bw - mi_col) * 4
        mb_to_bottom = (self.mi_rows - bh - mi_row) * 4
        vis_w = pbw + (min(mb_to_right, 0) >> ss_x)
        vis_h = pbh + (min(mb_to_bottom, 0) >> ss_y)
        reduced = bool(self.fh.reduced_tx_set)
        st = TT.ext_tx_set_type(tx_size, inter_tx, reduced)

        def _sym_for(tt):
            """Signalling tuple for the emit path (None = derived)."""
            if plane != 0 or TT.NUM_EXT_TX_SET[st] <= 1:
                return None
            if inter_tx:
                return (("inter_ext_tx_cdf", TT.inter_ext_tx_idx(st),
                         c.TX_SIZE_SQR[tx_size]),
                        TT.EXT_TX_IND[st][tt], TT.NUM_EXT_TX_SET[st])
            # filter-intra blocks use the mapped directional mode as the
            # tx-type cdf context (decodemv.c:659 fimode_to_intradir)
            from ..decoder.decoder import FIMODE_TO_INTRADIR
            ctx_mode = FIMODE_TO_INTRADIR[fim] if fim >= 0 else mode
            return (("intra_ext_tx_cdf", TT.intra_ext_tx_idx(st),
                     c.TX_SIZE_SQR[tx_size], ctx_mode),
                    TT.EXT_TX_IND[st][tt], TT.NUM_EXT_TX_SET[st])

        if plane == 0:
            cand_types = [c.DCT_DCT]
            if tx_search and TT.NUM_EXT_TX_SET[st] > 1:
                # tx_search.c get_tx_mask analog: derived type + the
                # DTT4 combos; IDTX for screen/inter content
                used = TT.EXT_TX_USED[st]
                want = [c.ADST_ADST, c.ADST_DCT, c.DCT_ADST]
                if not inter_tx and mode < len(TT.INTRA_MODE_TO_TX_TYPE):
                    want.insert(0, TT.INTRA_MODE_TO_TX_TYPE[mode])
                if inter_tx or self.screen:
                    want.append(c.IDTX)
                for tt in want:
                    if used[tt] and tt not in cand_types:
                        cand_types.append(tt)
        else:
            cand_types = [TT.chroma_intra_tx_type(mode, tx_size, reduced)]
        pq = self._pq_at(plane, mi_row, mi_col)
        adj = CF.adjusted_tx_size(tx_size)
        log_scale = CF._tx_scale(tx_size)
        qm_pair = None
        if self.fh.using_qmatrix and self.fh.base_q_idx > 0:
            level = (self.fh.qm_y, self.fh.qm_u, self.fh.qm_v)[plane]
            if level < 15:
                qm_pair = (Q.qm_table(level, int(plane > 0), tx_size),
                           Q.iqm_table(level, int(plane > 0), tx_size))
        dist = 0.0
        bits = 0.0
        txbs = []
        # multi-txb blocks: interior txbs predict from earlier txbs'
        # recon, so stage it in self.recon and restore afterwards
        n_txbs = len(range(0, max(vis_h >> 2, 1), txh4)) \
            * len(range(0, max(vis_w >> 2, 1), txw4))
        stage = n_txbs > 1 and pred_override is None and pred_full is None
        snap = (self.recon[plane][row0:row0 + pbh,
                                  col0:col0 + pbw].copy()
                if stage and not write_recon else None)
        for r4 in range(0, max(vis_h >> 2, 1), txh4):
            for c4 in range(0, max(vis_w >> 2, 1), txw4):
                pred_mode = mode if mode != c.UV_CFL_PRED else c.DC_PRED
                if pred_full is not None:
                    # whole-block prediction (palette): slice this txb
                    pred = pred_full[r4 * 4:r4 * 4 + c.TX_HEIGHT[tx_size],
                                     c4 * 4:c4 * 4 + c.TX_WIDTH[tx_size]]
                else:
                    pred = self._predict(plane, pred_mode, mi_row, mi_col,
                                         bsize, tx_size, r4, c4,
                                         chroma_up if (plane and ss_y)
                                         else up_avail,
                                         chroma_left if (plane and ss_x)
                                         else left_avail,
                                         angle_delta=angle_delta, fim=fim)
                if pred_override is not None:
                    pred = pred_override
                py = row0 + r4 * 4
                px = col0 + c4 * 4
                h, w = pred.shape
                src = self.src[plane][py:py + h, px:px + w]
                resid = src.astype(np.int32) - pred.astype(np.int32)
                best = None
                for tt in cand_types:
                    scan = tables.scan(adj, tt)
                    qm_w, qm_iw = (qm_pair if (qm_pair is not None
                                               and tt < c.IDTX)
                                   else (None, None))
                    coeff = T2.fwd_txfm2d(resid, tx_size, tt, self.bd)
                    qcoeff, dqcoeff, eob = Q.quantize_b(coeff, scan, pq,
                                                        log_scale, qm=qm_w,
                                                        iqm=qm_iw)
                    if self.trellis and eob and qm_w is None:
                        qcoeff, dqcoeff, eob = Q.optimize_txb(
                            qcoeff, dqcoeff, coeff, scan, pq, log_scale,
                            eob, self._lam(mi_row, mi_col),
                            Q.tx_gain(tx_size, tt))
                    recon = (T2.inv_txfm2d_add(dqcoeff, pred, tx_size, tt,
                                               self.bd)
                             if eob else pred)
                    d = float(((src.astype(np.int64)
                                - recon.astype(np.int64)) ** 2).sum())
                    b = self._est_txb_bits(qcoeff, eob)
                    if len(cand_types) > 1:
                        # approx signalling cost under the default CDFs
                        b += 1.5 if tt == c.DCT_DCT else 3.0
                    cost = d + self._lam(mi_row, mi_col) * b
                    if best is None or cost < best[0]:
                        best = (cost, tt, qcoeff, eob, recon, d, b)
                _, tx_type, qcoeff, eob, recon, d, b = best
                tx_type_sym = _sym_for(tx_type)
                dist += d
                bits += b
                txbs.append(dict(
                    plane=plane, tx_size=tx_size, tx_type=tx_type,
                    tx_type_sym=tx_type_sym, qcoeff=qcoeff, eob=eob,
                    plane_bsize=plane_bsize, py=py, px=px, recon=recon,
                    acol=px >> 2, lrow=py >> 2,
                    loc_c4=c4, loc_r4=r4,
                    vis_w4=max(vis_w >> 2, 1), vis_h4=max(vis_h >> 2, 1),
                    cross_r=mb_to_right < 0, cross_b=mb_to_bottom < 0))
                if write_recon or stage:
                    self.recon[plane][py:py + h, px:px + w] = recon
        if snap is not None:
            self.recon[plane][row0:row0 + pbh, col0:col0 + pbw] = snap
        return dist, bits, txbs

    # --- chroma mode RD ------------------------------------------------

    #: UV intra mode candidates beyond DC (av1_rd_pick_intra_sbuv_mode,
    #: rdopt.c:3296 region: the reference RD-searches every UV mode;
    #: restricting chroma to DC+CfL was measured to cost 5x chroma bits
    #: on content whose chroma has directional structure).  Ordered
    #: cheap-to-likely; the sweep full-codes each candidate (chroma
    #: planes are quarter-size, so this is ~10% of the luma mode sweep).
    _UV_MODES = (c.DC_PRED, c.V_PRED, c.H_PRED, c.PAETH_PRED,
                 c.SMOOTH_PRED, c.SMOOTH_V_PRED, c.SMOOTH_H_PRED,
                 c.D45_PRED, c.D67_PRED, c.D113_PRED, c.D135_PRED,
                 c.D157_PRED, c.D203_PRED)

    def _pick_uv(self, mi_row, mi_col, bsize, up_avail, left_avail,
                 y_txbs):
        """RD-pick the chroma mode: all 13 UV intra modes + CfL.

        Returns (cost, uv_mode, cfl, uv_txbs) like the old DC/CfL pair
        decision but over the full mode set.  Signalling cost is
        approximated from the uv_mode_cdf shape (DC cheapest, modes far
        from the luma mode dearer) plus the angle-delta symbol for
        directional modes at bsize >= 8x8."""
        lam = self._lam(mi_row, mi_col)
        best = None
        for m in (self._UV_MODES if self.uv_mode_search
                  else (c.DC_PRED,)):
            dist = 0.0
            bits = 0.0
            txbs = []
            for plane in (1, 2):
                d, b, t = self._code_plane(
                    plane, m, mi_row, mi_col, bsize, up_avail,
                    left_avail, write_recon=False)
                dist += d
                bits += b
                txbs += t
            sig = 2.0 if m == c.DC_PRED else 4.0
            if (bsize >= c.BLOCK_8X8 and intra.is_directional(m)):
                sig += 2.0          # angle_delta symbol (coded as 0)
            cost = dist + lam * (bits + sig)
            if best is None or cost < best[0]:
                best = (cost, m, None, txbs)
        if self.enable_cfl and self._cfl_allowed_enc(bsize):
            r = self._try_cfl(mi_row, mi_col, bsize, up_avail,
                              left_avail,
                              luma_tx=next((t["tx_size"] for t in y_txbs
                                            if t["plane"] == 0), None))
            if r is not None and r[0] < best[0]:
                best = r
        return best

    # --- CfL ----------------------------------------------------------

    def _try_cfl(self, mi_row, mi_col, bsize, up_avail, left_avail,
                 luma_tx=None):
        """LS-fit CfL alphas; returns (cost, UV_CFL_PRED, (sign,idx), txbs)
        or None."""
        ss_x, ss_y = self.ss_x, self.ss_y
        px = ((mi_col - (mi_col & ss_x)) * 4)
        py = ((mi_row - (mi_row & ss_y)) * 4)
        w = blockd.block_wide(bsize)
        h = blockd.block_high(bsize)
        # cfl_store_block clips to the visible area aligned up to the
        # luma tx dims; the rest is pad-replicated (decoder mirror)
        txw = c.TX_WIDTH[luma_tx] if luma_tx is not None else w
        txh = c.TX_HEIGHT[luma_tx] if luma_tx is not None else h
        vis_w = min(w, max((self.mi_cols - mi_col) * 4, 4))
        vis_h = min(h, max((self.mi_rows - mi_row) * 4, 4))
        sw = min(w, -(-vis_w // txw) * txw)
        sh_ = min(h, -(-vis_h // txh) * txh)
        luma = self.recon[0][py:py + sh_, px:px + sw]
        if ss_x and ss_y:
            q3 = intra.cfl_subsample_420(luma)
        elif ss_x:      # 4:2:2 (cfl_luma_subsampling_422)
            l32 = luma.astype(np.int32)
            q3 = (l32[:, 0::2] + l32[:, 1::2]) << 2
        else:
            q3 = luma.astype(np.int32) << 3
        if q3.shape != (h >> ss_y, w >> ss_x):
            full = np.empty((h >> ss_y, w >> ss_x), np.int32)
            qh, qw = q3.shape
            full[:qh, :qw] = q3
            full[:qh, qw:] = q3[:, qw - 1:qw]
            full[qh:, :] = full[qh - 1:qh, :]
            q3 = full
        npl = q3.size.bit_length() - 1
        avg = (int(q3.sum()) + (1 << npl >> 1)) >> npl
        ac = q3.astype(np.int64) - avg
        den = float((ac * ac).sum())
        if den < 1:
            return None
        alphas = []
        preds = []
        for plane in (1, 2):
            cpx = px >> ss_x
            cpy = py >> ss_y
            ch, cw = ac.shape
            dc_pred = self._predict(plane, c.DC_PRED, mi_row, mi_col, bsize,
                                    self._plane_tx(plane, bsize), 0, 0,
                                    up_avail, left_avail)
            src = self.src[plane][cpy:cpy + ch, cpx:cpx + cw]
            num = float((ac[:src.shape[0], :src.shape[1]]
                         * (src.astype(np.int64)
                            - dc_pred[:src.shape[0],
                                      :src.shape[1]].astype(np.int64))).sum())
            alpha = int(round(64.0 * num / den / 8.0))  # alpha_q3
            alpha = max(-16, min(16, alpha))
            alphas.append(alpha)
            preds.append(dc_pred)
        if alphas[0] == 0 and alphas[1] == 0:
            return None
        # map to joint sign + idx
        su = 0 if alphas[0] == 0 else (2 if alphas[0] > 0 else 1)
        sv = 0 if alphas[1] == 0 else (2 if alphas[1] > 0 else 1)
        joint = su * 3 + sv - 1
        idx = 0
        if su:
            idx |= (abs(alphas[0]) - 1) << 4
        if sv:
            idx |= (abs(alphas[1]) - 1)
        dist = 0.0
        bits = 10.0  # sign + alpha syms
        txbs = []
        for k, plane in enumerate((1, 2)):
            alpha = intra.cfl_idx_to_alpha(idx, joint, plane - 1)
            pred = intra.cfl_predict(preds[k], q3, alpha, self.bd)
            d, b, t = self._code_plane(
                plane, c.UV_CFL_PRED, mi_row, mi_col, bsize, up_avail,
                left_avail, write_recon=False, pred_override=pred)
            dist += d
            bits += b
            txbs += t
        return dist + self._lam(mi_row, mi_col) * bits, c.UV_CFL_PRED, (joint, idx), txbs

    # ------------------------------------------------------------------

    def _emit_block(self, bplan, partition):
        mi_row, mi_col, bsize = bplan["mi_row"], bplan["mi_col"], \
            bplan["bsize"]
        y_mode, uv_mode, cfl = bplan["y_mode"], bplan["uv_mode"], \
            bplan["cfl"]
        bw = blockd.mi_size_wide(bsize)
        bh = blockd.mi_size_high(bsize)
        up_avail = mi_row > 0
        left_avail = mi_col > 0
        txbs = bplan["txbs"]
        skip = all(t["eob"] == 0 for t in txbs)

        above_mi = (mi_row - 1, mi_col) if up_avail else None
        left_mi = (mi_row, mi_col - 1) if left_avail else None
        skip_ctx = (int(self.mi_skip[above_mi]) if above_mi else 0) + \
                   (int(self.mi_skip[left_mi]) if left_mi else 0)
        self.sink.symbol(int(skip), 2, "skip_txfm_cdfs", skip_ctx)
        if self.seg_on:
            self._emit_segment_id(mi_row, mi_col, bsize, int(skip))
        # delta-q (read_delta_q_params order: after skip+cdef, before mode)
        if self.fh.delta_q_present:
            sbm = self.sb_mi
            first = (mi_row & (sbm - 1)) == 0 and (mi_col & (sbm - 1)) == 0
            if first and (bsize != self.sb_size or not skip):
                tgt = self._block_qindex(mi_row, mi_col)
                d = (tgt - self._emit_cur_q) >> self.fh.delta_q_res_log2
                self._write_delta_q(d)
                self._emit_cur_q = tgt
        if self.intrabc:
            dv = bplan.get("intrabc_dv")
            self.sink.symbol(int(dv is not None), 2, "intrabc_cdf")
            if dv is not None:
                self._emit_intrabc(bplan, dv, mi_row, mi_col, bsize,
                                   partition, skip)
                return
            # non-intrabc blocks still land in the MI grids for the
            # decoder-mirrored DV-prediction scans
            self.g.fill_block(mi_row, mi_col, bh, bw, c.INTRA_FRAME, -1,
                              bplan["y_mode"], bsize, partition,
                              (0, 0), (0, 0))
        above_mode = int(self.mi_mode[above_mi]) if above_mi else c.DC_PRED
        left_mode = int(self.mi_mode[left_mi]) if left_mi else c.DC_PRED
        self.sink.symbol(y_mode, c.INTRA_MODES, "kf_y_cdf",
                         INTRA_MODE_CONTEXT[above_mode],
                         INTRA_MODE_CONTEXT[left_mode])
        use_angle_delta = bsize >= c.BLOCK_8X8
        if use_angle_delta and intra.is_directional(y_mode):
            self.sink.symbol(MAX_ANGLE_DELTA + bplan.get("y_angle", 0),
                             2 * MAX_ANGLE_DELTA + 1,
                             "angle_delta_cdf", y_mode - c.V_PRED)
        if bplan["is_chroma_ref"]:
            cfl_allowed = self._cfl_allowed_enc(bsize)
            self.sink.symbol(
                uv_mode, c.UV_INTRA_MODES - int(not cfl_allowed),
                "uv_mode_cdf", int(cfl_allowed), y_mode)
            if uv_mode == c.UV_CFL_PRED:
                joint, idx = cfl
                self.sink.symbol(joint, c.CFL_JOINT_SIGNS, "cfl_sign_cdf")
                if intra.cfl_sign_u(joint) != 0:
                    self.sink.symbol(idx >> 4, c.CFL_ALPHABET_SIZE,
                                     "cfl_alpha_cdf",
                                     intra.cfl_context_u(joint))
                if intra.cfl_sign_v(joint) != 0:
                    self.sink.symbol(idx & 15, c.CFL_ALPHABET_SIZE,
                                     "cfl_alpha_cdf",
                                     intra.cfl_context_v(joint))
            uv_base = uv_mode if uv_mode < c.UV_CFL_PRED else c.DC_PRED
            if use_angle_delta and intra.is_directional(uv_base):
                self.sink.symbol(MAX_ANGLE_DELTA, 2 * MAX_ANGLE_DELTA + 1,
                                 "angle_delta_cdf", uv_mode - c.V_PRED)

        # palette mode info (bitstream.c:766 write_palette_mode_info) +
        # color map tokens (read back by decoder._visit_palette)
        pal_y = bplan.get("pal_y")
        if self.screen and self._allow_palette_enc(bsize):
            if y_mode == c.DC_PRED:
                bsize_ctx = PAL.palette_bsize_ctx(bsize)
                mctx = (int(self.pal_size_y[mi_row - 1, mi_col] > 0)
                        if up_avail else 0) + \
                       (int(self.pal_size_y[mi_row, mi_col - 1] > 0)
                        if left_avail else 0)
                self.sink.symbol(int(pal_y is not None), 2,
                                 "palette_y_mode_cdf", bsize_ctx, mctx)
                if pal_y is not None:
                    n = len(pal_y["colors"])
                    self.sink.symbol(n - 2, c.PALETTE_SIZES,
                                     "palette_y_size_cdf", bsize_ctx)
                    PAL.write_palette_colors_y(
                        self.sink, pal_y["colors"], self.bd,
                        self._pal_cache(mi_row, mi_col))
            if bplan["is_chroma_ref"] and uv_mode == c.DC_PRED:
                self.sink.symbol(0, 2, "palette_uv_mode_cdf",
                                 int(pal_y is not None))
        # filter intra (decoder._filter_intra_allowed mirror; read
        # between palette mode info and the color map tokens)
        fim = bplan.get("fim", -1)
        if (self.sh.enable_filter_intra and y_mode == c.DC_PRED
                and pal_y is None
                and blockd.block_wide(bsize) <= 32
                and blockd.block_high(bsize) <= 32):
            self.sink.symbol(int(fim >= 0), 2, "filter_intra_cdfs", bsize)
            if fim >= 0:
                self.sink.symbol(fim, c.FILTER_INTRA_MODES,
                                 "filter_intra_mode_cdf")
        if pal_y is not None:
            PAL.encode_color_map(
                self.sink, "palette_y_color_index_cdf",
                len(pal_y["colors"]), pal_y["cmap"], pal_y["rows"],
                pal_y["cols"])

        rmax = min(mi_row + bh, self.mi_rows)
        cmax = min(mi_col + bw, self.mi_cols)
        self.mi_skip[mi_row:rmax, mi_col:cmax] = int(skip)
        self.mi_mode[mi_row:rmax, mi_col:cmax] = y_mode
        self.mi_bsize[mi_row:rmax, mi_col:cmax] = bsize
        if self.screen:
            self.pal_size_y[mi_row:rmax, mi_col:cmax] = \
                len(pal_y["colors"]) if pal_y is not None else 0
            if pal_y is not None:
                colors = tuple(pal_y["colors"])
                for r in range(mi_row, rmax):
                    for cc in range(mi_col, cmax):
                        self.pal_colors_y[(r, cc)] = colors

        # block tx size (decoder _read_block_tx_size mirror: intra under
        # TX_MODE_SELECT codes a uniform depth symbol, skip included)
        if self.tx_select:
            tx_size = next(t["tx_size"] for t in txbs if t["plane"] == 0)
            if bsize > c.BLOCK_4X4:
                from ..decoder.inter import (_MAX_DEPTH, _TX_SIZE_CAT,
                                             SUB_TX_SIZE_MAP)
                depth = 0
                t_ = blockd.max_tx_size_rect(bsize)
                while t_ != tx_size:
                    t_ = SUB_TX_SIZE_MAP[t_]
                    depth += 1
                    assert depth <= _MAX_DEPTH[bsize], (bsize, tx_size)
                ctx = self._tx_size_ctx_enc(mi_row, mi_col, bsize)
                self.sink.symbol(depth, _MAX_DEPTH[bsize] + 1,
                                 "tx_size_cdf", _TX_SIZE_CAT[bsize], ctx)
            # _set_txfm_ctxs mirror (intra skip keeps real tx dims)
            self.above_txfm[mi_col:mi_col + bw] = c.TX_WIDTH[tx_size]
            self.left_txfm[mi_row:mi_row + bh] = c.TX_HEIGHT[tx_size]
            self.txw4_grid[mi_row:rmax, mi_col:cmax] = \
                c.TX_WIDTH[tx_size] >> 2
            self.txh4_grid[mi_row:rmax, mi_col:cmax] = \
                c.TX_HEIGHT[tx_size] >> 2

        for t in txbs:
            plane = t["plane"]
            au = self.above_entropy[plane]
            lu = self.left_entropy[plane]
            acol, lrow = t["acol"], t["lrow"]
            txw = c.TX_WIDTH[t["tx_size"]] >> 2
            txh = c.TX_HEIGHT[t["tx_size"]] >> 2
            if skip:
                au[acol:acol + txw] = 0
                lu[lrow:lrow + txh] = 0
                continue
            skip_ctx2, dc_sign_ctx = CF.txb_ctx(
                t["plane_bsize"], t["tx_size"], plane, au[acol:acol + txw],
                lu[lrow:lrow + txh])
            cul = self.sink.txb(t["qcoeff"], plane, skip_ctx2, dc_sign_ctx,
                                tx_size=t["tx_size"], tx_type=t["tx_type"],
                                tx_type_sym=t["tx_type_sym"])
            CF.set_entropy_spans(
                au, lu, acol, lrow, txw, txh, cul,
                t.get("vis_w4", txw), t.get("vis_h4", txh),
                t.get("loc_c4", 0), t.get("loc_r4", 0),
                t.get("cross_r", False), t.get("cross_b", False))

    def _tx_size_ctx_enc(self, mi_row, mi_col, bsize):
        """get_tx_size_context mirror (decoder/inter.py _tx_size_ctx).
        Key-frame-only simplification: no inter neighbours, so the
        above/left txfm spans alone decide."""
        max_tx = blockd.max_tx_size_rect(bsize)
        up = mi_row > 0
        left = mi_col > 0
        above = int(self.above_txfm[mi_col]) >= c.TX_WIDTH[max_tx]
        lft = int(self.left_txfm[mi_row]) >= c.TX_HEIGHT[max_tx]
        if up and left:
            return int(above) + int(lft)
        if up:
            return int(above)
        if left:
            return int(lft)
        return 0

    # predictor identical to before, kept for reuse
    def _predict(self, plane, mode, mi_row, mi_col, bsize, tx_size,
                 row_off, col_off, up_avail, left_avail, angle_delta=0,
                 fim=-1):
        ss_x = self.ss_x if plane else 0
        ss_y = self.ss_y if plane else 0
        plane_bsize = blockd.plane_block_size(bsize, ss_x, ss_y) \
            if plane else bsize
        txwpx = c.TX_WIDTH[tx_size]
        txhpx = c.TX_HEIGHT[tx_size]
        row0 = ((mi_row - (mi_row & ss_y)) * 4) >> ss_y if plane \
            else mi_row * 4
        col0 = ((mi_col - (mi_col & ss_x)) * 4) >> ss_x if plane \
            else mi_col * 4
        x = col_off * 4
        y = row_off * 4
        px, py = col0 + x, row0 + y
        bw_mi = blockd.mi_size_wide(bsize)
        bh_mi = blockd.mi_size_high(bsize)
        wpx = blockd.block_wide(plane_bsize)
        hpx = blockd.block_high(plane_bsize)
        mb_to_right = (self.mi_cols - bw_mi - mi_col) * 4
        mb_to_bottom = (self.mi_rows - bh_mi - mi_row) * 4
        xr = (mb_to_right >> ss_x) + wpx - x - txwpx
        yd = (mb_to_bottom >> ss_y) + hpx - y - txhpx
        have_top = row_off > 0 or up_avail
        have_left = col_off > 0 or left_avail
        txw = txwpx >> 2
        txh = txhpx >> 2
        right_avail = mi_col + ((col_off + txw) << ss_x) < self.mi_cols
        bottom_avail = (yd > 0) and \
            (mi_row + ((row_off + txh) << ss_y) < self.mi_rows)
        is_dr = intra.is_directional(mode)
        p_angle = (intra.MODE_TO_ANGLE.get(mode, 0)
                   + angle_delta * intra.ANGLE_STEP) if is_dr else 0
        need_tr = is_dr and p_angle < 90
        need_bl = is_dr and p_angle > 180
        cbsize = bsize
        have_tr = blockd.has_top_right(
            self.sh.sb_size_log2, cbsize, mi_row, mi_col, have_top,
            right_avail, c.PARTITION_NONE, tx_size, row_off, col_off,
            ss_x, ss_y) if need_tr else -1
        have_bl = blockd.has_bottom_left(
            self.sh.sb_size_log2, cbsize, mi_row, mi_col, bottom_avail,
            have_left, c.PARTITION_NONE, tx_size, row_off, col_off,
            ss_x, ss_y) if need_bl else -1
        return intra.build_intra_predictor(
            self.recon[plane], px, py, txwpx, txhpx, mode, angle_delta,
            fim,
            n_top_px=min(txwpx, xr + txwpx) if have_top else 0,
            n_topright_px=(min(txwpx, xr) if have_tr > 0 else have_tr),
            n_left_px=min(txhpx, yd + txhpx) if have_left else 0,
            n_bottomleft_px=(min(txhpx, yd) if have_bl > 0 else have_bl),
            disable_edge_filter=not self.sh.enable_intra_edge_filter,
            intra_edge_filter_type=0, bd=self.bd)


def encode_lossy_ivf(path: str, frames, width: int, height: int,
                     qindex: int = 60, fps=(30, 1),
                     block_size: int = c.BLOCK_16X16,
                     enable_cdef: int = 0, enable_restoration: int = 0,
                     bit_depth: int = 8, screen: bool = False,
                     qm=None, aq: bool = False, grain: bool = False,
                     intrabc: bool = False, subsampling: str = "420",
                     sb128: bool = False, seg=None,
                     tx_select=None, filter_intra: bool = False,
                     seq_tools=None, lf_sharpness: int = 0,
                     **kw) -> None:
    from ..bitstream.ivf import write_ivf
    if tx_select is None:
        # TX_MODE_SELECT is a clear RD win (intra vartx syntax is only
        # unimplemented for intrabc blocks)
        tx_select = not intrabc
    if kw.get("tune") in ("butteraugli", "vmaf") and seg is None:
        # perceptual tunes ride per-SB delta-q (tune_vmaf.c qindex route)
        aq = True
    sh = make_sequence_header(width, height, enable_cdef=enable_cdef,
                              enable_restoration=enable_restoration,
                              bit_depth=bit_depth, screen=screen,
                              film_grain=grain, subsampling=subsampling,
                              sb128=sb128, filter_intra=filter_intra,
                              **(seq_tools or {}))
    grain_params = None
    if grain:
        from ..dsp.noise_model import fit_grain_params
        grain_params = fit_grain_params(np.asarray(frames[0][0]),
                                        bit_depth=bit_depth)
    payloads = []
    for i, f in enumerate(frames):
        fh = make_lossy_frame_header(sh, qindex, screen=screen, qm=qm,
                                     aq=aq, intrabc=intrabc, seg=seg,
                                     tx_select=tx_select)
        # AOME_SET_SHARPNESS: loop-filter sharpness_level header field
        fh.sharpness_level = lf_sharpness
        if grain_params is not None:
            from dataclasses import replace
            fh.film_grain = replace(
                grain_params,
                random_seed=(grain_params.random_seed
                             + 3248 * i) & 0xFFFF)
        enc = LossyAllIntraEncoder(sh, fh, block_size=block_size, **kw)
        payloads.append((enc.encode_frame(f), i))
    write_ivf(path, payloads, width, height, fps[0], fps[1])


def encode_superres_ivf(path: str, frames, width: int, height: int,
                        qindex: int = 60, denom: int = 12, fps=(30, 1),
                        enable_cdef: int = 0, **kw) -> None:
    """Superres all-intra encode: code each frame at width*8/denom and
    signal the normative horizontal upscale (av1_superres_post_encode,
    superres_scale.c:399; scale decision analog of av1_superres_scale).

    Deblock + CDEF run at the coded size (decoder order: filters ->
    upscale -> LR); loop restoration is post-upscale and not wired on
    the encode side, so it stays off here."""
    from ..bitstream.ivf import write_ivf
    from ..common.resize import downscale_plane_horz, downscaled_size
    assert H.SUPERRES_DENOM_MIN <= denom \
        <= H.SUPERRES_DENOM_MIN + (1 << H.SUPERRES_DENOM_BITS) - 1
    sh = make_sequence_header(width, height, enable_cdef=enable_cdef,
                              superres=True)
    coded_w = downscaled_size(width, denom)
    ss_x = sh.subsampling_x
    payloads = []
    for i, f in enumerate(frames):
        fh = make_lossy_frame_header(sh, qindex)
        fh.superres_denom = denom
        fh.upscaled_width = width
        fh.frame_width = coded_w
        fh.render_width = width
        enc = LossyAllIntraEncoder(sh, fh, **kw)
        down = tuple(
            downscale_plane_horz(np.asarray(p),
                                 (coded_w + (ss_x if pi else 0))
                                 >> (ss_x if pi else 0))
            for pi, p in enumerate(f))
        payloads.append((enc.encode_frame(down), i))
    write_ivf(path, payloads, width, height, fps[0], fps[1])
