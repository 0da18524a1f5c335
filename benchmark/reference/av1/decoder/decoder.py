"""AV1 intra-frame decoder — bit-exact host reference.

Decodes key/intra-only frames (8-bit, 4:2:0 or monochrome) produced by this
framework's encoder or by stock aomenc.  Serves as the conformance anchor:
encoder recon must equal this decoder's output, and this decoder must decode
reference streams losslessly (tests/test_decode_oracle.py).

Normative behavior per AV1 spec §5.11/§7.11 (reference call stack:
av1/decoder/decodeframe.c:2718 decode_tiles → :1244 decode_partition,
decodemv.c:772 read_intra_frame_mode_info, decodetxb.c:110).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..bitstream import constants as c
from ..bitstream import headers as H
from ..bitstream.entropy import RangeDecoder
from ..bitstream.tables import FrameContext
from ..common import blockd, intra
from ..common.txfm import iwht4x4
from ..common import coeffs as CF
from ..common import mvref as MR
from .inter import InterDecoderMixin

PARTITION_PLOFFSET = 4
class CorruptFrameError(Exception):
    """AOM_CODEC_CORRUPT_FRAME analog: the bitstream violates the spec
    or ends early.  Raised by decode entry points instead of leaking
    low-level assertion/index failures (aom_internal_error semantics,
    reference test/invalid_file_test.cc contract)."""


# filter-intra mode -> equivalent directional mode (entropymode.c)
FIMODE_TO_INTRADIR = [c.DC_PRED, c.V_PRED, c.H_PRED, c.D157_PRED, c.DC_PRED]
INTRA_MODE_CONTEXT = [0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0]
MAX_ANGLE_DELTA = 3

# test-visible counter (conformance tests reset this to prove a stream
# actually exercised intraBC blocks)
INTRABC_STATS = {"blocks": 0}


@dataclass
class BlockInfo:
    bsize: int = c.BLOCK_4X4
    y_mode: int = c.DC_PRED
    uv_mode: int = c.DC_PRED
    angle_delta_y: int = 0
    angle_delta_uv: int = 0
    skip_txfm: int = 0
    filter_intra_mode: int = -1
    cdef_strength: int = -1
    cfl_alpha_idx: int = 0
    cfl_joint_sign: int = 0
    partition: int = c.PARTITION_NONE
    mi_row: int = 0
    mi_col: int = 0
    # inter
    is_inter: int = 0
    skip_mode: int = 0
    mode: int = 0
    ref_frame: tuple = (c.INTRA_FRAME, -1)
    mv: tuple = ((0, 0), (0, 0))
    ref_mv_idx: int = 0
    interp_filter: tuple = (c.EIGHTTAP_REGULAR, c.EIGHTTAP_REGULAR)
    tx_size: int = -1
    inter_leaves: object = None
    segment_id: int = 0
    seg_id_predicted: int = 0
    qindex: int = 0
    interintra: int = 0
    interintra_mode: int = 0
    # palette (screen content)
    palette_size: tuple = (0, 0)
    palette_colors: object = None   # [y[], u[], v[]] base colors
    color_maps: object = None       # {0: luma map, 1: chroma map}
    is_intrabc: int = 0
    use_wedge_interintra: int = 0
    interintra_wedge_index: int = 0


class TileState:
    """Per-tile decode state: contexts + recon."""

    def __init__(self, dec: "FrameDecoder", tile_row: int, tile_col: int):
        self.dec = dec
        fh, sh = dec.fh, dec.sh
        self.mi_row_start, self.mi_row_end = dec.tile_row_range(tile_row)
        self.mi_col_start, self.mi_col_end = dec.tile_col_range(tile_col)
        mi_cols = dec.mi_cols
        mi_rows = dec.mi_rows
        # above contexts span the tile width; left contexts the full height
        # (reset per SB row to mimic the per-SB-row left arrays)
        self.above_partition = np.zeros(mi_cols + 32, dtype=np.uint8)
        self.left_partition = np.zeros(mi_rows + 32, dtype=np.uint8)
        nplanes = 1 if sh.mono_chrome else 3
        # +32 margin: edge-crossing transform blocks touch ctx past the grid
        self.above_entropy = [np.zeros(mi_cols + 32, dtype=np.uint8)
                              for _ in range(nplanes)]
        self.left_entropy = [np.zeros(mi_rows + 32, dtype=np.uint8)
                             for _ in range(nplanes)]
        # transform-size context (tx dims in pixels; av1_common_int.h
        # set_txfm_ctxs); left reset per SB row like the other left arrays
        self.above_txfm = np.full(mi_cols + 32, 64, dtype=np.uint8)
        self.left_txfm = np.full(mi_rows + 32, 64, dtype=np.uint8)
        self.fc = dec.fc0.copy()


class FrameDecoder(InterDecoderMixin):
    def __init__(self, sh: H.SequenceHeader, fh: H.FrameHeader,
                 refs=None):
        self.sh = sh
        self.fh = fh
        assert sh.bit_depth in (8, 10, 12), sh.bit_depth
        self.bd = sh.bit_depth
        self.mi_cols = fh.mi_cols()
        self.mi_rows = fh.mi_rows()
        self.sb_log2 = sh.sb_size_log2
        self.sb_mi = 1 << (self.sb_log2 - 2)
        self.sb_size = c.BLOCK_128X128 if sh.use_128x128_superblock \
            else c.BLOCK_64X64
        self.num_planes = 1 if sh.mono_chrome else 3
        self.ss_x = sh.subsampling_x
        self.ss_y = sh.subsampling_y
        self.lossless = fh.coded_lossless(sh)
        # superres: coded at fh.frame_width, output at upscaled_width
        self.superres = (fh.superres_denom != H.SUPERRES_NUM)
        self.upscaled_width = fh.upscaled_width or fh.frame_width
        self._cdef_tx = [False] * 4
        #: optional symbol accounting sink (inspect.py): category -> 1/8
        #: bit units (accounting.c analog)
        self.acct = None
        # loop restoration (decode_restoration_mode, decodeframe.c:1494)
        self.lr = None
        if any(fh.lr_type[:self.num_planes]):
            from ..common import restoration as LR
            ysize = 64 << fh.lr_unit_shift
            ss = min(self.ss_x, self.ss_y) if self.num_planes > 1 else 0
            uvsize = ysize >> (fh.lr_uv_shift * ss)
            sizes = (ysize, uvsize, uvsize)
            self.lr = []
            for p in range(self.num_planes):
                ss_x = self.ss_x if p else 0
                ss_y = self.ss_y if p else 0
                # LR geometry spans the upscaled frame (restoration.c:
                # av1_whole_frame_rect uses superres_upscaled_width)
                pw = (self.upscaled_width + ss_x) >> ss_x
                ph = (fh.frame_height + ss_y) >> ss_y
                self.lr.append(LR.PlaneRestoration(
                    fh.lr_type[p], sizes[p], pw, ph))
            self.lr_bounds = [{"above": {}, "below": {}}
                              for _ in range(self.num_planes)]
            do_cdef = (not self.lossless and not fh.allow_intrabc
                       and (fh.cdef_bits
                            or (fh.cdef_y_pri and (fh.cdef_y_pri[0]
                                                   or fh.cdef_y_sec[0]))
                            or (fh.cdef_uv_pri and (fh.cdef_uv_pri[0]
                                                    or fh.cdef_uv_sec[0]))))
            self.lr_optimized = not do_cdef and not self.superres
        w = self.mi_cols * 4
        h = self.mi_rows * 4
        # +64 margin: large-tx blocks at the frame edge may write recon
        # beyond the mi grid (never read back for visible predictions)
        pix = np.uint8 if self.bd == 8 else np.uint16
        self.planes = [np.zeros((h + 64, w + 64), dtype=pix)]
        if self.num_planes > 1:
            cw, ch = w >> self.ss_x, h >> self.ss_y
            self.planes += [np.zeros((ch + 64, cw + 64), dtype=pix)
                            for _ in range(2)]
        # mode info grid: one BlockInfo ref per 4x4 unit
        self.mi = np.empty((self.mi_rows, self.mi_cols), dtype=object)
        # numeric mi grids for MV prediction / inter contexts
        self.g = MR.MiGrids(self.mi_rows, self.mi_cols)
        self.skip_mode_grid = np.zeros(
            (self.mi_rows + 64, self.mi_cols + 64), np.uint8)
        self.interp_grid = np.zeros(
            (self.mi_rows + 64, self.mi_cols + 64, 2), np.uint8)
        # luma tx types per mi (chroma inter txbs read the co-located cell;
        # blockd.h:1278 av1_get_tx_type)
        self.tx_type_map = np.zeros(
            (self.mi_rows + 64, self.mi_cols + 64), np.uint8)
        # luma tx dims per mi (for the loop filter with variable tx)
        self.tx_wide_grid = np.zeros((self.mi_rows, self.mi_cols), np.uint8)
        self.tx_high_grid = np.zeros((self.mi_rows, self.mi_cols), np.uint8)
        self.skip_inter_grid = np.zeros((self.mi_rows, self.mi_cols),
                                        np.uint8)
        # reference frames: refs[LAST..ALTREF] = (planes tuple, order_hint)
        self.refs = [None] * 8
        self.sign_bias = [0] * 8
        self.ref_hints = [0] * 8
        self.ref_side = [0] * 8
        self.ref_slot_bufs = [None] * 8
        self.tmvp = None
        # global motion per ref frame index (LAST..ALTREF at 1..7):
        # (wmtype, wmmat list, invalid, shear or None)
        self.gm = [(c.IDENTITY, [0, 0, 65536, 0, 0, 65536], 0, None)]
        for wmtype, mat, invalid in fh.gm_params:
            shear = None
            if wmtype > c.TRANSLATION and not invalid:
                from ..common import warp as WP
                ok, a, b, gmm, d = WP.get_shear_params(list(mat))
                shear = (a, b, gmm, d) if ok else None
                if not ok:
                    invalid = 1
            self.gm.append((wmtype, list(mat), invalid, shear))
        # per-8x8 motion storage for future frames (av1_copy_frame_mvs)
        h2 = (self.mi_rows + 1) >> 1
        w2 = (self.mi_cols + 1) >> 1
        self.frame_mvs_ref = np.full((h2, w2), -1, np.int8)
        self.frame_mvs = np.zeros((h2, w2, 2), np.int16)
        self._ref_pad_cache = {}
        self._last_tx_type = c.DCT_DCT
        # segmentation (setup_segmentation, decodeframe.c:1419)
        self.seg_map = np.zeros((self.mi_rows, self.mi_cols), np.uint8)
        self.seg_pred_grid = np.zeros((self.mi_rows, self.mi_cols),
                                      np.uint8)
        self.prev_seg_map = None
        if (fh.segmentation_enabled and refs is not None
                and fh.primary_ref_frame != H.PRIMARY_REF_NONE
                and not fh.is_intra):
            slot = fh.ref_frame_idx[fh.primary_ref_frame]
            buf = refs[slot]
            if (buf is not None and buf.get("seg_map") is not None
                    and buf["seg_map"].shape == self.seg_map.shape):
                self.prev_seg_map = buf["seg_map"]
        if not fh.is_intra:
            assert refs is not None, "inter frame needs reference frames"
            for i in range(7):
                slot = fh.ref_frame_idx[i]
                buf = refs[slot]
                assert buf is not None, "missing reference frame"
                self.refs[c.LAST_FRAME + i] = buf["planes"]
                self.ref_slot_bufs[c.LAST_FRAME + i] = buf
                self.ref_hints[c.LAST_FRAME + i] = buf["order_hint"]
                d = H.get_relative_dist(sh, buf["order_hint"],
                                        fh.order_hint)
                self.sign_bias[c.LAST_FRAME + i] = int(d > 0)
                if d > 0:
                    self.ref_side[c.LAST_FRAME + i] = 1
                elif buf["order_hint"] == fh.order_hint:
                    self.ref_side[c.LAST_FRAME + i] = -1
            if fh.allow_ref_frame_mvs:
                self._setup_motion_field()
        # initial CDF state: primary ref's stored context or defaults
        # (decodeframe.c:5007 av1_setup_past_independence)
        if fh.primary_ref_frame != H.PRIMARY_REF_NONE and refs is not None:
            slot = fh.ref_frame_idx[fh.primary_ref_frame]
            assert refs[slot] is not None and refs[slot]["fc"] is not None, \
                "primary ref frame context unavailable"
            self.fc0 = refs[slot]["fc"].copy()
        else:
            self.fc0 = FrameContext(fh.base_q_idx)
        # CfL luma buffer (Q3), covers up to 32x32 chroma
        self.cfl_buf = np.zeros((32, 32), dtype=np.int32)
        self.cfl_buf_w = 0
        self.cfl_buf_h = 0
        # dequant values (per-block qindex with delta-q)
        from ..bitstream import tables
        self._dcq = tables.get("dc_quant_qtx")
        self._acq = tables.get("ac_quant_qtx")
        self._dqv_cache = {}
        self.dqv = [self._dqv(p, fh.base_q_idx)
                    for p in range(self.num_planes)]
        self.cur_qindex = fh.base_q_idx
        self.delta_lf = [0, 0, 0, 0]
        self.delta_lf_grid = np.zeros((self.mi_rows, self.mi_cols, 4),
                                      np.int8)
        self.qindex_grid = np.full((self.mi_rows, self.mi_cols),
                                   fh.base_q_idx, np.int32)

    def _dqv(self, plane, qindex):
        key = (plane, qindex)
        v = self._dqv_cache.get(key)
        if v is None:
            fh = self.fh
            dcd, acd = ((fh.delta_q_y_dc, 0),
                        (fh.delta_q_u_dc, fh.delta_q_u_ac),
                        (fh.delta_q_v_dc, fh.delta_q_v_ac))[plane]

            row = {8: 0, 10: 1, 12: 2}[self.bd]

            def q(tbl, qidx):
                return int(tbl[row][max(0, min(255, qidx))])
            v = (q(self._dcq, qindex + dcd), q(self._acq, qindex + acd))
            self._dqv_cache[key] = v
        return v

    def _setup_motion_field(self):
        """av1_setup_motion_field (mvref_common.c:1006) — delegates to
        the shared encoder/decoder projection (common/mvref.py)."""
        from ..common import mvref as MRR
        self.tmvp = MRR.setup_motion_field(
            self.sh, self.fh, self.mi_rows, self.mi_cols,
            self.ref_slot_bufs, self.ref_hints,
            lambda a, b: H.get_relative_dist(self.sh, a, b))
        self.tpl_mfmv = self.tmvp["mfmv"]
        self.tpl_valid = self.tmvp["valid"]
        self.tpl_offset = self.tmvp["offset"]

    def _copy_frame_mvs(self, bi, mi_row, mi_col, x_mis, y_mis):
        """av1_copy_frame_mvs (mvref_common.c:40)."""
        r0 = mi_row >> 1
        c0 = mi_col >> 1
        x2 = (x_mis + 1) >> 1
        y2 = (y_mis + 1) >> 1
        ref = -1
        mv = (0, 0)
        for idx in range(2):
            rf = bi.ref_frame[idx]
            if rf > c.INTRA_FRAME:
                if self.ref_side[rf]:
                    continue
                if abs(bi.mv[idx][0]) > 4095 or abs(bi.mv[idx][1]) > 4095:
                    continue
                ref = rf
                mv = bi.mv[idx]
        self.frame_mvs_ref[r0:r0 + y2, c0:c0 + x2] = ref
        self.frame_mvs[r0:r0 + y2, c0:c0 + x2, 0] = mv[0]
        self.frame_mvs[r0:r0 + y2, c0:c0 + x2, 1] = mv[1]

    def _read_delta_q_params(self, ts, rd, bi, mi_row, mi_col):
        """read_delta_q_params (decodemv.c:84): per-superblock delta-q and
        delta-lf, applied as running state across the tile."""
        fh = self.fh
        if not fh.delta_q_present:
            bi.qindex = self.seg_qindex(bi.segment_id, fh.base_q_idx)
            return
        sbm = self.sb_mi
        first = (mi_row & (sbm - 1)) == 0 and (mi_col & (sbm - 1)) == 0
        readable = (bi.bsize != self.sb_size or bi.skip_txfm == 0) and first

        def read_delta(cdf):
            if not readable:
                return 0
            absv = rd.decode_symbol_adapt(cdf, 4)
            if absv == 3:
                rem = rd.decode_literal(3) + 1
                thr = (1 << rem) + 1
                absv = rd.decode_literal(rem) + thr
            sign = rd.decode_bit() if absv else 1
            return -absv if sign else absv

        d = read_delta(ts.fc.delta_q_cdf)
        self.cur_qindex = max(1, min(255, self.cur_qindex
                                     + d * (1 << fh.delta_q_res_log2)))
        bi.qindex = self.seg_qindex(bi.segment_id, self.cur_qindex)
        if fh.delta_lf_present:
            n = 4 if (self.num_planes > 1 and fh.delta_lf_multi) else 1
            if fh.delta_lf_multi:
                for lf_id in range(n):
                    dl = read_delta(ts.fc.delta_lf_multi_cdf[lf_id])
                    self.delta_lf[lf_id] = max(-63, min(63,
                        self.delta_lf[lf_id]
                        + dl * (1 << fh.delta_lf_res_log2)))
            else:
                dl = read_delta(ts.fc.delta_lf_cdf)
                v = max(-63, min(63, self.delta_lf[0]
                                 + dl * (1 << fh.delta_lf_res_log2)))
                self.delta_lf = [v, v, v, v]

    # --- tiles ------------------------------------------------------------

    def tile_row_range(self, tr: int):
        """Uniform tile spacing (tile_info, spec 5.9.15): ceil-sized
        tiles of size_sb = ceil(sb_rows / n)."""
        log2 = self.fh.tile_rows_log2
        sbs = self.fh.sb_rows(self.sh)
        size_sb = (sbs + (1 << log2) - 1) >> log2
        start = min(tr * size_sb, sbs)
        end = min((tr + 1) * size_sb, sbs)
        return start * self.sb_mi, min(end * self.sb_mi, self.mi_rows)

    def tile_col_range(self, tc: int):
        log2 = self.fh.tile_cols_log2
        sbs = self.fh.sb_cols(self.sh)
        size_sb = (sbs + (1 << log2) - 1) >> log2
        start = min(tc * size_sb, sbs)
        end = min((tc + 1) * size_sb, sbs)
        return start * self.sb_mi, min(end * self.sb_mi, self.mi_cols)

    def decode_tile_data(self, data: bytes, tile_row: int, tile_col: int):
        ts = TileState(self, tile_row, tile_col)
        rd = RangeDecoder(data)
        rd.allow_update_cdf = not self.fh.disable_cdf_update
        self._last_ts = ts
        self.cur_qindex = self.fh.base_q_idx
        self.delta_lf = [0, 0, 0, 0]
        if self.lr is not None:
            # av1_reset_loop_restoration: per-tile coeff prediction refs
            from ..common import restoration as LR
            self.lr_wiener_ref = [{"v": LR.default_wiener(),
                                   "h": LR.default_wiener()}
                                  for _ in range(self.num_planes)]
            self.lr_sgr_ref = [LR.default_sgrproj()
                               for _ in range(self.num_planes)]
        for mi_row in range(ts.mi_row_start, ts.mi_row_end, self.sb_mi):
            ts.left_partition[:] = 0
            for le in ts.left_entropy:
                le[:] = 0
            ts.left_txfm[:] = 64
            for mi_col in range(ts.mi_col_start, ts.mi_col_end, self.sb_mi):
                self._decode_partition(ts, rd, mi_row, mi_col, self.sb_size)
        # aom_reader_has_error: consuming more bits than the tile holds
        # means the stream was truncated/corrupt (od_ec zero-fills)
        if rd.tell() > len(data) * 8:
            raise CorruptFrameError(
                f"tile over-read: {rd.tell()} bits from "
                f"{len(data) * 8}-bit tile")

    # --- loop restoration symbols ----------------------------------------

    def _rd_quniform(self, rd, n):
        """aom_read_primitive_quniform (binary_codes_reader.c:15)."""
        if n <= 1:
            return 0
        lb = n.bit_length()
        m = (1 << lb) - n
        v = rd.decode_literal(lb - 1)
        return v if v < m else (v << 1) - m + rd.decode_literal(1)

    def _rd_subexpfin(self, rd, n, k):
        i = 0
        mk = 0
        while True:
            b = k + i - 1 if i else k
            a = 1 << b
            if n <= mk + 3 * a:
                return self._rd_quniform(rd, n - mk) + mk
            if not rd.decode_literal(1):
                return rd.decode_literal(b) + mk
            i += 1
            mk += a

    def _rd_refsubexpfin(self, rd, n, k, ref):
        v = self._rd_subexpfin(rd, n, k)
        # inv_recenter_finite_nonneg (recenter.h:31)
        def inv_nonneg(r0, vv):
            if vv > 2 * r0:
                return vv
            if vv & 1:
                return r0 - ((vv + 1) >> 1)
            return (vv >> 1) + r0
        if 2 * ref <= n:
            return inv_nonneg(ref, v)
        return n - 1 - inv_nonneg(n - 1 - ref, v)

    def _read_lr_units(self, ts, rd, mi_row, mi_col):
        """loop_restoration_read_sb_coeffs via
        av1_loop_restoration_corners_in_sb (restoration.c:1316)."""
        from ..common import restoration as LR
        for plane in range(self.num_planes):
            pr = self.lr[plane]
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
                    idx = rrow * pr.hunits + rcol
                    pr.unit_info[idx] = self._read_lr_unit(
                        ts, rd, plane, pr.frame_rtype)

    def _read_lr_unit(self, ts, rd, plane, frame_rtype):
        from ..common import restoration as LR
        fc = ts.fc
        if frame_rtype == LR.RESTORE_SWITCHABLE:
            rtype = rd.decode_symbol_adapt(
                fc.switchable_restore_cdf, LR.RESTORE_SWITCHABLE_TYPES)
            if rtype == LR.RESTORE_WIENER:
                return (rtype, self._read_wiener(rd, plane))
            if rtype == LR.RESTORE_SGRPROJ:
                return (rtype, self._read_sgrproj(rd, plane))
            return (LR.RESTORE_NONE, None)
        if frame_rtype == LR.RESTORE_WIENER:
            if rd.decode_symbol_adapt(fc.wiener_restore_cdf, 2):
                return (LR.RESTORE_WIENER, self._read_wiener(rd, plane))
            return (LR.RESTORE_NONE, None)
        # RESTORE_SGRPROJ
        if rd.decode_symbol_adapt(fc.sgrproj_restore_cdf, 2):
            return (LR.RESTORE_SGRPROJ, self._read_sgrproj(rd, plane))
        return (LR.RESTORE_NONE, None)

    def _read_wiener(self, rd, plane):
        """read_wiener_filter (decodeframe.c:1551)."""
        from ..common import restoration as LR
        win = LR.WIENER_WIN if plane == 0 else LR.WIENER_WIN - 2
        ref = self.lr_wiener_ref[plane]
        out = {}
        for key in ("v", "h"):
            filt = [0] * 8
            reff = ref[key]
            for tap in range(3):
                if tap == 0 and win != LR.WIENER_WIN:
                    continue
                mn = LR.WIENER_TAP_MIN[tap]
                mx = LR.WIENER_TAP_MAX[tap]
                k = LR.WIENER_TAP_K[tap]
                filt[tap] = self._rd_refsubexpfin(
                    rd, mx - mn + 1, k, reff[tap] - mn) + mn
                filt[6 - tap] = filt[tap]
            filt[3] = -2 * (filt[0] + filt[1] + filt[2])
            out[key] = filt
        self.lr_wiener_ref[plane] = {"v": list(out["v"]),
                                     "h": list(out["h"])}
        return (out["h"], out["v"])

    def _read_sgrproj(self, rd, plane):
        """read_sgrproj_filter (decodeframe.c:1612)."""
        from ..common import restoration as LR
        ep = rd.decode_literal(LR.SGRPROJ_PARAMS_BITS)
        r0, r1, _, _ = LR.SGR_PARAMS[ep]
        ref = self.lr_sgr_ref[plane]
        xqd = [0, 0]
        if r0 == 0:
            xqd[0] = 0
            xqd[1] = self._rd_refsubexpfin(
                rd, LR.SGRPROJ_PRJ_MAX1 - LR.SGRPROJ_PRJ_MIN1 + 1,
                LR.SGRPROJ_PRJ_SUBEXP_K,
                ref[1] - LR.SGRPROJ_PRJ_MIN1) + LR.SGRPROJ_PRJ_MIN1
        elif r1 == 0:
            xqd[0] = self._rd_refsubexpfin(
                rd, LR.SGRPROJ_PRJ_MAX0 - LR.SGRPROJ_PRJ_MIN0 + 1,
                LR.SGRPROJ_PRJ_SUBEXP_K,
                ref[0] - LR.SGRPROJ_PRJ_MIN0) + LR.SGRPROJ_PRJ_MIN0
            xqd[1] = max(LR.SGRPROJ_PRJ_MIN1,
                         min(LR.SGRPROJ_PRJ_MAX1,
                             (1 << LR.SGRPROJ_PRJ_BITS) - xqd[0]))
        else:
            xqd[0] = self._rd_refsubexpfin(
                rd, LR.SGRPROJ_PRJ_MAX0 - LR.SGRPROJ_PRJ_MIN0 + 1,
                LR.SGRPROJ_PRJ_SUBEXP_K,
                ref[0] - LR.SGRPROJ_PRJ_MIN0) + LR.SGRPROJ_PRJ_MIN0
            xqd[1] = self._rd_refsubexpfin(
                rd, LR.SGRPROJ_PRJ_MAX1 - LR.SGRPROJ_PRJ_MIN1 + 1,
                LR.SGRPROJ_PRJ_SUBEXP_K,
                ref[1] - LR.SGRPROJ_PRJ_MIN1) + LR.SGRPROJ_PRJ_MIN1
        self.lr_sgr_ref[plane] = list(xqd)
        return (ep, xqd)

    def save_lr_boundaries(self, after_cdef):
        """av1_loop_restoration_save_boundary_lines; no-op when LR is off
        or the optimized (no-cdef) path is in use.  Pre-CDEF (deblock)
        lines from a superres frame are upscaled at save time
        (restoration.c save_deblock_boundary_lines)."""
        if self.lr is None or self.lr_optimized:
            return
        from ..common import restoration as LR
        for plane in range(self.num_planes):
            ss_x = self.ss_x if plane else 0
            ss_y = self.ss_y if plane else 0
            pw = (self.fh.frame_width + ss_x) >> ss_x
            ph = (self.fh.frame_height + ss_y) >> ss_y
            up_w = None
            if self.superres and not after_cdef:
                up_w = (self.upscaled_width + ss_x) >> ss_x
                # the last tile column reads up to the mi-aligned width
                # before replicating (resize.c:1307 downscaled_x1)
                mi_w = (self.mi_cols * 4) >> ss_x
                view = self.planes[plane][:ph, :mi_w]
                LR.save_boundary_lines(view, ss_y, after_cdef,
                                       self.lr_bounds[plane],
                                       upscale_to=up_w, bd=self.bd,
                                       upscale_in_w=pw)
                continue
            view = self.planes[plane][:ph, :pw]
            LR.save_boundary_lines(view, ss_y, after_cdef,
                                   self.lr_bounds[plane], upscale_to=up_w,
                                   bd=self.bd)

    def apply_superres(self):
        """superres_post_decode (decodeframe.c:5123): normative
        horizontal upscale of every plane, after CDEF, before LR."""
        if not self.superres:
            return
        from ..common import resize as RS
        new_planes = []
        for plane in range(self.num_planes):
            ss_x = self.ss_x if plane else 0
            ss_y = self.ss_y if plane else 0
            pw = (self.fh.frame_width + ss_x) >> ss_x
            ph = (self.fh.frame_height + ss_y) >> ss_y
            out_w = (self.upscaled_width + ss_x) >> ss_x
            mi_w = (self.mi_cols * 4) >> ss_x
            up = RS.upscale_normative_rows(
                self.planes[plane][:ph, :mi_w], out_w, self.bd, in_w=pw)
            buf = np.zeros((ph + 64, out_w + 64), self.planes[plane].dtype)
            buf[:ph, :out_w] = up
            new_planes.append(buf)
        self.planes = new_planes

    def apply_loop_restoration(self):
        if self.lr is None:
            return
        from ..common import restoration as LR
        for plane in range(self.num_planes):
            pr = self.lr[plane]
            if pr.frame_rtype == LR.RESTORE_NONE:
                continue
            ss_y = self.ss_y if plane else 0
            ss_x = self.ss_x if plane else 0
            pw = (self.upscaled_width + ss_x) >> ss_x
            ph = (self.fh.frame_height + ss_y) >> ss_y
            view = self.planes[plane][:ph, :pw]
            out = LR.filter_frame_plane(view, pr, ss_y,
                                        self.lr_bounds[plane],
                                        self.lr_optimized, self.bd)
            view[:] = out

    # --- partition tree ---------------------------------------------------

    def _partition_ctx(self, ts, mi_row, mi_col, bsize):
        bsl = (blockd.mi_size_wide(bsize).bit_length() - 1) - 1
        above = (int(ts.above_partition[mi_col]) >> bsl) & 1
        left = (int(ts.left_partition[mi_row]) >> bsl) & 1
        return (left * 2 + above) + bsl * PARTITION_PLOFFSET

    @staticmethod
    def _partition_cdf_length(bsize):
        if bsize == c.BLOCK_8X8:
            return c.PARTITION_TYPES
        if bsize == c.BLOCK_128X128:
            return c.EXT_PARTITION_TYPES - 2
        return c.EXT_PARTITION_TYPES

    @staticmethod
    def _cdf_element_prob(cdf, elem):
        prev = 32768 if elem == 0 else int(cdf[elem - 1])
        return prev - int(cdf[elem])

    def _gather_split_cdf(self, cdf, bsize, horz_alike: bool):
        """Binary icdf for split-vs-rect when one dimension is out of
        bounds (av1_common_int.h:1460 partition_gather_*_alike)."""
        p = 32768
        if horz_alike:
            elems = [c.PARTITION_HORZ, c.PARTITION_SPLIT, c.PARTITION_HORZ_A,
                     c.PARTITION_HORZ_B, c.PARTITION_VERT_A]
            if bsize != c.BLOCK_128X128:
                elems.append(c.PARTITION_HORZ_4)
        else:
            elems = [c.PARTITION_VERT, c.PARTITION_SPLIT, c.PARTITION_HORZ_A,
                     c.PARTITION_VERT_A, c.PARTITION_VERT_B]
            if bsize != c.BLOCK_128X128:
                elems.append(c.PARTITION_VERT_4)
        for e in elems:
            p -= self._cdf_element_prob(cdf, e)
        return np.array([32768 - p, 0, 0], dtype=np.uint16)

    def _update_partition_ctx(self, ts, mi_row, mi_col, subsize, bsize):
        bw = blockd.mi_size_wide(bsize)
        bh = blockd.mi_size_high(bsize)
        above, left = _partition_ctx_lookup(subsize)
        ts.above_partition[mi_col:mi_col + bw] = above
        ts.left_partition[mi_row:mi_row + bh] = left

    def _update_ext_partition_ctx(self, ts, mi_row, mi_col, subsize, bsize,
                                  partition):
        if bsize < c.BLOCK_8X8:
            return
        hbs = blockd.mi_size_wide(bsize) // 2
        bsize2 = blockd.partition_subsize(bsize, c.PARTITION_SPLIT)
        P = c
        if partition == P.PARTITION_SPLIT and bsize != c.BLOCK_8X8:
            return
        if partition in (P.PARTITION_SPLIT, P.PARTITION_NONE,
                         P.PARTITION_HORZ, P.PARTITION_VERT,
                         P.PARTITION_HORZ_4, P.PARTITION_VERT_4):
            self._update_partition_ctx(ts, mi_row, mi_col, subsize, bsize)
        elif partition == P.PARTITION_HORZ_A:
            self._update_partition_ctx(ts, mi_row, mi_col, bsize2, subsize)
            self._update_partition_ctx(ts, mi_row + hbs, mi_col, subsize,
                                       subsize)
        elif partition == P.PARTITION_HORZ_B:
            self._update_partition_ctx(ts, mi_row, mi_col, subsize, subsize)
            self._update_partition_ctx(ts, mi_row + hbs, mi_col, bsize2,
                                       subsize)
        elif partition == P.PARTITION_VERT_A:
            self._update_partition_ctx(ts, mi_row, mi_col, bsize2, subsize)
            self._update_partition_ctx(ts, mi_row, mi_col + hbs, subsize,
                                       subsize)
        elif partition == P.PARTITION_VERT_B:
            self._update_partition_ctx(ts, mi_row, mi_col, subsize, subsize)
            self._update_partition_ctx(ts, mi_row, mi_col + hbs, bsize2,
                                       subsize)

    def _decode_partition(self, ts, rd, mi_row, mi_col, bsize):
        if mi_row >= self.mi_rows or mi_col >= self.mi_cols:
            return
        if bsize == self.sb_size and self.lr is not None:
            self._read_lr_units(ts, rd, mi_row, mi_col)
        bw = blockd.mi_size_wide(bsize)
        hbs = bw // 2
        qbs = bw // 4
        has_rows = mi_row + hbs < self.mi_rows
        has_cols = mi_col + hbs < self.mi_cols
        P = c
        if bsize < c.BLOCK_8X8:
            partition = P.PARTITION_NONE
        elif not has_rows and not has_cols:
            partition = P.PARTITION_SPLIT
        else:
            ctx = self._partition_ctx(ts, mi_row, mi_col, bsize)
            cdf = ts.fc.partition_cdf[ctx]
            if has_rows and has_cols:
                partition = rd.decode_symbol_adapt(
                    cdf, self._partition_cdf_length(bsize))
            elif has_cols:  # rows out of bounds: split-vs-horz
                g = self._gather_split_cdf(cdf, bsize, horz_alike=False)
                partition = (P.PARTITION_SPLIT if rd.decode_symbol(g, 2)
                             else P.PARTITION_HORZ)
            else:
                g = self._gather_split_cdf(cdf, bsize, horz_alike=True)
                partition = (P.PARTITION_SPLIT if rd.decode_symbol(g, 2)
                             else P.PARTITION_VERT)
        subsize = blockd.partition_subsize(bsize, partition)
        bsize2 = blockd.partition_subsize(bsize, P.PARTITION_SPLIT) \
            if bsize >= c.BLOCK_8X8 else bsize

        def blk(r, col, bs):
            self._decode_block(ts, rd, r, col, bs, partition)

        if partition == P.PARTITION_NONE:
            blk(mi_row, mi_col, subsize)
        elif partition == P.PARTITION_HORZ:
            blk(mi_row, mi_col, subsize)
            if has_rows:
                blk(mi_row + hbs, mi_col, subsize)
        elif partition == P.PARTITION_VERT:
            blk(mi_row, mi_col, subsize)
            if has_cols:
                blk(mi_row, mi_col + hbs, subsize)
        elif partition == P.PARTITION_SPLIT:
            self._decode_partition(ts, rd, mi_row, mi_col, subsize)
            self._decode_partition(ts, rd, mi_row, mi_col + hbs, subsize)
            self._decode_partition(ts, rd, mi_row + hbs, mi_col, subsize)
            self._decode_partition(ts, rd, mi_row + hbs, mi_col + hbs,
                                   subsize)
        elif partition == P.PARTITION_HORZ_A:
            blk(mi_row, mi_col, bsize2)
            blk(mi_row, mi_col + hbs, bsize2)
            blk(mi_row + hbs, mi_col, subsize)
        elif partition == P.PARTITION_HORZ_B:
            blk(mi_row, mi_col, subsize)
            blk(mi_row + hbs, mi_col, bsize2)
            blk(mi_row + hbs, mi_col + hbs, bsize2)
        elif partition == P.PARTITION_VERT_A:
            blk(mi_row, mi_col, bsize2)
            blk(mi_row + hbs, mi_col, bsize2)
            blk(mi_row, mi_col + hbs, subsize)
        elif partition == P.PARTITION_VERT_B:
            blk(mi_row, mi_col, subsize)
            blk(mi_row, mi_col + hbs, bsize2)
            blk(mi_row + hbs, mi_col + hbs, bsize2)
        elif partition == P.PARTITION_HORZ_4:
            for i in range(4):
                r = mi_row + i * qbs
                if i > 0 and r >= self.mi_rows:
                    break
                blk(r, mi_col, subsize)
        elif partition == P.PARTITION_VERT_4:
            for i in range(4):
                cc = mi_col + i * qbs
                if i > 0 and cc >= self.mi_cols:
                    break
                blk(mi_row, cc, subsize)
        self._update_ext_partition_ctx(ts, mi_row, mi_col, subsize, bsize,
                                       partition)

    # --- block decode -----------------------------------------------------

    def _neighbors(self, ts, mi_row, mi_col):
        up = mi_row > ts.mi_row_start
        left = mi_col > ts.mi_col_start
        above_mi = self.mi[mi_row - 1, mi_col] if up else None
        left_mi = self.mi[mi_row, mi_col - 1] if left else None
        return up, left, above_mi, left_mi

    # --- segmentation (decodemv.c:257-441) --------------------------------

    def seg_active(self, segment_id: int, feature: int) -> bool:
        return bool(self.fh.segmentation_enabled
                    and (self.fh.seg_feature_mask[segment_id]
                         & (1 << feature)))

    def seg_data(self, segment_id: int, feature: int) -> int:
        return self.fh.seg_feature_data[segment_id][feature]

    def seg_qindex(self, segment_id: int, base: int) -> int:
        """av1_get_qindex (quant_common.c:217)."""
        if self.seg_active(segment_id, 0):      # SEG_LVL_ALT_Q
            return max(0, min(255, base + self.seg_data(segment_id, 0)))
        return base

    def _spatial_seg_pred(self, ts, mi_row, mi_col):
        """av1_get_spatial_seg_pred (pred_common.h:48)."""
        up = mi_row > ts.mi_row_start
        left = mi_col > ts.mi_col_start
        prev_ul = prev_u = prev_l = -1
        if up and left:
            prev_ul = int(self.seg_map[mi_row - 1, mi_col - 1])
        if up:
            prev_u = int(self.seg_map[mi_row - 1, mi_col])
        if left:
            prev_l = int(self.seg_map[mi_row, mi_col - 1])
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
        return pred, cdf_index

    @staticmethod
    def _neg_deinterleave(diff, ref, mx):
        """av1_neg_deinterleave (decodemv.c:257)."""
        if not ref:
            return diff
        if ref >= mx - 1:
            return mx - diff - 1
        if 2 * ref < mx:
            if diff <= 2 * ref:
                if diff & 1:
                    return ref + ((diff + 1) >> 1)
                return ref - (diff >> 1)
            return diff
        if diff <= 2 * (mx - ref - 1):
            if diff & 1:
                return ref + ((diff + 1) >> 1)
            return ref - (diff >> 1)
        return mx - (diff + 1)

    def _read_segment_id(self, ts, rd, mi_row, mi_col, skip):
        pred, cdf_index = self._spatial_seg_pred(ts, mi_row, mi_col)
        if skip:
            return pred
        coded = rd.decode_symbol_adapt(
            ts.fc.seg_spatial_pred_cdf[cdf_index], c.MAX_SEGMENTS)
        return self._neg_deinterleave(coded, pred,
                                      self.fh.seg_last_active + 1)

    def _set_segment_id(self, bi, mi_row, mi_col, bsize, segment_id):
        bi.segment_id = segment_id
        h4 = min(blockd.mi_size_high(bsize), self.mi_rows - mi_row)
        w4 = min(blockd.mi_size_wide(bsize), self.mi_cols - mi_col)
        self.seg_map[mi_row:mi_row + h4, mi_col:mi_col + w4] = segment_id

    def _predicted_segment_id(self, mi_row, mi_col, bsize):
        if self.prev_seg_map is None:
            return 0
        h4 = min(blockd.mi_size_high(bsize), self.mi_rows - mi_row)
        w4 = min(blockd.mi_size_wide(bsize), self.mi_cols - mi_col)
        return int(self.prev_seg_map[mi_row:mi_row + h4,
                                     mi_col:mi_col + w4].min())

    def _read_inter_segment_id(self, ts, rd, bi, mi_row, mi_col, preskip):
        """read_inter_segment_id (decodemv.c:362)."""
        fh = self.fh
        bsize = bi.bsize
        if not fh.segmentation_enabled:
            return 0
        if not fh.seg_update_map:
            seg = self._predicted_segment_id(mi_row, mi_col, bsize)
            self._set_segment_id(bi, mi_row, mi_col, bsize, seg)
            return seg
        if preskip:
            if not fh.seg_preskip:
                return 0
        elif bi.skip_txfm:
            bi.seg_id_predicted = 0
            seg = self._read_segment_id(ts, rd, mi_row, mi_col, 1)
            self._set_segment_id(bi, mi_row, mi_col, bsize, seg)
            return seg
        if fh.seg_temporal_update:
            up = mi_row > ts.mi_row_start
            left = mi_col > ts.mi_col_start
            ctx = (int(self.seg_pred_grid[mi_row - 1, mi_col]) if up
                   else 0) +                   (int(self.seg_pred_grid[mi_row, mi_col - 1]) if left
                   else 0)
            bi.seg_id_predicted = rd.decode_symbol_adapt(
                ts.fc.seg_pred_cdf[ctx], 2)
            if bi.seg_id_predicted:
                seg = self._predicted_segment_id(mi_row, mi_col, bsize)
            else:
                seg = self._read_segment_id(ts, rd, mi_row, mi_col, 0)
        else:
            seg = self._read_segment_id(ts, rd, mi_row, mi_col, 0)
        self._set_segment_id(bi, mi_row, mi_col, bsize, seg)
        return seg

    def _decode_block(self, ts, rd, mi_row, mi_col, bsize, partition):
        fc = ts.fc
        bi = BlockInfo(bsize=bsize, partition=partition,
                       mi_row=mi_row, mi_col=mi_col)
        bw = blockd.mi_size_wide(bsize)
        bh = blockd.mi_size_high(bsize)
        up_avail, left_avail, above_mi, left_mi = \
            self._neighbors(ts, mi_row, mi_col)

        if not self.fh.is_intra:
            self._decode_inter_frame_block(ts, rd, bi, mi_row, mi_col, bsize,
                                           up_avail, left_avail, above_mi,
                                           left_mi)
            self._finish_block(ts, rd, bi, mi_row, mi_col, bsize, partition,
                               up_avail, left_avail)
            return

        # read_intra_frame_mode_info (decodemv.c:772): seg id order
        if self.fh.segmentation_enabled and self.fh.seg_preskip:
            self._set_segment_id(bi, mi_row, mi_col, bsize,
                                 self._read_segment_id(ts, rd, mi_row,
                                                       mi_col, 0))
        # skip_txfm (decodemv.c:445)
        if self.seg_active(bi.segment_id, 6):   # SEG_LVL_SKIP
            bi.skip_txfm = 1
        else:
            skip_ctx = (above_mi.skip_txfm if above_mi else 0) + \
                       (left_mi.skip_txfm if left_mi else 0)
            bi.skip_txfm = rd.decode_symbol_adapt(
                fc.skip_txfm_cdfs[skip_ctx], 2)
        if self.fh.segmentation_enabled and not self.fh.seg_preskip:
            self._set_segment_id(bi, mi_row, mi_col, bsize,
                                 self._read_segment_id(ts, rd, mi_row,
                                                       mi_col,
                                                       bi.skip_txfm))

        self._read_cdef(rd, bi, mi_row, mi_col)
        self._read_delta_q_params(ts, rd, bi, mi_row, mi_col)

        # av1_allow_intrabc: intra frame + allow_intrabc (decodemv.c:809)
        if self.fh.allow_intrabc:
            self._read_intrabc_info(ts, rd, bi, mi_row, mi_col, bsize)
            if bi.is_intrabc:
                self._finish_block(ts, rd, bi, mi_row, mi_col, bsize,
                                   partition, up_avail, left_avail)
                return

        # intra_frame_y_mode via kf_y_cdf
        above_mode = above_mi.y_mode if above_mi else c.DC_PRED
        left_mode = left_mi.y_mode if left_mi else c.DC_PRED
        cdf = fc.kf_y_cdf[INTRA_MODE_CONTEXT[above_mode]][
            INTRA_MODE_CONTEXT[left_mode]]
        bi.y_mode = rd.decode_symbol_adapt(cdf, c.INTRA_MODES)

        use_angle_delta = bsize >= c.BLOCK_8X8
        if use_angle_delta and intra.is_directional(bi.y_mode):
            bi.angle_delta_y = rd.decode_symbol_adapt(
                fc.angle_delta_cdf[bi.y_mode - c.V_PRED],
                2 * MAX_ANGLE_DELTA + 1) - MAX_ANGLE_DELTA

        is_chroma_ref = blockd.is_chroma_reference(
            mi_row, mi_col, bsize, self.ss_x, self.ss_y) \
            and self.num_planes > 1
        if is_chroma_ref:
            cfl_allowed = self._cfl_allowed(bsize)
            bi.uv_mode = rd.decode_symbol_adapt(
                fc.uv_mode_cdf[int(cfl_allowed)][bi.y_mode],
                c.UV_INTRA_MODES - int(not cfl_allowed))
            if bi.uv_mode == c.UV_CFL_PRED:
                bi.cfl_joint_sign = rd.decode_symbol_adapt(
                    fc.cfl_sign_cdf, c.CFL_JOINT_SIGNS)
                idx = 0
                if intra.cfl_sign_u(bi.cfl_joint_sign) != 0:
                    idx = rd.decode_symbol_adapt(
                        fc.cfl_alpha_cdf[
                            intra.cfl_context_u(bi.cfl_joint_sign)],
                        c.CFL_ALPHABET_SIZE) << 4
                if intra.cfl_sign_v(bi.cfl_joint_sign) != 0:
                    idx += rd.decode_symbol_adapt(
                        fc.cfl_alpha_cdf[
                            intra.cfl_context_v(bi.cfl_joint_sign)],
                        c.CFL_ALPHABET_SIZE)
                bi.cfl_alpha_idx = idx
            uv_base = bi.uv_mode if bi.uv_mode < c.UV_CFL_PRED else c.DC_PRED
            if use_angle_delta and intra.is_directional(uv_base):
                bi.angle_delta_uv = rd.decode_symbol_adapt(
                    fc.angle_delta_cdf[bi.uv_mode - c.V_PRED],
                    2 * MAX_ANGLE_DELTA + 1) - MAX_ANGLE_DELTA
        if self._allow_palette(bsize):
            self._read_palette_mode_info(ts, rd, bi, mi_row, mi_col, bsize,
                                         above_mi, left_mi, is_chroma_ref)
        if self._filter_intra_allowed(bi):
            if rd.decode_symbol_adapt(fc.filter_intra_cdfs[bsize], 2):
                bi.filter_intra_mode = rd.decode_symbol_adapt(
                    fc.filter_intra_mode_cdf, c.FILTER_INTRA_MODES)

        self._visit_palette(ts, rd, bi, mi_row, mi_col, bsize,
                            is_chroma_ref)
        self._finish_block(ts, rd, bi, mi_row, mi_col, bsize, partition,
                           up_avail, left_avail)

    def _read_intrabc_info(self, ts, rd, bi, mi_row, mi_col, bsize):
        """read_intrabc_info (decodemv.c:692): use_intrabc flag, DV ref from
        the INTRA_FRAME ref-MV stack, DV read with the ndvc contexts."""
        fc = ts.fc
        if not rd.decode_symbol_adapt(fc.intrabc_cdf, 2):
            return
        INTRABC_STATS["blocks"] += 1
        bi.is_intrabc = 1
        bi.is_inter = 1                  # is_inter_block(mbmi) semantics
        bi.mode = c.DC_PRED
        bi.uv_mode = c.DC_PRED
        bi.ref_frame = (MR.INTRABC_REF, -1)
        bi.interp_filter = (c.BILINEAR, c.BILINEAR)
        ctx = MR.RefMvContext(
            self.g, mi_row, mi_col, bsize, self.sb_mi,
            ts.mi_row_start, ts.mi_row_end, ts.mi_col_start, ts.mi_col_end,
            bi.partition)
        _, _, _, _, mv_list = MR.find_mv_refs(ctx, c.INTRA_FRAME)
        # av1_find_best_ref_mvs(allow_hp=0, is_integer=0)
        nearest = MR.lower_mv_precision(mv_list[0], 0, 0)
        near = MR.lower_mv_precision(mv_list[1], 0, 0)
        dv_ref = near if nearest == (0, 0) else nearest
        if dv_ref == (0, 0):
            dv_ref = MR.find_ref_dv(ts.mi_row_start, self.sb_mi, mi_row)
        dv_ref = ((dv_ref[0] >> 3) * 8, (dv_ref[1] >> 3) * 8)
        mv = self._read_mv(ts, rd, dv_ref, -1, dv=True)
        bi.mv = (mv, (0, 0))

    def _allow_palette(self, bsize) -> bool:
        """av1_allow_palette (blockd.h): screen tools + 8x8..64x64."""
        return (bool(self.fh.allow_screen_content_tools)
                and blockd.block_wide(bsize) <= 64
                and blockd.block_high(bsize) <= 64
                and bsize >= c.BLOCK_8X8)

    def _read_palette_mode_info(self, ts, rd, bi, mi_row, mi_col, bsize,
                                above_mi, left_mi, is_chroma_ref):
        """read_palette_mode_info (decodemv.c:569)."""
        from ..common import palette as PAL
        fc = ts.fc
        bd = self.bd
        bsize_ctx = PAL.palette_bsize_ctx(bsize)
        # above mi for cache/ctx is gated at 64-px SB rows
        # (pred_common.c:75); the mode ctx uses the ungated neighbors
        cache_above = above_mi if (mi_row * 4) % 64 else None
        sizes = [0, 0]
        colors = [[], [], []]
        if bi.y_mode == c.DC_PRED:
            mctx = PAL.palette_mode_ctx(above_mi, left_mi)
            if rd.decode_symbol_adapt(
                    fc.palette_y_mode_cdf[bsize_ctx][mctx], 2):
                sizes[0] = rd.decode_symbol_adapt(
                    fc.palette_y_size_cdf[bsize_ctx], c.PALETTE_SIZES) + 2
                cache = PAL.get_palette_cache(cache_above, left_mi, 0)
                colors[0] = PAL.read_palette_colors_y(rd, bd, sizes[0],
                                                      cache)
        if (self.num_planes > 1 and bi.uv_mode == c.DC_PRED
                and is_chroma_ref):
            uv_ctx = int(sizes[0] > 0)
            if rd.decode_symbol_adapt(fc.palette_uv_mode_cdf[uv_ctx], 2):
                sizes[1] = rd.decode_symbol_adapt(
                    fc.palette_uv_size_cdf[bsize_ctx], c.PALETTE_SIZES) + 2
                cache = PAL.get_palette_cache(cache_above, left_mi, 1)
                colors[1] = PAL.read_palette_colors_u(rd, bd, sizes[1],
                                                      cache)
                colors[2] = PAL.read_palette_colors_v(rd, bd, sizes[1])
        if sizes[0] or sizes[1]:
            bi.palette_size = tuple(sizes)
            bi.palette_colors = colors

    def _visit_palette(self, ts, rd, bi, mi_row, mi_col, bsize,
                       is_chroma_ref):
        """av1_visit_palette -> av1_decode_palette_tokens: decode the
        color-index maps after mode info, before tx sizes."""
        if bi.palette_colors is None:
            return
        from ..common import palette as PAL
        fc = ts.fc
        bw = blockd.mi_size_wide(bsize)
        bh = blockd.mi_size_high(bsize)
        mb_to_right = (self.mi_cols - bw - mi_col) * 4
        mb_to_bottom = (self.mi_rows - bh - mi_row) * 4
        maps = {}
        for plane in range(min(2, self.num_planes)):
            if plane == 1 and not is_chroma_ref:
                continue
            if not bi.palette_size[plane]:
                continue
            ss_x = self.ss_x if plane else 0
            ss_y = self.ss_y if plane else 0
            bwpx = blockd.block_wide(bsize)
            bhpx = blockd.block_high(bsize)
            block_rows = bhpx if mb_to_bottom >= 0 \
                else mb_to_bottom + bhpx
            block_cols = bwpx if mb_to_right >= 0 \
                else mb_to_right + bwpx
            pw = bwpx >> ss_x
            ph = bhpx >> ss_y
            rows = block_rows >> ss_y
            cols = block_cols >> ss_x
            cdf = (fc.palette_uv_color_index_cdf if plane
                   else fc.palette_y_color_index_cdf)
            maps[plane] = PAL.decode_color_map(
                rd, cdf, bi.palette_size[plane], pw, ph, rows, cols)
        bi.color_maps = maps

    def _finish_block(self, ts, rd, bi, mi_row, mi_col, bsize, partition,
                      up_avail, left_avail):
        """Tx sizes, mi-grid bookkeeping, then reconstruction
        (parse_decode_block tail, decodeframe.c:1129)."""
        bw = blockd.mi_size_wide(bsize)
        bh = blockd.mi_size_high(bsize)
        self._read_block_tx_size(ts, rd, bi, mi_row, mi_col)

        # fill mi grids (clipped: blocks may cross the frame edge)
        r1 = min(mi_row + bh, self.mi_rows)
        c1 = min(mi_col + bw, self.mi_cols)
        self.mi[mi_row:r1, mi_col:c1] = bi
        self.g.fill_block(mi_row, mi_col, bh, bw, bi.ref_frame[0],
                          bi.ref_frame[1],
                          bi.mode if bi.is_inter else bi.y_mode,
                          bsize, partition, bi.mv[0], bi.mv[1])
        m = self.g.m
        self.skip_mode_grid[mi_row + m:r1 + m, mi_col + m:c1 + m] = \
            bi.skip_mode
        self.interp_grid[mi_row + m:r1 + m, mi_col + m:c1 + m, 0] = \
            bi.interp_filter[1]
        self.interp_grid[mi_row + m:r1 + m, mi_col + m:c1 + m, 1] = \
            bi.interp_filter[0]
        self.skip_inter_grid[mi_row:r1, mi_col:c1] = \
            1 if (bi.skip_txfm and bi.is_inter) else 0
        self.seg_pred_grid[mi_row:r1, mi_col:c1] = bi.seg_id_predicted
        self.qindex_grid[mi_row:r1, mi_col:c1] = \
            getattr(bi, "qindex", self.fh.base_q_idx)
        self.delta_lf_grid[mi_row:r1, mi_col:c1] = self.delta_lf
        if self.sh.enable_ref_frame_mvs:
            if bi.is_inter and not bi.is_intrabc:
                self._copy_frame_mvs(bi, mi_row, mi_col, c1 - mi_col,
                                     r1 - mi_row)
            # intra blocks leave NONE (grid pre-initialized to -1);
            # intra_copy_frame_mvs resets explicitly
            else:
                r0 = mi_row >> 1
                c0 = mi_col >> 1
                self.frame_mvs_ref[r0:r0 + ((r1 - mi_row + 1) >> 1),
                                   c0:c0 + ((c1 - mi_col + 1) >> 1)] = -1
        if bi.tx_size >= 0 and bi.inter_leaves is None:
            self.tx_wide_grid[mi_row:r1, mi_col:c1] = c.TX_WIDTH[bi.tx_size]
            self.tx_high_grid[mi_row:r1, mi_col:c1] = c.TX_HEIGHT[bi.tx_size]
        elif bi.inter_leaves is not None:
            for (tr4, tc4, tx) in bi.inter_leaves:
                rr = mi_row + tr4
                cc = mi_col + tc4
                self.tx_wide_grid[rr:min(rr + (c.TX_HEIGHT[tx] >> 2),
                                         self.mi_rows),
                                  cc:min(cc + (c.TX_WIDTH[tx] >> 2),
                                         self.mi_cols)] = c.TX_WIDTH[tx]
                self.tx_high_grid[rr:min(rr + (c.TX_HEIGHT[tx] >> 2),
                                         self.mi_rows),
                                  cc:min(cc + (c.TX_WIDTH[tx] >> 2),
                                         self.mi_cols)] = c.TX_HEIGHT[tx]

        # residual + recon
        if bi.is_inter:
            self._recon_inter_block(ts, rd, bi, mi_row, mi_col)
        else:
            self._recon_block(ts, rd, bi, up_avail, left_avail)

    def _read_cdef(self, rd, bi, mi_row, mi_col):
        """read_cdef (decodemv.c:39): per-64x64 strength index, read at the
        first non-skip block, stored on the block covering the unit's
        top-left mi cell."""
        if not self.sh.enable_cdef or self.lossless or self.fh.allow_intrabc:
            return
        sb_mask = self.sb_mi - 1
        if (mi_row & sb_mask) == 0 and (mi_col & sb_mask) == 0:
            self._cdef_tx = [False] * 4
        if self.sb_size == c.BLOCK_128X128:
            index = int((mi_col & 16) != 0) + 2 * int((mi_row & 16) != 0)
        else:
            index = 0
        if not self._cdef_tx[index] and not bi.skip_txfm:
            val = rd.decode_literal(self.fh.cdef_bits) \
                if self.fh.cdef_bits else 0
            self._cdef_tx[index] = True
            r0 = mi_row & ~15
            c0 = mi_col & ~15
            target = self.mi[r0, c0]
            if target is None:
                target = bi   # current block covers the unit origin
            target.cdef_strength = val

    def apply_cdef(self):
        """CDEF after deblocking (decodeframe.c:5272 do_cdef gating)."""
        fh, sh = self.fh, self.sh
        if self.lossless or not sh.enable_cdef:
            return
        if not (fh.cdef_bits or fh.cdef_y_pri[0] or fh.cdef_y_sec[0]
                or (fh.cdef_uv_pri and fh.cdef_uv_pri[0])
                or (fh.cdef_uv_sec and fh.cdef_uv_sec[0])):
            return
        from ..common import cdef as CD
        nvfb = (self.mi_rows + 15) // 16
        nhfb = (self.mi_cols + 15) // 16
        strength_grid = np.full((nvfb, nhfb), -1, np.int32)
        skip_grid = np.ones((self.mi_rows, self.mi_cols), np.uint8)
        for r in range(self.mi_rows):
            for cc in range(self.mi_cols):
                bi = self.mi[r, cc]
                if bi is not None:
                    skip_grid[r, cc] = bi.skip_txfm
        for fr in range(nvfb):
            for fc_ in range(nhfb):
                bi = self.mi[fr * 16, fc_ * 16]
                if bi is not None:
                    strength_grid[fr, fc_] = bi.cdef_strength
        CD.cdef_frame(self.planes, self.mi_rows, self.mi_cols, self.ss_x,
                      self.ss_y, self.num_planes, skip_grid, strength_grid,
                      fh, bd=self.sh.bit_depth)

    def _cfl_allowed(self, bsize):
        if self.lossless:
            return blockd.plane_block_size(
                bsize, self.ss_x, self.ss_y) == c.BLOCK_4X4
        return blockd.block_wide(bsize) <= 32 and \
            blockd.block_high(bsize) <= 32

    def _filter_intra_allowed(self, bi):
        return (self.sh.enable_filter_intra and bi.y_mode == c.DC_PRED
                and bi.palette_size[0] == 0
                and blockd.block_wide(bi.bsize) <= 32
                and blockd.block_high(bi.bsize) <= 32)

    # --- reconstruction ---------------------------------------------------

    def _recon_block(self, ts, rd, bi, up_avail, left_avail):
        mi_row, mi_col, bsize = bi.mi_row, bi.mi_col, bi.bsize
        bw = blockd.mi_size_wide(bsize)
        bh = blockd.mi_size_high(bsize)
        is_chroma_ref = blockd.is_chroma_reference(
            mi_row, mi_col, bsize, self.ss_x, self.ss_y) \
            and self.num_planes > 1
        chroma_up = up_avail
        chroma_left = left_avail
        if self.ss_x and bw < 2:
            chroma_left = (mi_col - 1) > ts.mi_col_start
        if self.ss_y and bh < 2:
            chroma_up = (mi_row - 1) > ts.mi_row_start

        nplanes = self.num_planes if is_chroma_ref else 1
        # residual order (spec 5.11.34): blocks wider/taller than 64 are
        # coded in 64x64 chunks with the planes interleaved per chunk
        w_chunks = max(1, blockd.block_wide(bsize) >> 6)
        h_chunks = max(1, blockd.block_high(bsize) >> 6)
        for cy in range(h_chunks):
          for cx in range(w_chunks):
            for plane in range(nplanes):
                ss_x = self.ss_x if plane else 0
                ss_y = self.ss_y if plane else 0
                if plane:
                    plane_bsize = blockd.plane_block_size(bsize, ss_x, ss_y)
                else:
                    plane_bsize = bsize
                pbw = blockd.block_wide(plane_bsize)
                pbh = blockd.block_high(plane_bsize)
                # plane-space origin (mi rounded down for sub-8x8 chroma)
                row0 = ((mi_row - (mi_row & ss_y)) * 4) >> ss_y if plane \
                    else mi_row * 4
                col0 = ((mi_col - (mi_col & ss_x)) * 4) >> ss_x if plane \
                    else mi_col * 4
                if self.lossless:
                    tx_size = c.TX_4X4
                elif plane == 0:
                    tx_size = bi.tx_size
                else:
                    tx_size = self._plane_tx_size(plane, plane_bsize)
                txw4 = c.TX_WIDTH[tx_size] >> 2
                txh4 = c.TX_HEIGHT[tx_size] >> 2
                # visible extent in 4x4 units (max_block_wide: blocks may
                # cross the frame edge; only in-bounds tx blocks coded)
                mb_to_right = (self.mi_cols - bw - mi_col) * 4
                mb_to_bottom = (self.mi_rows - bh - mi_row) * 4
                vis_w = pbw + (min(mb_to_right, 0) >> ss_x)
                vis_h = pbh + (min(mb_to_bottom, 0) >> ss_y)
                max_cols4 = max(vis_w >> 2, 1)
                max_rows4 = max(vis_h >> 2, 1)
                # chunk bounds in plane 4x4 units
                cu_r0 = (cy * 64 >> ss_y) >> 2
                cu_c0 = (cx * 64 >> ss_x) >> 2
                cu_r1 = min(((cy + 1) * 64 >> ss_y) >> 2, max_rows4)
                cu_c1 = min(((cx + 1) * 64 >> ss_x) >> 2, max_cols4)
                for tr4 in range(cu_r0, cu_r1, txh4):
                    for tc4 in range(cu_c0, cu_c1, txw4):
                        self._recon_txb(ts, rd, bi, plane, plane_bsize,
                                        tx_size, row0, col0, tr4, tc4,
                                        up_avail, left_avail,
                                        chroma_up, chroma_left)
                if plane == 0 and cy == 0 and cx == 0 \
                        and self._store_cfl_required(bi, is_chroma_ref):
                    self._cfl_store_block(bi)

    def _iqm_fn(self, plane, tx_size, bi):
        """av1_get_iqmatrix: per-position dequant weights, or None.  Flat
        for lossless segments, 1D/identity tx types, and level 15
        (quant_common.c:252)."""
        fh = self.fh
        if not fh.using_qmatrix:
            return None
        level = (fh.qm_y, fh.qm_u, fh.qm_v)[plane]
        if level == 15:
            return None
        # xd->lossless[seg]: seg qindex 0 + all plane dc/ac deltas 0
        if (getattr(bi, "qindex", fh.base_q_idx) == 0
                and not (fh.delta_q_y_dc or fh.delta_q_u_dc
                         or fh.delta_q_u_ac or fh.delta_q_v_dc
                         or fh.delta_q_v_ac)):
            return None
        from ..common import quant as QT

        def fn(tx_type):
            if tx_type >= c.IDTX:   # is_2d_transform only
                return None
            return QT.iqm_table(level, int(plane > 0), tx_size)
        return fn

    def _plane_tx_size(self, plane, plane_bsize):
        """TX_MODE_LARGEST: largest rect tx; chroma capped at 32x32."""
        tx = blockd.max_tx_size_rect(plane_bsize)
        if plane:
            w = min(32, c.TX_WIDTH[tx])
            h = min(32, c.TX_HEIGHT[tx])
            tx = blockd.tx_size_of(w, h)
        return tx

    def _store_cfl_required(self, bi, is_chroma_ref) -> bool:
        if self.num_planes == 1:
            return False
        if not is_chroma_ref:
            return True
        return bi.uv_mode == c.UV_CFL_PRED

    def _cfl_store_block(self, bi):
        """Store luma recon (Q3-subsampled) for CfL
        (cfl.c:424 cfl_store_block)."""
        bsize = bi.bsize
        w = blockd.block_wide(bsize)
        h = blockd.block_high(bsize)
        sub_x = (bi.mi_col & 1) and w == 4
        sub_y = (bi.mi_row & 1) and h == 4
        px_r = bi.mi_row * 4
        px_c = bi.mi_col * 4
        # clip to the visible area aligned up to the luma tx dims
        # (cfl.c max_intra_block_width/height); the beyond-edge part is
        # replicated by cfl_pad at predict time, not read from recon
        txw = c.TX_WIDTH[bi.tx_size] if bi.tx_size >= 0 else w
        txh = c.TX_HEIGHT[bi.tx_size] if bi.tx_size >= 0 else h
        vis_w = min(w, max((self.mi_cols - bi.mi_col) * 4, 4))
        vis_h = min(h, max((self.mi_rows - bi.mi_row) * 4, 4))
        w = min(w, -(-vis_w // txw) * txw)
        h = min(h, -(-vis_h // txh) * txh)
        luma = self.planes[0][px_r:px_r + h, px_c:px_c + w]
        if self.ss_x and self.ss_y:
            q3 = intra.cfl_subsample_420(luma)
        elif not self.ss_x and not self.ss_y:
            q3 = luma.astype(np.int32) << 3
        else:
            l32 = luma.astype(np.int32)
            q3 = (l32[:, 0::2] + l32[:, 1::2]) << 2
        row = (sub_y << 2) >> self.ss_y
        col = (sub_x << 2) >> self.ss_x
        qh, qw = q3.shape
        self.cfl_buf[row:row + qh, col:col + qw] = q3
        self.cfl_buf_w = col + qw
        self.cfl_buf_h = row + qh

    def _cfl_predict(self, bi, dc_pred, plane):
        h, w = dc_pred.shape
        # pad (cfl.c:83): replicate last stored col/row if needed
        if self.cfl_buf_w < w:
            self.cfl_buf[:self.cfl_buf_h, self.cfl_buf_w:w] = \
                self.cfl_buf[:self.cfl_buf_h,
                             self.cfl_buf_w - 1:self.cfl_buf_w]
            self.cfl_buf_w = w
        if self.cfl_buf_h < h:
            self.cfl_buf[self.cfl_buf_h:h, :w] = \
                self.cfl_buf[self.cfl_buf_h - 1:self.cfl_buf_h, :w]
            self.cfl_buf_h = h
        alpha = intra.cfl_idx_to_alpha(bi.cfl_alpha_idx, bi.cfl_joint_sign,
                                       plane - 1)
        return intra.cfl_predict(dc_pred, self.cfl_buf[:h, :w], alpha,
                                 self.bd)

    def _recon_txb(self, ts, rd, bi, plane, plane_bsize, tx_size, row0, col0,
                   row_off, col_off, up_avail, left_avail, chroma_up,
                   chroma_left):
        """Predict one tx block, decode coeffs, inverse transform, add."""
        fh, sh = self.fh, self.sh
        ss_x = self.ss_x if plane else 0
        ss_y = self.ss_y if plane else 0
        txwpx = c.TX_WIDTH[tx_size]
        txhpx = c.TX_HEIGHT[tx_size]
        x = col_off * 4
        y = row_off * 4
        px = col0 + x
        py = row0 + y
        ref = self.planes[plane]

        have_top = row_off > 0 or (chroma_up if ss_y else up_avail)
        have_left = col_off > 0 or (chroma_left if ss_x else left_avail)

        mi_row, mi_col = bi.mi_row, bi.mi_col
        bw_mi = blockd.mi_size_wide(bi.bsize)
        bh_mi = blockd.mi_size_high(bi.bsize)
        wpx = blockd.block_wide(plane_bsize)
        hpx = blockd.block_high(plane_bsize)
        # distances to the mi-grid edge (av1_common_int set_mi_row_col)
        mb_to_right = (self.mi_cols - bw_mi - mi_col) * 4
        mb_to_bottom = (self.mi_rows - bh_mi - mi_row) * 4
        xr = (mb_to_right >> ss_x) + wpx - x - txwpx
        yd = (mb_to_bottom >> ss_y) + hpx - y - txhpx
        txw = txwpx >> 2
        txh = txhpx >> 2
        right_avail = mi_col + ((col_off + txw) << ss_x) < ts.mi_col_end
        bottom_avail = (yd > 0) and \
            (mi_row + ((row_off + txh) << ss_y) < ts.mi_row_end)

        cbsize = bi.bsize
        if ss_x or ss_y:
            cbsize = _scale_chroma_bsize(bi.bsize, ss_x, ss_y)

        if bi.palette_size[int(plane != 0)]:
            # av1_predict_intra_block palette branch (reconintra.c:1628):
            # map color indices through the base colors; residual still adds.
            cmap = bi.color_maps[int(plane != 0)]
            cols = np.asarray(bi.palette_colors[plane], dtype=ref.dtype)
            ref[py:py + txhpx, px:px + txwpx] = \
                cols[cmap[y:y + txhpx, x:x + txwpx]]
            self._recon_txb_coeffs(ts, rd, bi, plane, plane_bsize, tx_size,
                                   px, py, mb_to_right, mb_to_bottom,
                                   row_off, col_off, txw, txh)
            return

        mode = bi.y_mode if plane == 0 else \
            (c.DC_PRED if bi.uv_mode == c.UV_CFL_PRED else bi.uv_mode)
        angle_delta = bi.angle_delta_y if plane == 0 else bi.angle_delta_uv
        filter_intra = bi.filter_intra_mode if plane == 0 else -1

        is_dr = intra.is_directional(mode)
        p_angle = intra.MODE_TO_ANGLE.get(mode, 0) + \
            angle_delta * intra.ANGLE_STEP if is_dr else 0
        need_tr = mode in (c.D45_PRED, c.D67_PRED)
        need_bl = mode == c.D203_PRED
        if filter_intra >= 0:
            need_tr = need_bl = False
        if is_dr:
            need_tr = p_angle < 90
            need_bl = p_angle > 180

        have_tr = blockd.has_top_right(
            self.sb_log2, cbsize, mi_row, mi_col, have_top, right_avail,
            bi.partition, tx_size, row_off, col_off, ss_x, ss_y) \
            if need_tr else -1
        have_bl = blockd.has_bottom_left(
            self.sb_log2, cbsize, mi_row, mi_col, bottom_avail, have_left,
            bi.partition, tx_size, row_off, col_off, ss_x, ss_y) \
            if need_bl else -1

        edge_type = self._intra_edge_filter_type(
            bi, plane, up_avail, left_avail, chroma_up, chroma_left)
        pred = intra.build_intra_predictor(
            ref, px, py, txwpx, txhpx, mode, angle_delta, filter_intra,
            n_top_px=min(txwpx, xr + txwpx) if have_top else 0,
            n_topright_px=(min(txwpx, xr) if have_tr > 0 else have_tr),
            n_left_px=min(txhpx, yd + txhpx) if have_left else 0,
            n_bottomleft_px=(min(txhpx, yd) if have_bl > 0 else have_bl),
            disable_edge_filter=not sh.enable_intra_edge_filter,
            intra_edge_filter_type=edge_type, bd=self.bd)

        if plane and bi.uv_mode == c.UV_CFL_PRED:
            pred = self._cfl_predict(bi, pred, plane)

        ref[py:py + txhpx, px:px + txwpx] = pred
        self._recon_txb_coeffs(ts, rd, bi, plane, plane_bsize, tx_size,
                               px, py, mb_to_right, mb_to_bottom,
                               row_off, col_off, txw, txh)

    def _recon_txb_coeffs(self, ts, rd, bi, plane, plane_bsize, tx_size,
                          px, py, mb_to_right, mb_to_bottom,
                          row_off, col_off, txw, txh):
        """Coeff decode + inverse transform + add for one tx block."""
        ss_x = self.ss_x if plane else 0
        ss_y = self.ss_y if plane else 0
        txwpx = c.TX_WIDTH[tx_size]
        txhpx = c.TX_HEIGHT[tx_size]
        ref = self.planes[plane]
        mi_row, mi_col = bi.mi_row, bi.mi_col
        au = ts.above_entropy[plane]
        lu = ts.left_entropy[plane]
        acol = ((mi_col >> ss_x) if plane else mi_col) + col_off
        lrow = ((mi_row >> ss_y) if plane else mi_row) + row_off
        if bi.skip_txfm:
            au[acol:acol + txw] = 0
            lu[lrow:lrow + txh] = 0
            return
        skip_ctx, dc_sign_ctx = CF.txb_ctx(
            plane_bsize, tx_size, plane, au[acol:acol + txw],
            lu[lrow:lrow + txh])
        dqv_dc, dqv_ac = self._dqv(plane, getattr(bi, "qindex",
                                                  self.fh.base_q_idx))
        if self.lossless:
            tx_type = c.DCT_DCT  # lossless: WHT, coded as DCT_DCT class
        elif plane == 0:
            tx_type = self._make_tx_type_reader(ts, rd, bi, tx_size)
        else:
            from ..common import txtype as TT
            tx_type = TT.chroma_intra_tx_type(bi.uv_mode, tx_size,
                                              self.fh.reduced_tx_set)
        t0 = rd.tell_frac() if self.acct is not None else 0
        eob, cul_level, dqcoeff = CF.read_coeffs_txb(
            rd, ts.fc, plane, tx_size, tx_type, skip_ctx, dc_sign_ctx,
            dqv_dc, dqv_ac, self.bd,
            iqm_fn=self._iqm_fn(plane, tx_size, bi))
        if self.acct is not None:
            key = "coeffs_y" if plane == 0 else "coeffs_uv"
            self.acct[key] = self.acct.get(key, 0) + rd.tell_frac() - t0
        pbw4 = blockd.block_wide(plane_bsize) >> 2
        pbh4 = blockd.block_high(plane_bsize) >> 2
        vis_w4 = pbw4 + (min(mb_to_right, 0) >> (2 + ss_x))
        vis_h4 = pbh4 + (min(mb_to_bottom, 0) >> (2 + ss_y))
        CF.set_entropy_spans(au, lu, acol, lrow, txw, txh, cul_level,
                             vis_w4, vis_h4, col_off, row_off,
                             mb_to_right < 0, mb_to_bottom < 0)
        if eob:
            if self.lossless:
                res = iwht4x4(dqcoeff.reshape(4, 4))
                block = ref[py:py + txhpx, px:px + txwpx].astype(np.int32) \
                    + res
                ref[py:py + txhpx, px:px + txwpx] = \
                    np.clip(block, 0, (1 << self.bd) - 1).astype(ref.dtype)
            else:
                from ..common import txfm2d as T2
                tt = (tx_type if isinstance(tx_type, int)
                      else self._last_tx_type)
                ref[py:py + txhpx, px:px + txwpx] = T2.inv_txfm2d_add(
                    dqcoeff, ref[py:py + txhpx, px:px + txwpx], tx_size, tt,
                    self.bd)


    def _make_tx_type_reader(self, ts, rd, bi, tx_size):
        """Callable handed to read_coeffs_txb: reads the luma tx_type symbol
        after the all_zero flag (decodemv.c:640 av1_read_tx_type)."""
        from ..common import txtype as TT

        def read_tx_type():
            # skip / SEG_LVL_SKIP / segment-lossless (qindex==0) blocks
            # carry no tx_type symbol (av1_read_tx_type, decodemv.c:633)
            if (bi.skip_txfm or self.seg_active(bi.segment_id, 6)
                    or self.seg_qindex(bi.segment_id,
                                       self.fh.base_q_idx) == 0):
                tt = c.DCT_DCT
            else:
                st = TT.ext_tx_set_type(tx_size, False,
                                        bool(self.fh.reduced_tx_set))
                if TT.NUM_EXT_TX_SET[st] <= 1:
                    tt = c.DCT_DCT
                else:
                    eset = TT.intra_ext_tx_idx(st)
                    sqr = c.TX_SIZE_SQR[tx_size]
                    # filter-intra blocks use the mapped directional mode
                    # (decodemv.c:659 fimode_to_intradir)
                    mode = (FIMODE_TO_INTRADIR[bi.filter_intra_mode]
                            if bi.filter_intra_mode >= 0 else bi.y_mode)
                    sym = rd.decode_symbol_adapt(
                        ts.fc.intra_ext_tx_cdf[eset][sqr][mode],
                        TT.NUM_EXT_TX_SET[st])
                    tt = TT.EXT_TX_INV[st][sym]
            self._last_tx_type = tt
            return tt
        return read_tx_type

    def _intra_edge_filter_type(self, bi, plane, up_avail, left_avail,
                                chroma_up, chroma_left):
        """reconintra.c:961 get_intra_edge_filter_type."""
        mi_row, mi_col = bi.mi_row, bi.mi_col
        if plane == 0:
            ab = self.mi[mi_row - 1, mi_col] if up_avail else None
            le = self.mi[mi_row, mi_col - 1] if left_avail else None
            smooth = (_is_smooth_y(ab) or _is_smooth_y(le))
        else:
            br = mi_row - (mi_row & self.ss_y)
            bc = mi_col - (mi_col & self.ss_x)
            ab = self.mi[br - 1, bc + self.ss_x] if chroma_up else None
            le = self.mi[br + self.ss_y, bc - 1] if chroma_left else None
            smooth = (_is_smooth_uv(ab) or _is_smooth_uv(le))
        return 1 if smooth else 0

    def apply_loop_filter(self):
        """Deblocking (spec §7.14) over the reconstructed frame."""
        fh, sh = self.fh, self.sh
        if self.lossless or (fh.filter_level[0] == 0
                             and fh.filter_level[1] == 0
                             and fh.filter_level_u == 0
                             and fh.filter_level_v == 0):
            return
        from ..common import loopfilter as LF
        m = self.g.m
        bsg = self.g.bsize[m:m + self.mi_rows, m:m + self.mi_cols] \
            .astype(np.int32)
        ref_grid = self.g.ref0[m:m + self.mi_rows, m:m + self.mi_cols] \
            .astype(np.int32)
        mode_grid = self.g.mode[m:m + self.mi_rows, m:m + self.mi_cols] \
            .astype(np.int32)
        skip_inter = self.skip_inter_grid[:self.mi_rows, :self.mi_cols]

        def plane_tx(plane, bsize):
            pb = blockd.plane_block_size(bsize, self.ss_x, self.ss_y) \
                if plane else bsize
            return self._plane_tx_size(plane, pb)

        LF.loop_filter_frame(
            self.planes, fh, sh,
            (self.tx_wide_grid >> 2).astype(np.int64),
            (self.tx_high_grid >> 2).astype(np.int64),
            bsg, ref_grid, mode_grid, skip_inter, plane_tx,
            seg_grid=self.seg_map if fh.segmentation_enabled else None,
            bd=self.bd)

    def output(self):
        w, h = self.upscaled_width, self.fh.frame_height
        y = self.planes[0][:h, :w]
        if self.num_planes == 1:
            return y, None, None
        cw = (w + self.ss_x) >> self.ss_x
        ch = (h + self.ss_y) >> self.ss_y
        return y, self.planes[1][:ch, :cw], self.planes[2][:ch, :cw]


def _is_smooth_y(bi):
    return bi is not None and bi.y_mode in (
        c.SMOOTH_PRED, c.SMOOTH_V_PRED, c.SMOOTH_H_PRED)


def _is_smooth_uv(bi):
    return bi is not None and bi.uv_mode in (
        c.SMOOTH_PRED, c.SMOOTH_V_PRED, c.SMOOTH_H_PRED)


def _scale_chroma_bsize(bsize, ss_x, ss_y):
    """reconintra.c:1478 scale_chroma_bsize."""
    w = blockd.block_wide(bsize)
    h = blockd.block_high(bsize)
    if w < 8 and ss_x:
        w = 8
    if h < 8 and ss_y:
        h = 8
    return blockd.bsize_of(w, h)


# lookup: (above, left) partition context bytes (common_data.h:385);
# above = ~((1 << (4 - log2(bw/4))) - 1) & 31-style pattern
def _partition_ctx_lookup(subsize):
    bw4 = blockd.mi_size_wide(subsize)
    bh4 = blockd.mi_size_high(subsize)
    above = (31 << (bw4.bit_length() - 1)) & 31
    left = (31 << (bh4.bit_length() - 1)) & 31
    return above, left


# ---------------------------------------------------------------------------
# Stream-level entry points
# ---------------------------------------------------------------------------


def decode_frame_obus(data: bytes, sh: H.SequenceHeader | None = None,
                      state: dict | None = None):
    """Decode one temporal unit; returns (frames, sh).  `state` carries
    the reference frame slots across calls (ref_frame_map semantics).
    Malformed input raises CorruptFrameError (invalid_file_test.cc
    contract) rather than leaking internal failures."""
    try:
        return _decode_frame_obus(data, sh, state)
    except CorruptFrameError:
        raise
    except (AssertionError, IndexError, ValueError, KeyError,
            NotImplementedError, ZeroDivisionError) as e:
        raise CorruptFrameError(
            f"corrupt or unsupported bitstream: {e!r}") from e


def _decode_frame_obus(data: bytes, sh: H.SequenceHeader | None = None,
                       state: dict | None = None):
    """Decode one temporal unit; returns (frames, sh).  `state` carries the
    reference frame slots across calls (ref_frame_map semantics).

    Handles both OBU_FRAME (header + tile group in one OBU) and separate
    OBU_FRAME_HEADER + N x OBU_TILE_GROUP layouts (decodeframe.c:5379
    av1_decode_frame_headers_and_setup + obu.c read_one_tile_group)."""
    if state is None:
        state = {"slots": [None] * 8}
    frames = []
    session = None
    # operating-point layer filter (obu.c:172 drop semantics): frames
    # with a temporal/spatial id above state["max_tid"]/["max_sid"]
    # are not decoded
    max_tid = state.get("max_tid")
    max_sid = state.get("max_sid")
    for obu_type, payload, tid, sid in H.split_obus_ext(data):
        if obu_type in (c.OBU_FRAME, c.OBU_FRAME_HEADER,
                        c.OBU_TILE_GROUP):
            if max_tid is not None and tid > max_tid:
                continue
            if max_sid is not None and sid > max_sid:
                continue
        if obu_type == c.OBU_SEQUENCE_HEADER:
            sh = H.parse_sequence_header(payload)
            op = state.get("operating_point")
            if op is not None:
                # AV1D_SET_OPERATING_POINT: derive the layer filter
                # from operating_point_idc (spec 6.4.1; obu.c:122).
                # Our writer emits one operating point; scalable
                # streams use the idc as the layer mask for any op.
                idc = sh.operating_point_idc
                if idc:
                    max_tid = state["max_tid"] = \
                        max((idc & 0xFF).bit_length() - 1, 0)
                    max_sid = state["max_sid"] = \
                        max(((idc >> 8) & 0xF).bit_length() - 1, 0)
        elif obu_type in (c.OBU_FRAME, c.OBU_FRAME_HEADER):
            assert sh is not None
            fh, endbit = H.parse_frame_header(payload, sh, ref_state=state)
            # query-side bookkeeping (aomdx.h AOMD_GET_* accessors)
            state["last_fh"] = fh
            if not fh.show_existing_frame:
                if not fh.show_frame and fh.showable_frame:
                    state["altref_seen"] = True
                if fh.frame_type == c.KEY_FRAME and not fh.show_frame:
                    state["fwd_kf_seen"] = True
            if fh.show_existing_frame:
                slot = state["slots"][fh.frame_to_show]
                assert slot is not None
                frames.append(_grain_output(
                    slot["planes"], slot.get("grain"), sh,
                    skip=state.get("skip_film_grain", False)))
                continue
            session = _FrameSession(sh, fh, state)
            if obu_type == c.OBU_FRAME:
                # tile group: byte-aligned after the header
                session.feed(payload[(endbit + 7) >> 3:])
                out = session.finish()
                session = None
                if fh.show_frame:
                    frames.append(_grain_output(
                        out, fh.film_grain, sh,
                        skip=state.get("skip_film_grain", False)))
        elif obu_type == c.OBU_TILE_GROUP:
            assert session is not None, "tile group without frame header"
            if session.feed(payload):
                out = session.finish()
                fh = session.fh
                session = None
                if fh.show_frame:
                    frames.append(_grain_output(
                        out, fh.film_grain, sh,
                        skip=state.get("skip_film_grain", False)))
        elif obu_type in (c.OBU_TEMPORAL_DELIMITER, c.OBU_METADATA,
                          c.OBU_PADDING, c.OBU_REDUNDANT_FRAME_HEADER):
            continue
    return frames, sh


def _grain_output(planes, params, sh, skip=False):
    """Film grain applied at output only (av1_dx_iface.c:780); reference
    frames stay un-grained.  `skip` is the AV1D_SET_SKIP_FILM_GRAIN
    control."""
    if skip or params is None or not params.apply_grain:
        return planes
    from .grain import apply_film_grain
    return apply_film_grain(
        params, planes, sub_x=sh.subsampling_x, sub_y=sh.subsampling_y,
        mc_identity=(sh.matrix_coefficients == 0))


class _FrameSession:
    """One frame's decode across 1..N tile-group OBUs (spec 5.11.1
    tile_group_obu; obu.c:decode_tile_group_obu)."""

    def __init__(self, sh, fh, state):
        self.sh, self.fh, self.state = sh, fh, state
        refs = state["slots"] if state is not None else None
        self.dec = FrameDecoder(sh, fh, refs=refs)
        self.dec.state = state
        if state is not None and state.get("inspect_hook"):
            self.dec.acct = {}
        # uniform spacing (spec 5.9.15): TileCols = ceil(sbCols/sizeSb)
        # with sizeSb = ceil(sbCols >> log2) — NOT 1 << log2, which
        # over-counts when the log2 exceeds what sbCols can fill
        def _n(sbs, log2):
            size_sb = (sbs + (1 << log2) - 1) >> log2
            return -(-sbs // size_sb)
        self.tile_cols = _n(fh.sb_cols(sh), fh.tile_cols_log2)
        self.tile_rows = _n(fh.sb_rows(sh), fh.tile_rows_log2)
        self.n_tiles = self.tile_cols * self.tile_rows
        self.next_tile = 0
        self.tile_states = []
        self.tile_payloads = []   # (tile_idx, bytes) for AV1D_GET_TILE_*

    def feed(self, data: bytes) -> bool:
        """Decode one tile-group OBU payload; True when the frame's last
        tile has been decoded."""
        from ..bitstream.bits import BitReader
        fh = self.fh
        r = BitReader(data)
        start_end_present = 0
        if self.n_tiles > 1:
            start_end_present = r.read_bit()
        if self.n_tiles == 1 or not start_end_present:
            tg_start, tg_end = 0, self.n_tiles - 1
        else:
            bits = fh.tile_cols_log2 + fh.tile_rows_log2
            tg_start = r.read_literal(bits)
            tg_end = r.read_literal(bits)
        assert tg_start == self.next_tile, "tile groups out of order"
        from contextlib import nullcontext as profile
        pos = (r.bit_offset + 7) >> 3   # byte_alignment()
        tiles = []
        for tn in range(tg_start, tg_end + 1):
            if tn == tg_end:
                tile_data = data[pos:]
                if not tile_data:
                    raise CorruptFrameError("empty tile payload")
            else:
                size = int.from_bytes(
                    data[pos:pos + fh.tile_size_bytes], "little") + 1
                pos += fh.tile_size_bytes
                if pos + size > len(data):
                    raise CorruptFrameError("tile size exceeds payload")
                tile_data = data[pos:pos + size]
                pos += size
            tiles.append((tn, tile_data))
        self.tile_payloads.extend(tiles)
        workers = (self.state or {}).get("tile_workers", 0)
        if (workers > 1 and len(tiles) > 1 and self.dec.acct is None
                and not (self.state or {}).get("inspect_hook")):
            # tile-parallel decode (decode_tiles_mt analog): forked
            # workers, per-tile state merge, bit-identical to serial
            from types import SimpleNamespace
            from .parallel import decode_tiles_mt
            with profile("decode/tile"):
                fcs = decode_tiles_mt(self.dec, tiles, workers)
            for tn, _ in tiles:
                self.tile_states.append(SimpleNamespace(fc=fcs[tn]))
            self.dec._last_ts = self.tile_states[-1]
        else:
            for tn, tile_data in tiles:
                trow, tcol = divmod(tn, self.tile_cols)
                with profile("decode/tile"):
                    self.dec.decode_tile_data(tile_data, trow, tcol)
                self.tile_states.append(self.dec._last_ts)
        self.next_tile = tg_end + 1
        return self.next_tile == self.n_tiles

    def finish(self):
        assert self.next_tile == self.n_tiles, "frame missing tiles"
        dec, fh = self.dec, self.fh
        # backward context update uses context_update_tile_id's context
        dec._last_ts = self.tile_states[min(fh.context_update_tile_id,
                                            self.n_tiles - 1)]
        from contextlib import nullcontext as profile
        with profile("decode/filters"):
            dec.apply_loop_filter()
            dec.save_lr_boundaries(0)
            dec.apply_cdef()
            dec.apply_superres()
            dec.save_lr_boundaries(1)
            dec.apply_loop_restoration()
        out = dec.output()
        _update_ref_state(self.state, fh, dec, out)
        if self.state is not None:
            # query-side snapshot (AV1D_GET_MI_INFO / _GET_TILE_*);
            # views into the decoder's grids — dec is dropped after
            # finish(), so this keeps one frame's metadata alive
            g, m = dec.g, dec.g.m
            r, c_ = dec.mi_rows, dec.mi_cols
            self.state["last_mi"] = {
                "mode": g.mode[m:m + r, m:m + c_],
                "ref0": g.ref0[m:m + r, m:m + c_],
                "mv": g.mv[m:m + r, m:m + c_],
                "bsize": g.bsize[m:m + r, m:m + c_],
                "skip": dec.skip_inter_grid[:r, :c_],
                "seg": dec.seg_map[:r, :c_],
            }
            self.state["last_tiles"] = {
                "cols": self.tile_cols, "rows": self.tile_rows,
                "cols_log2": fh.tile_cols_log2,
                "rows_log2": fh.tile_rows_log2,
                "payloads": self.tile_payloads,
            }
        if self.state is not None and self.state.get("inspect_hook"):
            self.state["inspect_hook"](dec, fh, out)
        return out


def _decode_tile_group(data: bytes, sh, fh, state=None):
    """Single-call decode of a frame whose tiles are all in `data`."""
    s = _FrameSession(sh, fh, state)
    s.feed(data)
    return s.finish()


def _update_ref_state(state, fh, dec, out):
    if state is not None and fh.refresh_frame_flags:
        # stored frame context: the post-decode state of the context
        # update tile with backward refresh, else the frame's initial one
        if fh.disable_frame_end_update_cdf:
            fc_store = dec.fc0
        else:
            fc_store = dec._last_ts.fc
            fc_store.reset_counters()
        stored = {
            "planes": tuple(p.copy() if p is not None else None
                            for p in out),
            "order_hint": fh.order_hint,
            "fc": fc_store,
            "deltas": (fh.ref_deltas, fh.mode_deltas),
            "frame_type": fh.frame_type,
            "mi_dims": (dec.mi_rows, dec.mi_cols),
            "mvs": (dec.frame_mvs_ref.copy(), dec.frame_mvs.copy()),
            "seg_map": dec.seg_map.copy(),
            "ref_order_hints": tuple(
                dec.ref_hints[c.LAST_FRAME + i] for i in range(7)),
        }
        stored["grain"] = fh.film_grain
        for slot in range(8):
            if fh.refresh_frame_flags & (1 << slot):
                state["slots"][slot] = stored
        state.setdefault("order_hints", [0] * 8)
        state.setdefault("grain", {})
        for slot in range(8):
            if fh.refresh_frame_flags & (1 << slot):
                state["grain"][slot] = fh.film_grain
        state.setdefault("deltas", {})
        state.setdefault("gm", {})
        state.setdefault("seg", {})
        state.setdefault("sizes", {})
        seg_store = ((fh.seg_feature_mask, fh.seg_feature_data)
                     if fh.segmentation_enabled
                     else ((0,) * 8, tuple((0,) * 8 for _ in range(8))))
        for slot in range(8):
            if fh.refresh_frame_flags & (1 << slot):
                state["order_hints"][slot] = fh.order_hint
                state["deltas"][slot] = (fh.ref_deltas, fh.mode_deltas)
                state["gm"][slot] = fh.gm_params
                state["seg"][slot] = seg_store
                state["sizes"][slot] = (
                    dec.upscaled_width, fh.frame_height,
                    fh.render_width, fh.render_height)


def decode_ivf(path: str, max_frames: int | None = None,
               max_temporal_layer: int | None = None,
               max_spatial_layer: int | None = None,
               tile_workers: int = 0):
    """Decode frames of an IVF file; returns list of (y, u, v).
    max_temporal_layer / max_spatial_layer: decode only OBUs with
    temporal_id / spatial_id <= N (SVC operating-point selection).
    tile_workers > 1: within-frame tile-parallel decode (bit-identical
    to serial; decode_tiles_mt analog)."""
    from ..bitstream.ivf import read_ivf
    sh = None
    state = {"slots": [None] * 8}
    if max_temporal_layer is not None:
        state["max_tid"] = max_temporal_layer
    if max_spatial_layer is not None:
        state["max_sid"] = max_spatial_layer
    if tile_workers > 1:
        state["tile_workers"] = tile_workers
    out = []
    for payload, _pts in read_ivf(path):
        frames, sh = decode_frame_obus(payload, sh, state)
        out.extend(frames)
        if max_frames is not None and len(out) >= max_frames:
            break
    return out


def decode_single_tile(data: bytes, tile_idx: int,
                       sh: H.SequenceHeader | None = None):
    """Large-scale-tile-style tile random access (the lightfield
    property: examples/lightfield_decoder.c + av1_ext_tile_test.cc
    analog): decode ONLY tile `tile_idx` of a self-contained intra
    frame.  The other tiles' payloads are skipped by their size fields
    — no entropy decode, the defining cost property of
    large_scale_tile streams (av1/common/enums.h:55).

    Returns ((y, u, v) tile pixel planes, (row0_px, col0_px), sh).
    Requires in-loop filters off (the large-scale-tile operating
    constraint; our multi-tile lossless encoder satisfies it)."""
    from ..bitstream.bits import BitReader
    for obu_type, payload, _tid, _sid in H.split_obus_ext(data):
        if obu_type == c.OBU_SEQUENCE_HEADER:
            sh = H.parse_sequence_header(payload)
        elif obu_type == c.OBU_FRAME:
            assert sh is not None
            state = {"slots": [None] * 8}
            fh, endbit = H.parse_frame_header(payload, sh,
                                              ref_state=state)
            assert fh.is_intra, "tile random access needs intra frames"
            assert fh.filter_level[0] == 0 and not sh.enable_cdef \
                and not sh.enable_restoration, \
                "large-scale-tile streams run with in-loop filters off"
            sess = _FrameSession(sh, fh, state)
            assert 0 <= tile_idx < sess.n_tiles
            tg = payload[(endbit + 7) >> 3:]
            r = BitReader(tg)
            if sess.n_tiles > 1:
                sep = r.read_bit()
                if sep:
                    bits = fh.tile_cols_log2 + fh.tile_rows_log2
                    r.read_literal(bits)
                    r.read_literal(bits)
            pos = (r.bit_offset + 7) >> 3
            tile_data = None
            for tn in range(sess.n_tiles):
                if tn == sess.n_tiles - 1:
                    size = len(tg) - pos
                else:
                    size = int.from_bytes(
                        tg[pos:pos + fh.tile_size_bytes], "little") + 1
                    pos += fh.tile_size_bytes
                if tn == tile_idx:
                    tile_data = tg[pos:pos + size]
                    break
                pos += size
            assert tile_data, "tile payload missing"
            dec = sess.dec
            trow, tcol = divmod(tile_idx, sess.tile_cols)
            dec.decode_tile_data(tile_data, trow, tcol)
            r0, r1 = dec.tile_row_range(trow)
            c0, c1 = dec.tile_col_range(tcol)
            y0, y1 = r0 * 4, min(r1 * 4, sh.max_frame_height)
            x0, x1 = c0 * 4, min(c1 * 4, sh.max_frame_width)
            planes = dec.output()
            out = [np.asarray(planes[0])[y0:y1, x0:x1]]
            for p in planes[1:]:
                if p is None:
                    continue
                ss_x, ss_y = sh.subsampling_x, sh.subsampling_y
                out.append(np.asarray(p)[y0 >> ss_y:(y1 + ss_y) >> ss_y,
                                         x0 >> ss_x:(x1 + ss_x) >> ss_x])
            return tuple(out), (y0, x0), sh
    raise CorruptFrameError("no frame OBU in payload")
