"""Inter-frame decode: mode info, MV decode, variable tx sizes, motion
compensation and residual reconstruction.

Mixed into FrameDecoder.  Normative behavior per the reference call stack:
av1/decoder/decodemv.c:1511 read_inter_frame_mode_info, :1272
read_inter_block_mode_info, :885 read_mv, decodeframe.c:1015
read_tx_size_vartx / :1080 read_selected_tx_size, reconinter_template.inc
build_inter_predictors.

Current scope: single + compound references (incl. skip-mode, interintra,
wedge/dist-wtd masked compound), translation, OBMC and warped motion,
global motion, segmentation, and intraBC (bilinear MC from the current
frame's in-progress recon).
"""

from __future__ import annotations

import numpy as np

from ..bitstream import constants as c
from ..bitstream import headers as H
from ..common import blockd
from ..common import coeffs as CF
from ..common import interpred as IP
from ..common import mvref as MR
from ..common import txtype as TT

MAX_VARTX_DEPTH = 2

SUB_TX_SIZE_MAP = [0, 0, 1, 2, 3, 0, 0, 1, 1, 2, 2, 3, 3, 5, 6, 7, 8, 9, 10]

# common_data.h size_group_lookup
SIZE_GROUP = [0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 3, 3, 3, 3,
              0, 0, 1, 1, 2, 2]

# blockd.h bsize_to_max_depth / bsize_to_tx_size_cat (depth table - 1)
_MAX_DEPTH = [0, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
              2, 2, 2, 2, 2, 2]
_TX_SIZE_CAT = [-1, 0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 3, 3, 3,
                1, 1, 2, 2, 3, 3]


def _sqr_tx_of_dim(d: int) -> int:
    if d >= 64:
        return c.TX_64X64
    return {32: c.TX_32X32, 16: c.TX_16X16, 8: c.TX_8X8}.get(d, c.TX_4X4)


def depth_to_tx_size(depth: int, bsize: int) -> int:
    tx = blockd.max_tx_size_rect(bsize)
    for _ in range(depth):
        tx = SUB_TX_SIZE_MAP[tx]
    return tx


class InterDecoderMixin:
    """Inter-frame pieces of FrameDecoder (decoder.py)."""

    # --- mode info --------------------------------------------------------

    def _decode_inter_frame_block(self, ts, rd, bi, mi_row, mi_col, bsize,
                                  up_avail, left_avail, above_mi, left_mi):
        """read_inter_frame_mode_info (decodemv.c:1511)."""
        fc = ts.fc
        fh = self.fh
        g = self.g

        self._read_inter_segment_id(ts, rd, bi, mi_row, mi_col, 1)

        # skip mode (read_skip_mode, decodemv.c:421)
        bi.skip_mode = 0
        if fh.skip_mode_flag and not (
                self.seg_active(bi.segment_id, 6)
                or self.seg_active(bi.segment_id, 5)
                or self.seg_active(bi.segment_id, 7)):
            if min(blockd.block_wide(bsize), blockd.block_high(bsize)) >= 8:
                ctx = MR.skip_mode_ctx(g, mi_row, mi_col, up_avail,
                                       left_avail, self.skip_mode_grid)
                bi.skip_mode = rd.decode_symbol_adapt(
                    fc.skip_mode_cdfs[ctx], 2)
        # skip_mode blocks: compound NEAREST_NEARESTMV with derived refs

        # skip_txfm
        if bi.skip_mode:
            bi.skip_txfm = 1
        elif self.seg_active(bi.segment_id, 6):  # SEG_LVL_SKIP
            bi.skip_txfm = 1
        else:
            skip_ctx = (above_mi.skip_txfm if above_mi else 0) + \
                       (left_mi.skip_txfm if left_mi else 0)
            bi.skip_txfm = rd.decode_symbol_adapt(
                fc.skip_txfm_cdfs[skip_ctx], 2)

        if not fh.seg_preskip:
            self._read_inter_segment_id(ts, rd, bi, mi_row, mi_col, 0)

        self._read_cdef(rd, bi, mi_row, mi_col)
        self._read_delta_q_params(ts, rd, bi, mi_row, mi_col)

        # is_inter (read_is_inter_block, decodemv.c:1222)
        if bi.skip_mode:
            bi.is_inter = 1
        elif self.seg_active(bi.segment_id, 5):  # SEG_LVL_REF_FRAME
            frame = self.seg_data(bi.segment_id, 5)
            bi.is_inter = int(frame >= c.LAST_FRAME)
        elif self.seg_active(bi.segment_id, 7):  # SEG_LVL_GLOBALMV
            bi.is_inter = 1
        else:
            ctx = MR.intra_inter_ctx(g, mi_row, mi_col, up_avail,
                                     left_avail)
            bi.is_inter = rd.decode_symbol_adapt(fc.intra_inter_cdf[ctx], 2)

        if bi.is_inter:
            self._read_inter_block_mode_info(ts, rd, bi, mi_row, mi_col,
                                             bsize, up_avail, left_avail)
        else:
            self._read_intra_in_inter_mode_info(ts, rd, bi, mi_row, mi_col,
                                                bsize, above_mi, left_mi)

    def _read_intra_in_inter_mode_info(self, ts, rd, bi, mi_row, mi_col,
                                       bsize, above_mi=None, left_mi=None):
        """read_intra_block_mode_info (decodemv.c:1064): like the keyframe
        path but y mode uses y_mode_cdf[size group].  Screen-content
        inter frames carry palette syntax for intra blocks too
        (av1_allow_palette is frame-type independent)."""
        from ..common import intra
        fc = ts.fc
        bi.ref_frame = (c.INTRA_FRAME, -1)
        bi.y_mode = rd.decode_symbol_adapt(
            fc.y_mode_cdf[SIZE_GROUP[bsize]], c.INTRA_MODES)
        use_angle_delta = bsize >= c.BLOCK_8X8
        if use_angle_delta and intra.is_directional(bi.y_mode):
            bi.angle_delta_y = rd.decode_symbol_adapt(
                fc.angle_delta_cdf[bi.y_mode - c.V_PRED], 7) - 3
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
                    fc.angle_delta_cdf[bi.uv_mode - c.V_PRED], 7) - 3
        if self._allow_palette(bsize):
            self._read_palette_mode_info(ts, rd, bi, mi_row, mi_col,
                                         bsize, above_mi, left_mi,
                                         is_chroma_ref)
        if self._filter_intra_allowed(bi):
            if rd.decode_symbol_adapt(fc.filter_intra_cdfs[bsize], 2):
                bi.filter_intra_mode = rd.decode_symbol_adapt(
                    fc.filter_intra_mode_cdf, c.FILTER_INTRA_MODES)
        self._visit_palette(ts, rd, bi, mi_row, mi_col, bsize,
                            is_chroma_ref)

    def _read_ref_frames(self, ts, rd, bi, counts, g, mi_row, mi_col,
                         up, left):
        """read_ref_frames (decodemv.c:937), single-reference branch."""
        fc = ts.fc
        if bi.skip_mode:
            bi.ref_frame = (self.fh.skip_mode_refs[0],
                            self.fh.skip_mode_refs[1])
            return
        if self.seg_active(bi.segment_id, 5):   # SEG_LVL_REF_FRAME
            bi.ref_frame = (self.seg_data(bi.segment_id, 5), -1)
            return
        if self.seg_active(bi.segment_id, 6) or \
                self.seg_active(bi.segment_id, 7):  # SKIP / GLOBALMV
            bi.ref_frame = (c.LAST_FRAME, -1)
            return
        comp_allowed = min(blockd.block_wide(bi.bsize),
                           blockd.block_high(bi.bsize)) >= 8
        if (self.fh.reference_mode == c.REFERENCE_MODE_SELECT
                and comp_allowed):
            ctx = self._reference_mode_ctx(g, mi_row, mi_col, up, left)
            is_comp = rd.decode_symbol_adapt(fc.comp_inter_cdf[ctx], 2)
            if is_comp:
                self._read_comp_ref_frames(ts, rd, bi, counts, g, mi_row,
                                           mi_col, up, left)
                return
        bit0 = rd.decode_symbol_adapt(
            fc.single_ref_cdf[MR.ctx_single_ref_p1(counts)][0], 2)
        if bit0:
            bit1 = rd.decode_symbol_adapt(
                fc.single_ref_cdf[MR.ctx_single_ref_p2(counts)][1], 2)
            if not bit1:
                bit5 = rd.decode_symbol_adapt(
                    fc.single_ref_cdf[MR.ctx_single_ref_p6(counts)][5], 2)
                ref = c.ALTREF2_FRAME if bit5 else c.BWDREF_FRAME
            else:
                ref = c.ALTREF_FRAME
        else:
            bit2 = rd.decode_symbol_adapt(
                fc.single_ref_cdf[MR.ctx_single_ref_p3(counts)][2], 2)
            if bit2:
                bit4 = rd.decode_symbol_adapt(
                    fc.single_ref_cdf[MR.ctx_single_ref_p5(counts)][4], 2)
                ref = c.GOLDEN_FRAME if bit4 else c.LAST3_FRAME
            else:
                bit3 = rd.decode_symbol_adapt(
                    fc.single_ref_cdf[MR.ctx_single_ref_p4(counts)][3], 2)
                ref = c.LAST2_FRAME if bit3 else c.LAST_FRAME
        bi.ref_frame = (ref, -1)

    def _read_comp_ref_frames(self, ts, rd, bi, counts, g, mi_row, mi_col,
                              up, left):
        """Compound branch of read_ref_frames (decodemv.c:956)."""
        fc = ts.fc
        ctx = self._comp_ref_type_ctx(g, mi_row, mi_col, up, left)
        comp_ref_type = rd.decode_symbol_adapt(fc.comp_ref_type_cdf[ctx], 2)
        if comp_ref_type == 0:  # UNIDIR_COMP_REFERENCE
            bit = rd.decode_symbol_adapt(
                fc.uni_comp_ref_cdf[MR.ctx_single_ref_p1(counts)][0], 2)
            if bit:
                bi.ref_frame = (c.BWDREF_FRAME, c.ALTREF_FRAME)
                return
            bit1 = rd.decode_symbol_adapt(
                fc.uni_comp_ref_cdf[self._uni_p1_ctx(counts)][1], 2)
            if bit1:
                bit2 = rd.decode_symbol_adapt(
                    fc.uni_comp_ref_cdf[MR.ctx_single_ref_p5(counts)][2], 2)
                bi.ref_frame = (c.LAST_FRAME,
                                c.GOLDEN_FRAME if bit2 else c.LAST3_FRAME)
            else:
                bi.ref_frame = (c.LAST_FRAME, c.LAST2_FRAME)
            return
        # BIDIR
        bit = rd.decode_symbol_adapt(
            fc.comp_ref_cdf[MR.ctx_single_ref_p3(counts)][0], 2)
        if not bit:
            bit1 = rd.decode_symbol_adapt(
                fc.comp_ref_cdf[MR.ctx_single_ref_p4(counts)][1], 2)
            rf0 = c.LAST2_FRAME if bit1 else c.LAST_FRAME
        else:
            bit2 = rd.decode_symbol_adapt(
                fc.comp_ref_cdf[MR.ctx_single_ref_p5(counts)][2], 2)
            rf0 = c.GOLDEN_FRAME if bit2 else c.LAST3_FRAME
        bit_bwd = rd.decode_symbol_adapt(
            fc.comp_bwdref_cdf[MR.ctx_single_ref_p2(counts)][0], 2)
        if not bit_bwd:
            bit1_bwd = rd.decode_symbol_adapt(
                fc.comp_bwdref_cdf[MR.ctx_single_ref_p6(counts)][1], 2)
            rf1 = c.ALTREF2_FRAME if bit1_bwd else c.BWDREF_FRAME
        else:
            rf1 = c.ALTREF_FRAME
        bi.ref_frame = (rf0, rf1)

    @staticmethod
    def _uni_p1_ctx(counts):
        """av1_get_pred_context_uni_comp_ref_p1: LAST2 vs LAST3+GOLDEN."""
        last2 = int(counts[c.LAST2_FRAME])
        l3g = int(counts[c.LAST3_FRAME] + counts[c.GOLDEN_FRAME])
        return 1 if last2 == l3g else (0 if last2 < l3g else 2)

    def _comp_ref_type_ctx(self, g, mi_row, mi_col, up, left):
        """av1_get_comp_reference_type_context (pred_common.c:187)."""
        def info(r, col):
            m = g.m
            return (int(g.ref0[r + m, col + m]), int(g.ref1[r + m, col + m]))

        def is_bwd(r0):
            return c.BWDREF_FRAME <= r0 <= c.ALTREF_FRAME

        def uni(r0, r1):
            # has_uni_comp_refs: both refs on the same side
            return r1 > c.INTRA_FRAME and not (is_bwd(r1) and not is_bwd(r0))
        if up and left:
            a0, a1 = info(mi_row - 1, mi_col)
            l0, l1 = info(mi_row, mi_col - 1)
            a_intra = a0 <= c.INTRA_FRAME
            l_intra = l0 <= c.INTRA_FRAME
            if a_intra and l_intra:
                return 2
            if a_intra or l_intra:
                e0, e1 = (l0, l1) if a_intra else (a0, a1)
                if e1 <= c.INTRA_FRAME:
                    return 2
                return 1 + 2 * int(uni(e0, e1))
            a_sg = a1 <= c.INTRA_FRAME
            l_sg = l1 <= c.INTRA_FRAME
            if a_sg and l_sg:
                return 1 + 2 * int(not (is_bwd(a0) ^ is_bwd(l0)))
            if a_sg or l_sg:
                uni_rfc = uni(l0, l1) if a_sg else uni(a0, a1)
                if not uni_rfc:
                    return 1
                return 3 + int(not (is_bwd(a0) ^ is_bwd(l0)))
            a_uni = uni(a0, a1)
            l_uni = uni(l0, l1)
            if not a_uni and not l_uni:
                return 0
            if not a_uni or not l_uni:
                return 2
            return 3 + int(not ((a0 == c.BWDREF_FRAME)
                                ^ (l0 == c.BWDREF_FRAME)))
        if up or left:
            e0, e1 = info(mi_row - 1, mi_col) if up else info(mi_row,
                                                             mi_col - 1)
            if e0 <= c.INTRA_FRAME:
                return 2
            if e1 <= c.INTRA_FRAME:
                return 2
            return 4 * int(uni(e0, e1))
        return 2

    def _comp_group_idx_ctx(self, mi_row, mi_col, up, left):
        """get_comp_group_idx_context (pred_common.h:141)."""
        a = l = 0
        if up:
            nb = self.mi[mi_row - 1, mi_col]
            if nb.ref_frame[1] > c.INTRA_FRAME:
                a = getattr(nb, "comp_group_idx", 0)
            elif nb.ref_frame[0] == c.ALTREF_FRAME:
                a = 3
        if left:
            nb = self.mi[mi_row, mi_col - 1]
            if nb.ref_frame[1] > c.INTRA_FRAME:
                l = getattr(nb, "comp_group_idx", 0)
            elif nb.ref_frame[0] == c.ALTREF_FRAME:
                l = 3
        return min(5, a + l)

    def _comp_index_ctx(self, bi, mi_row, mi_col, up, left):
        """get_comp_index_context (pred_common.h:102)."""
        cur = self.fh.order_hint
        bck_h = self.ref_hints[bi.ref_frame[0]]
        fwd_h = self.ref_hints[bi.ref_frame[1]]
        fwd = abs(H.get_relative_dist(self.sh, fwd_h, cur))
        bck = abs(H.get_relative_dist(self.sh, cur, bck_h))
        offset = int(fwd == bck)
        a = l = 0
        if up:
            nb = self.mi[mi_row - 1, mi_col]
            if nb.ref_frame[1] > c.INTRA_FRAME:
                a = getattr(nb, "compound_idx", 1)
            elif nb.ref_frame[0] == c.ALTREF_FRAME:
                a = 1
        if left:
            nb = self.mi[mi_row, mi_col - 1]
            if nb.ref_frame[1] > c.INTRA_FRAME:
                l = getattr(nb, "compound_idx", 1)
            elif nb.ref_frame[0] == c.ALTREF_FRAME:
                l = 1
        return a + l + 3 * offset

    def _reference_mode_ctx(self, g, mi_row, mi_col, up, left):
        """av1_get_reference_mode_context (pred_common.c:145)."""
        def info(r, col):
            m = g.m
            r0 = int(g.ref0[r + m, col + m])
            r1 = int(g.ref1[r + m, col + m])
            return r0, r1
        def is_bwd(r0):
            return c.BWDREF_FRAME <= r0 <= c.ALTREF_FRAME
        if up and left:
            a0, a1 = info(mi_row - 1, mi_col)
            l0, l1 = info(mi_row, mi_col - 1)
            a_comp = a1 > c.INTRA_FRAME
            l_comp = l1 > c.INTRA_FRAME
            if not a_comp and not l_comp:
                return int(is_bwd(a0) ^ is_bwd(l0))
            if not a_comp:
                return 2 + int(is_bwd(a0) or a0 <= c.INTRA_FRAME)
            if not l_comp:
                return 2 + int(is_bwd(l0) or l0 <= c.INTRA_FRAME)
            return 4
        if up or left:
            e0, e1 = info(mi_row - 1, mi_col) if up else info(mi_row,
                                                             mi_col - 1)
            if e1 <= c.INTRA_FRAME:
                return int(is_bwd(e0))
            return 3
        return 1

    def _read_inter_block_mode_info(self, ts, rd, bi, mi_row, mi_col, bsize,
                                    up_avail, left_avail):
        fc = ts.fc
        fh = self.fh
        g = self.g
        counts = MR.neighbors_ref_counts(g, mi_row, mi_col, up_avail,
                                         left_avail)
        self._read_ref_frames(ts, rd, bi, counts, g, mi_row, mi_col,
                              up_avail, left_avail)
        ref = bi.ref_frame[0]
        is_compound = bi.ref_frame[1] > c.INTRA_FRAME

        ctx = MR.RefMvContext(
            g, mi_row, mi_col, bsize, self.sb_mi,
            ts.mi_row_start, ts.mi_row_end, ts.mi_col_start, ts.mi_col_end,
            bi.partition)
        rf_key = bi.ref_frame if is_compound else ref
        bw, bh = blockd.block_wide(bsize), blockd.block_high(bsize)
        gm_mv0 = MR.gm_get_motion_vector(
            self.gm[ref], fh.allow_high_precision_mv, bw, bh,
            mi_col, mi_row, fh.force_integer_mv)
        gm_mv1 = (0, 0)
        if is_compound:
            gm_mv1 = MR.gm_get_motion_vector(
                self.gm[bi.ref_frame[1]], fh.allow_high_precision_mv,
                bw, bh, mi_col, mi_row, fh.force_integer_mv)
        gm_info = {"mv": (gm_mv0, gm_mv1),
                   "types": [e[0] for e in self.gm]}
        stack, weights, count, mode_ctx, mv_list = MR.find_mv_refs(
            ctx, rf_key, sign_bias=self.sign_bias, tmvp=self.tmvp,
            gm=gm_info)

        allow_hp = fh.allow_high_precision_mv
        force_int = fh.force_integer_mv
        bi.ref_mv_idx = 0

        if bi.skip_mode:
            bi.mode = MR.NEAREST_NEARESTMV
        elif (self.seg_active(bi.segment_id, 6)
                or self.seg_active(bi.segment_id, 7)):
            bi.mode = MR.GLOBALMV
        elif is_compound:
            newmv_ctx = mode_ctx & MR.NEWMV_CTX_MASK
            refmv_ctx = (mode_ctx >> MR.REFMV_OFFSET) & MR.REFMV_CTX_MASK
            comp_ctx = MR.COMPOUND_MODE_CTX_MAP[refmv_ctx >> 1][
                min(newmv_ctx, 4)]
            sym = rd.decode_symbol_adapt(
                fc.inter_compound_mode_cdf[comp_ctx], 8)
            bi.mode = MR.NEAREST_NEARESTMV + sym
        else:
            newmv_ctx = mode_ctx & MR.NEWMV_CTX_MASK
            is_new = rd.decode_symbol_adapt(fc.newmv_cdf[newmv_ctx], 2) == 0
            if is_new:
                bi.mode = MR.NEWMV
            else:
                zeromv_ctx = (mode_ctx >> MR.GLOBALMV_OFFSET) & \
                    MR.GLOBALMV_CTX_MASK
                if rd.decode_symbol_adapt(fc.zeromv_cdf[zeromv_ctx],
                                          2) == 0:
                    bi.mode = MR.GLOBALMV
                else:
                    refmv_ctx = (mode_ctx >> MR.REFMV_OFFSET) & \
                        MR.REFMV_CTX_MASK
                    if rd.decode_symbol_adapt(fc.refmv_cdf[refmv_ctx],
                                              2) == 0:
                        bi.mode = MR.NEARESTMV
                    else:
                        bi.mode = MR.NEARMV

        # drl index (decodemv.c:196)
        if not bi.skip_mode:
            if bi.mode in (MR.NEWMV, MR.NEW_NEWMV):
                for idx in range(2):
                    if count > idx + 1:
                        dctx = MR.drl_ctx(weights, idx)
                        drl = rd.decode_symbol_adapt(fc.drl_cdf[dctx], 2)
                        bi.ref_mv_idx = idx + drl
                        if not drl:
                            break
            elif MR.have_nearmv(bi.mode):
                for idx in range(1, 3):
                    if count > idx + 1:
                        dctx = MR.drl_ctx(weights, idx)
                        drl = rd.decode_symbol_adapt(fc.drl_cdf[dctx], 2)
                        bi.ref_mv_idx = idx + drl - 1
                        if not drl:
                            break

        prec = -1 if force_int else allow_hp
        if is_compound:
            if bi.mode != MR.GLOBAL_GLOBALMV:
                idx1 = bi.ref_mv_idx + 1
                nearest0 = MR.lower_mv_precision(stack[0][0], allow_hp,
                                                 force_int)
                nearest1 = MR.lower_mv_precision(stack[0][1], allow_hp,
                                                 force_int)
                if idx1 < count:
                    near0 = MR.lower_mv_precision(stack[idx1][0],
                                                  allow_hp, force_int)
                    near1 = MR.lower_mv_precision(stack[idx1][1],
                                                  allow_hp, force_int)
                else:
                    # only reachable for NEW-modes, which never use near
                    near0 = near1 = (0, 0)
            else:
                nearest0 = nearest1 = near0 = near1 = (0, 0)
            ref_mv0, ref_mv1 = nearest0, nearest1
            ref_mv_idx = bi.ref_mv_idx
            if bi.mode in (MR.NEAR_NEWMV, MR.NEW_NEARMV):
                ref_mv_idx = 1 + bi.ref_mv_idx
            if bi.mode in (MR.NEWMV, MR.NEW_NEWMV, MR.NEW_NEARESTMV,
                           MR.NEW_NEARMV):
                ref_mv0 = stack[ref_mv_idx][0]
            if bi.mode in (MR.NEW_NEWMV, MR.NEAREST_NEWMV, MR.NEAR_NEWMV):
                ref_mv1 = stack[ref_mv_idx][1]
            m = bi.mode
            if m == MR.NEW_NEWMV:
                mv0 = self._read_mv(ts, rd, ref_mv0, prec)
                mv1 = self._read_mv(ts, rd, ref_mv1, prec)
            elif m == MR.NEAREST_NEARESTMV:
                mv0, mv1 = nearest0, nearest1
            elif m == MR.NEAR_NEARMV:
                mv0, mv1 = near0, near1
            elif m == MR.NEW_NEARESTMV:
                mv0 = self._read_mv(ts, rd, ref_mv0, prec)
                mv1 = nearest1
            elif m == MR.NEAREST_NEWMV:
                mv0 = nearest0
                mv1 = self._read_mv(ts, rd, ref_mv1, prec)
            elif m == MR.NEAR_NEWMV:
                mv0 = near0
                mv1 = self._read_mv(ts, rd, ref_mv1, prec)
            elif m == MR.NEW_NEARMV:
                mv0 = self._read_mv(ts, rd, ref_mv0, prec)
                mv1 = near1
            else:  # GLOBAL_GLOBALMV
                mv0, mv1 = gm_mv0, gm_mv1
            bi.mv = (mv0, mv1)
        else:
            # nearest/near (av1_find_best_ref_mvs)
            nearest = MR.lower_mv_precision(mv_list[0], allow_hp, force_int)
            near = MR.lower_mv_precision(mv_list[1], allow_hp, force_int)
            if bi.ref_mv_idx > 0 and bi.mode == MR.NEARMV:
                near = stack[1 + bi.ref_mv_idx]

            if bi.mode == MR.NEWMV:
                ref_mv = nearest
                if count > 1:
                    ref_mv = stack[bi.ref_mv_idx]
                mv = self._read_mv(ts, rd, ref_mv, prec)
            elif bi.mode == MR.NEARESTMV:
                mv = nearest
            elif bi.mode == MR.NEARMV:
                mv = near
            else:  # GLOBALMV
                mv = gm_mv0
            bi.mv = (mv, (0, 0))
        for v in bi.mv[0] + bi.mv[1]:
            if not (-(1 << 13) < v < (1 << 13)):
                raise ValueError("corrupt MV")

        # interintra (decodemv.c:1382)
        bi.interintra = 0
        if (self.sh.enable_interintra_compound and not bi.skip_mode
                and not is_compound
                and c.BLOCK_8X8 <= bsize <= c.BLOCK_32X32
                and MR.NEARESTMV <= bi.mode <= MR.NEWMV):
            bsg = SIZE_GROUP[bsize]
            bi.interintra = rd.decode_symbol_adapt(
                fc.interintra_cdf[bsg], 2)
            if bi.interintra:
                bi.interintra_mode = rd.decode_symbol_adapt(
                    fc.interintra_mode_cdf[bsg], c.INTERINTRA_MODES)
                bi.ref_frame = (ref, c.INTRA_FRAME)
                bi.angle_delta_y = 0
                bi.angle_delta_uv = 0
                bi.filter_intra_mode = -1
                bi.use_wedge_interintra = 0
                if bsize in (c.BLOCK_8X8, c.BLOCK_8X16, c.BLOCK_16X8,
                             c.BLOCK_16X16, c.BLOCK_16X32, c.BLOCK_32X16,
                             c.BLOCK_32X32, c.BLOCK_8X32, c.BLOCK_32X8):
                    bi.use_wedge_interintra = rd.decode_symbol_adapt(
                        fc.wedge_interintra_cdf[bsize], 2)
                    if bi.use_wedge_interintra:
                        bi.interintra_wedge_index = rd.decode_symbol_adapt(
                            fc.wedge_idx_cdf[bsize], 16)

        # motion mode (decodemv.c:226 read_motion_mode); requires warp
        # sample search even when OBMC is chosen (gates WARPED vs OBMC)
        bi.motion_mode = 0
        bi.num_proj_ref = 0
        bi.wm = None
        if (blockd.block_wide(bsize) >= 8 and blockd.block_high(bsize) >= 8
                and not bi.skip_mode and not is_compound):
            bi.num_proj_ref, pts, pts_inref = self._find_samples(
                ts, bi, mi_row, mi_col, bsize)
        if fh.is_motion_mode_switchable and not bi.skip_mode \
                and not is_compound and not bi.interintra:
            allowed = self._motion_mode_allowed(ts, bi, mi_row, mi_col,
                                                bsize, up_avail, left_avail)
            if allowed == c.OBMC_CAUSAL:
                bi.motion_mode = rd.decode_symbol_adapt(
                    fc.obmc_cdf[bsize], 2)
            elif allowed == c.WARPED_CAUSAL:
                bi.motion_mode = rd.decode_symbol_adapt(
                    fc.motion_mode_cdf[bsize], 3)

        # compound group / index (decodemv.c:1428)
        bi.comp_group_idx = 0
        bi.compound_idx = 1
        if is_compound and not bi.skip_mode:
            comp_allowed = min(blockd.block_wide(bsize),
                               blockd.block_high(bsize)) >= 8
            masked_used = comp_allowed and self.sh.enable_masked_compound
            if masked_used:
                gctx = self._comp_group_idx_ctx(mi_row, mi_col, up_avail,
                                                left_avail)
                bi.comp_group_idx = rd.decode_symbol_adapt(
                    fc.comp_group_idx_cdf[gctx], 2)
            if bi.comp_group_idx == 0:
                if self.sh.enable_jnt_comp:
                    ictx = self._comp_index_ctx(bi, mi_row, mi_col,
                                                up_avail, left_avail)
                    bi.compound_idx = rd.decode_symbol_adapt(
                        fc.compound_index_cdf[ictx], 2)
            else:
                # masked compound (decodemv.c:1458): wedge or diffwtd
                wedge_used = bsize in (c.BLOCK_8X8, c.BLOCK_8X16,
                                       c.BLOCK_16X8, c.BLOCK_16X16,
                                       c.BLOCK_16X32, c.BLOCK_32X16,
                                       c.BLOCK_32X32, c.BLOCK_8X32,
                                       c.BLOCK_32X8)
                if wedge_used:
                    bi.comp_type = 1 + rd.decode_symbol_adapt(
                        fc.compound_type_cdf[bsize], 2)  # WEDGE=1/DIFFWTD=2
                else:
                    bi.comp_type = 2
                if bi.comp_type == 1:
                    bi.wedge_index = rd.decode_symbol_adapt(
                        fc.wedge_idx_cdf[bsize], 16)
                    bi.wedge_sign = rd.decode_bit()
                else:
                    bi.mask_type = rd.decode_literal(1)
        # interp filter (decodemv.c:1033)
        if fh.interpolation_filter == c.SWITCHABLE:
            if self._interp_needed(bi):
                filts = []
                for d in range(2):
                    ictx = self._interp_filter_ctx(g, mi_row, mi_col,
                                                   up_avail, left_avail,
                                                   d, ref)
                    if is_compound:
                        ictx += 4  # INTER_FILTER_COMP_OFFSET
                    filts.append(rd.decode_symbol_adapt(
                        fc.switchable_interp_cdf[ictx],
                        c.SWITCHABLE_FILTERS))
                    if not self.sh.enable_dual_filter:
                        filts.append(filts[0])
                        break
                # read order: dir0 = vertical (y), dir1 = horizontal (x)
                bi.interp_filter = (filts[1], filts[0])  # (x, y)
            else:
                bi.interp_filter = (c.EIGHTTAP_REGULAR, c.EIGHTTAP_REGULAR)
        else:
            f = fh.interpolation_filter
            bi.interp_filter = (f, f)

        if bi.motion_mode == c.WARPED_CAUSAL:
            from ..common import warp as WP
            np_ref = bi.num_proj_ref
            if np_ref > 1:
                np_ref = WP.select_samples(
                    bi.mv[0][0], bi.mv[0][1], pts, pts_inref, np_ref,
                    blockd.block_wide(bsize), blockd.block_high(bsize))
            ok, mat, alpha, beta, gamma, delta = WP.find_projection(
                np_ref, pts, pts_inref, blockd.block_wide(bsize),
                blockd.block_high(bsize), bi.mv[0][0], bi.mv[0][1],
                mi_row, mi_col)
            bi.wm = (mat, alpha, beta, gamma, delta) if ok else None

    def _motion_mode_allowed(self, ts, bi, mi_row, mi_col, bsize, up_avail,
                             left_avail):
        """motion_mode_allowed (reconinter.h): gates the symbol read."""
        if blockd.block_wide(bsize) < 8 or blockd.block_high(bsize) < 8:
            return c.SIMPLE_TRANSLATION
        # global-mv blocks with non-translational gm stay simple
        if (not self.fh.force_integer_mv and MR.is_global_mv_block(
                bi.mode, bsize, self.gm[bi.ref_frame[0]][0])):
            return c.SIMPLE_TRANSLATION
        if not self._has_overlappable_neighbor(bi, mi_row, mi_col, bsize,
                                               up_avail, left_avail):
            return c.SIMPLE_TRANSLATION
        if (bi.num_proj_ref >= 1 and self.fh.allow_warped_motion
                and not self.fh.force_integer_mv
                and not IP.is_scaled(self._ref_sf(bi.ref_frame[0]))):
            return c.WARPED_CAUSAL
        return c.OBMC_CAUSAL

    def _nb_obmc(self, r, cc):
        """Neighbor info for OBMC scans; the encoder overrides this to
        read its array mi grid instead of BlockInfo objects."""
        return self.mi[r, cc]

    def _overlappable_above(self, mi_row, mi_col, w4, nb_max):
        """foreach_overlappable_nb_above (obmc.h:20): yields (nb, rel, op)
        for overlappable (inter) above neighbors, pair-adjusted for
        width-4 blocks."""
        if mi_row <= 0:
            return
        end_col = min(mi_col + w4, self.mi_cols)
        count = 0
        acol = mi_col
        while acol < end_col and count < nb_max:
            nb = self._nb_obmc(mi_row - 1, acol)
            step = min(blockd.mi_size_wide(nb.bsize), 16)
            if step == 1:
                acol &= ~1
                nb = self._nb_obmc(mi_row - 1, acol + 1)
                step = 2
            if nb.is_inter:
                count += 1
                yield nb, acol - mi_col, min(w4, step)
            acol += step

    def _overlappable_left(self, mi_row, mi_col, h4, nb_max):
        if mi_col <= 0:
            return
        end_row = min(mi_row + h4, self.mi_rows)
        count = 0
        arow = mi_row
        while arow < end_row and count < nb_max:
            nb = self._nb_obmc(arow, mi_col - 1)
            step = min(blockd.mi_size_high(nb.bsize), 16)
            if step == 1:
                arow &= ~1
                nb = self._nb_obmc(arow + 1, mi_col - 1)
                step = 2
            if nb.is_inter:
                count += 1
                yield nb, arow - mi_row, min(h4, step)
            arow += step

    def _has_overlappable_neighbor(self, bi, mi_row, mi_col, bsize,
                                   up_avail, left_avail):
        """av1_count_overlappable_neighbors != 0 (pair-adjusted scan)."""
        w4 = blockd.mi_size_wide(bsize)
        h4 = blockd.mi_size_high(bsize)
        if up_avail:
            for _ in self._overlappable_above(mi_row, mi_col, w4, 1 << 30):
                return True
        if left_avail:
            for _ in self._overlappable_left(mi_row, mi_col, h4, 1 << 30):
                return True
        return False

    def _find_samples(self, ts, bi, mi_row, mi_col, bsize):
        """av1_findSamples (mvref_common.c:1109); returns (np, pts,
        pts_inref) with 1/8-pel coords relative to the block top-left."""
        g = self.g
        m = g.m
        ref_frame = bi.ref_frame[0]
        w4 = blockd.mi_size_wide(bsize)
        h4 = blockd.mi_size_high(bsize)
        # availability is TILE-scoped (libaom xd->up_available via
        # set_mi_row_col with tile bounds); ts is None on the encoder's
        # single-tile path
        row_start = ts.mi_row_start if ts is not None else 0
        col_start = ts.mi_col_start if ts is not None else 0
        row_end = ts.mi_row_end if ts is not None else self.mi_rows
        col_end = ts.mi_col_end if ts is not None else self.mi_cols
        up = mi_row > row_start
        left = mi_col > col_start
        pts = [0] * 16
        pts_inref = [0] * 16
        np_ = 0
        do_tl = True
        do_tr = True

        def cand(r, cc):
            return (int(g.ref0[r + m, cc + m]), int(g.ref1[r + m, cc + m]),
                    int(g.bsize[r + m, cc + m]),
                    g.mv[r + m, cc + m, 0])

        def record(nb_bsize, nb_mv, row_off, sign_r, col_off, sign_c):
            nonlocal np_
            bw = blockd.block_wide(nb_bsize)
            bh = blockd.block_high(nb_bsize)
            x = col_off * 4 + sign_c * bw // 2 - 1
            y = row_off * 4 + sign_r * bh // 2 - 1
            pts[2 * np_] = x * 8
            pts[2 * np_ + 1] = y * 8
            pts_inref[2 * np_] = x * 8 + int(nb_mv[1])
            pts_inref[2 * np_ + 1] = y * 8 + int(nb_mv[0])
            np_ += 1

        if up:
            r0, r1, nb_bs, nb_mv = cand(mi_row - 1, mi_col)
            sbw = blockd.mi_size_wide(nb_bs)
            if w4 <= sbw:
                col_off = -(mi_col % sbw)
                if col_off < 0:
                    do_tl = False
                if col_off + sbw > w4:
                    do_tr = False
                if r0 == ref_frame and r1 == -1:
                    record(nb_bs, nb_mv, 0, -1, col_off, 1)
                    if np_ >= 8:
                        return 8, pts, pts_inref
            else:
                i = 0
                while i < min(w4, self.mi_cols - mi_col):
                    r0, r1, nb_bs, nb_mv = cand(mi_row - 1, mi_col + i)
                    sbw = blockd.mi_size_wide(nb_bs)
                    if r0 == ref_frame and r1 == -1:
                        record(nb_bs, nb_mv, 0, -1, i, 1)
                        if np_ >= 8:
                            return 8, pts, pts_inref
                    i += sbw
        if left:
            r0, r1, nb_bs, nb_mv = cand(mi_row, mi_col - 1)
            sbh = blockd.mi_size_high(nb_bs)
            if h4 <= sbh:
                row_off = -(mi_row % sbh)
                if row_off < 0:
                    do_tl = False
                if r0 == ref_frame and r1 == -1:
                    record(nb_bs, nb_mv, row_off, 1, 0, -1)
                    if np_ >= 8:
                        return 8, pts, pts_inref
            else:
                i = 0
                while i < min(h4, self.mi_rows - mi_row):
                    r0, r1, nb_bs, nb_mv = cand(mi_row + i, mi_col - 1)
                    sbh = blockd.mi_size_high(nb_bs)
                    if r0 == ref_frame and r1 == -1:
                        record(nb_bs, nb_mv, i, 1, 0, -1)
                        if np_ >= 8:
                            return 8, pts, pts_inref
                    i += sbh
        if do_tl and left and up:
            r0, r1, nb_bs, nb_mv = cand(mi_row - 1, mi_col - 1)
            if r0 == ref_frame and r1 == -1:
                record(nb_bs, nb_mv, 0, -1, 0, -1)
                if np_ >= 8:
                    return 8, pts, pts_inref
        if do_tr:
            ctx = MR.RefMvContext(
                g, mi_row, mi_col, bsize, self.sb_mi, row_start, row_end,
                col_start, col_end, bi.partition)
            if MR._has_top_right(ctx) and \
                    row_start <= mi_row - 1 and mi_col + w4 < col_end:
                r0, r1, nb_bs, nb_mv = cand(mi_row - 1, mi_col + w4)
                if r0 == ref_frame and r1 == -1:
                    record(nb_bs, nb_mv, 0, -1, w4, 1)
                    if np_ >= 8:
                        return 8, pts, pts_inref
        return np_, pts, pts_inref

    def _interp_needed(self, bi) -> bool:
        """av1_is_interp_needed (reconinter.h:418): no interp filter for
        skip-mode, warped-causal, or nontrans-global-motion blocks
        (mode GLOBALMV/GLOBAL_GLOBALMV, >=8x8, no ref with a pure
        TRANSLATION model - IDENTITY counts as nontranslational)."""
        if bi.skip_mode:
            return False
        if getattr(bi, "motion_mode", 0) == c.WARPED_CAUSAL:
            return False
        if bi.mode in (MR.GLOBALMV, MR.GLOBAL_GLOBALMV):
            bsize = bi.bsize
            if (blockd.block_wide(bsize) >= 8
                    and blockd.block_high(bsize) >= 8):
                refs = [bi.ref_frame[0]]
                if bi.ref_frame[1] > c.INTRA_FRAME:
                    refs.append(bi.ref_frame[1])
                if all(self.gm[r][0] != c.TRANSLATION for r in refs):
                    return False
        return True

    def _interp_filter_ctx(self, g, mi_row, mi_col, up, left, d, ref):
        """av1_get_pred_context_switchable_interp (pred_common.c:30):
        dir 0 reads neighbors' y (vertical) filter, dir 1 the x filter;
        single-ref only (no comp offset)."""
        m = g.m
        left_type = c.SWITCHABLE_FILTERS
        above_type = c.SWITCHABLE_FILTERS
        if left:
            r0 = int(g.ref0[mi_row + m, mi_col - 1 + m])
            r1 = int(g.ref1[mi_row + m, mi_col - 1 + m])
            if r0 == ref or r1 == ref:
                left_type = int(
                    self.interp_grid[mi_row + m, mi_col - 1 + m, d])
        if up:
            r0 = int(g.ref0[mi_row - 1 + m, mi_col + m])
            r1 = int(g.ref1[mi_row - 1 + m, mi_col + m])
            if r0 == ref or r1 == ref:
                above_type = int(
                    self.interp_grid[mi_row - 1 + m, mi_col + m, d])
        if left_type == above_type:
            filter_type_ctx = left_type
        elif left_type == c.SWITCHABLE_FILTERS:
            filter_type_ctx = above_type
        elif above_type == c.SWITCHABLE_FILTERS:
            filter_type_ctx = left_type
        else:
            filter_type_ctx = c.SWITCHABLE_FILTERS
        return d * (c.SWITCHABLE_FILTERS + 1) * 2 + filter_type_ctx

    def _read_mv(self, ts, rd, ref_mv, precision, dv=False):
        """read_mv (decodemv.c:885); precision: -1 none, 0 low, 1 high.
        dv selects the intrabc ndvc context set (decodemv.c:677)."""
        fc = ts.fc
        joint = rd.decode_symbol_adapt(
            fc.ndv_joints_cdf if dv else fc.nmv_joints_cdf, 4)
        dr = dc = 0
        if joint in (2, 3):
            dr = self._read_mv_component(ts, rd, 0, precision >= 0,
                                         precision > 0, dv)
        if joint in (1, 3):
            dc = self._read_mv_component(ts, rd, 1, precision >= 0,
                                         precision > 0, dv)
        return (ref_mv[0] + dr, ref_mv[1] + dc)

    def _read_mv_component(self, ts, rd, comp, use_subpel, usehp, dv=False):
        fc = ts.fc
        pre = "ndv" if dv else "nmv"

        def f(name):
            return getattr(fc, f"{pre}_comp{comp}_{name}")
        sign = rd.decode_symbol_adapt(f("sign_cdf"), 2)
        mv_class = rd.decode_symbol_adapt(f("classes_cdf"), 11)
        class0 = mv_class == 0
        if class0:
            d = rd.decode_symbol_adapt(f("class0_cdf"), 2)
            mag = 0
        else:
            d = 0
            n = mv_class + 0  # CLASS0_BITS - 1 == 0 (entropymv.h)
            bits_cdf = f("bits_cdf")
            for i in range(n):
                d |= rd.decode_symbol_adapt(bits_cdf[i], 2) << i
            mag = 2 << (mv_class + 2)
        if use_subpel:
            fr = rd.decode_symbol_adapt(
                f("class0_fp_cdf")[d] if class0 else f("fp_cdf"), 4)
            hp = rd.decode_symbol_adapt(
                f("class0_hp_cdf") if class0 else f("hp_cdf"), 2) \
                if usehp else 1
        else:
            fr = 3
            hp = 1
        mag += ((d << 3) | (fr << 1) | hp) + 1
        return -mag if sign else mag

    # --- tx sizes ---------------------------------------------------------

    def _read_block_tx_size(self, ts, rd, bi, mi_row, mi_col):
        """parse_decode_block tx-size logic (decodeframe.c:1129)."""
        bsize = bi.bsize
        w4 = blockd.mi_size_wide(bsize)
        h4 = blockd.mi_size_high(bsize)
        bi.inter_leaves = None
        if self.lossless:
            bi.tx_size = c.TX_4X4
            return
        signals = bsize > c.BLOCK_4X4
        select = self.fh.tx_mode == c.TX_MODE_SELECT
        if select and signals and not bi.skip_txfm and bi.is_inter:
            max_tx = blockd.max_tx_size_rect(bsize)
            bh4 = c.TX_HEIGHT[max_tx] >> 2
            bw4 = c.TX_WIDTH[max_tx] >> 2
            bi.inter_leaves = []
            bi.tx_size = max_tx
            for idy in range(0, h4, bh4):
                for idx in range(0, w4, bw4):
                    self._read_tx_size_vartx(ts, rd, bi, max_tx, 0, idy, idx,
                                             mi_row, mi_col)
            return
        if signals and select and not bi.is_inter:
            bi.tx_size = self._read_selected_tx_size(ts, rd, bi, mi_row,
                                                     mi_col)
        elif signals:
            # TX_MODE_LARGEST, or inter skip under SELECT
            bi.tx_size = blockd.max_tx_size_rect(bsize)
        else:
            bi.tx_size = blockd.max_tx_size_rect(bsize)
        self._set_txfm_ctxs(ts, bi.tx_size, w4, h4,
                            bi.skip_txfm and bi.is_inter, mi_row, mi_col)

    def _set_txfm_ctxs(self, ts, tx_size, w4, h4, skip, mi_row, mi_col):
        bw = c.TX_WIDTH[tx_size]
        bh = c.TX_HEIGHT[tx_size]
        if skip:
            bw = w4 * 4
            bh = h4 * 4
        ts.above_txfm[mi_col:mi_col + w4] = bw
        ts.left_txfm[mi_row:mi_row + h4] = bh

    def _read_selected_tx_size(self, ts, rd, bi, mi_row, mi_col):
        """read_selected_tx_size (decodeframe.c:1080)."""
        bsize = bi.bsize
        cat = _TX_SIZE_CAT[bsize]
        max_depths = _MAX_DEPTH[bsize]
        ctx = self._tx_size_ctx(ts, bi, mi_row, mi_col)
        depth = rd.decode_symbol_adapt(ts.fc.tx_size_cdf[cat][ctx],
                                       max_depths + 1)
        return depth_to_tx_size(depth, bsize)

    def _tx_size_ctx(self, ts, bi, mi_row, mi_col):
        """get_tx_size_context (pred_common.h:342)."""
        g = self.g
        m = g.m
        max_tx = blockd.max_tx_size_rect(bi.bsize)
        max_w = c.TX_WIDTH[max_tx]
        max_h = c.TX_HEIGHT[max_tx]
        up = mi_row > ts.mi_row_start
        left = mi_col > ts.mi_col_start
        above = int(ts.above_txfm[mi_col]) >= max_w
        lft = int(ts.left_txfm[mi_row]) >= max_h
        if up and int(g.ref0[mi_row - 1 + m, mi_col + m]) > c.INTRA_FRAME:
            above = blockd.block_wide(
                int(g.bsize[mi_row - 1 + m, mi_col + m])) >= max_w
        if left and int(g.ref0[mi_row + m, mi_col - 1 + m]) > c.INTRA_FRAME:
            lft = blockd.block_high(
                int(g.bsize[mi_row + m, mi_col - 1 + m])) >= max_h
        if up and left:
            return int(above) + int(lft)
        if up:
            return int(above)
        if left:
            return int(lft)
        return 0

    def _txfm_partition_ctx(self, ts, bi, tx_size, mi_row, mi_col,
                            blk_row, blk_col):
        """txfm_partition_context (av1_common_int.h:1737)."""
        txw = c.TX_WIDTH[tx_size]
        txh = c.TX_HEIGHT[tx_size]
        above = int(ts.above_txfm[mi_col + blk_col]) < txw
        left = int(ts.left_txfm[mi_row + blk_row]) < txh
        if tx_size <= c.TX_4X4:
            return 0
        max_tx = _sqr_tx_of_dim(max(blockd.block_wide(bi.bsize),
                                    blockd.block_high(bi.bsize)))
        category = 21  # TXFM_PARTITION_CONTEXTS sentinel
        if max_tx >= c.TX_8X8:
            category = int(c.TX_SIZE_SQR_UP[tx_size] != max_tx
                           and max_tx > c.TX_8X8) + (5 - 1 - max_tx) * 2
        return category * 3 + above + left

    def _txfm_partition_update(self, ts, mi_row, mi_col, blk_row, blk_col,
                               tx_size, txb_size):
        bh = c.TX_HEIGHT[txb_size] >> 2
        bw = c.TX_WIDTH[txb_size] >> 2
        ts.above_txfm[mi_col + blk_col:mi_col + blk_col + bw] = \
            c.TX_WIDTH[tx_size]
        ts.left_txfm[mi_row + blk_row:mi_row + blk_row + bh] = \
            c.TX_HEIGHT[tx_size]

    def _read_tx_size_vartx(self, ts, rd, bi, tx_size, depth, blk_row,
                            blk_col, mi_row, mi_col):
        """read_tx_size_vartx (decodeframe.c:1015)."""
        bsize = bi.bsize
        # visible 4x4 units (max_block_high/max_block_wide)
        h4 = blockd.mi_size_high(bsize)
        w4 = blockd.mi_size_wide(bsize)
        if mi_row + h4 > self.mi_rows:
            h4 = self.mi_rows - mi_row
        if mi_col + w4 > self.mi_cols:
            w4 = self.mi_cols - mi_col
        if blk_row >= h4 or blk_col >= w4:
            return
        if depth == MAX_VARTX_DEPTH:
            bi.inter_leaves.append((blk_row, blk_col, tx_size))
            bi.tx_size = tx_size
            self._txfm_partition_update(ts, mi_row, mi_col, blk_row, blk_col,
                                        tx_size, tx_size)
            return
        ctx = self._txfm_partition_ctx(ts, bi, tx_size, mi_row, mi_col,
                                       blk_row, blk_col)
        is_split = rd.decode_symbol_adapt(ts.fc.txfm_partition_cdf[ctx], 2)
        if is_split:
            sub_txs = SUB_TX_SIZE_MAP[tx_size]
            bsw = c.TX_WIDTH[sub_txs] >> 2
            bsh = c.TX_HEIGHT[sub_txs] >> 2
            if sub_txs == c.TX_4X4:
                # whole current unit becomes 4x4 txbs (raster order;
                # decode_reconstruct_tx descends to each)
                for r in range(c.TX_HEIGHT[tx_size] >> 2):
                    for cc in range(c.TX_WIDTH[tx_size] >> 2):
                        bi.inter_leaves.append((blk_row + r, blk_col + cc,
                                                sub_txs))
                bi.tx_size = sub_txs
                self._txfm_partition_update(ts, mi_row, mi_col, blk_row,
                                            blk_col, sub_txs, tx_size)
                return
            for row in range(0, c.TX_HEIGHT[tx_size] >> 2, bsh):
                for col in range(0, c.TX_WIDTH[tx_size] >> 2, bsw):
                    self._read_tx_size_vartx(ts, rd, bi, sub_txs, depth + 1,
                                             blk_row + row, blk_col + col,
                                             mi_row, mi_col)
        else:
            bi.inter_leaves.append((blk_row, blk_col, tx_size))
            bi.tx_size = tx_size
            self._txfm_partition_update(ts, mi_row, mi_col, blk_row, blk_col,
                                        tx_size, tx_size)

    # --- reconstruction ---------------------------------------------------

    def _recon_inter_block(self, ts, rd, bi, mi_row, mi_col):
        bsize = bi.bsize
        self._predict_inter_block(bi, mi_row, mi_col)
        bw4 = blockd.mi_size_wide(bsize)
        bh4 = blockd.mi_size_high(bsize)
        is_chroma_ref = blockd.is_chroma_reference(
            mi_row, mi_col, bsize, self.ss_x, self.ss_y) \
            and self.num_planes > 1
        nplanes = self.num_planes if is_chroma_ref else 1
        mb_to_right = (self.mi_cols - bw4 - mi_col) * 4
        mb_to_bottom = (self.mi_rows - bh4 - mi_row) * 4

        # non-chroma-ref blocks store luma for a later CfL block in the
        # same chroma group (decodemv.c:1504 store_cfl_required)
        store_cfl = (self.num_planes > 1 and not is_chroma_ref)

        if bi.skip_txfm:
            if store_cfl:
                self._cfl_store_block(bi)
            # av1_reset_entropy_context
            for plane in range(nplanes):
                ss_x = self.ss_x if plane else 0
                ss_y = self.ss_y if plane else 0
                pb = blockd.plane_block_size(bsize, ss_x, ss_y) if plane \
                    else bsize
                acol = (mi_col >> ss_x) if plane else mi_col
                lrow = (mi_row >> ss_y) if plane else mi_row
                ts.above_entropy[plane][
                    acol:acol + (blockd.block_wide(pb) >> 2)] = 0
                ts.left_entropy[plane][
                    lrow:lrow + (blockd.block_high(pb) >> 2)] = 0
            return

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
                row0 = ((mi_row - (mi_row & ss_y)) * 4) >> ss_y if plane \
                    else mi_row * 4
                col0 = ((mi_col - (mi_col & ss_x)) * 4) >> ss_x if plane \
                    else mi_col * 4
                pbw = blockd.block_wide(plane_bsize)
                pbh = blockd.block_high(plane_bsize)
                vis_w = pbw + (min(mb_to_right, 0) >> ss_x)
                vis_h = pbh + (min(mb_to_bottom, 0) >> ss_y)
                max_cols4 = max(vis_w >> 2, 1)
                max_rows4 = max(vis_h >> 2, 1)
                cu_r0 = (cy * 64 >> ss_y) >> 2
                cu_c0 = (cx * 64 >> ss_x) >> 2
                cu_r1 = min(((cy + 1) * 64 >> ss_y) >> 2, max_rows4)
                cu_c1 = min(((cx + 1) * 64 >> ss_x) >> 2, max_cols4)
                if plane == 0 and bi.inter_leaves is not None:
                    units = [(r, cc, tx) for (r, cc, tx) in bi.inter_leaves
                             if cu_r0 <= r < cu_r1 and cu_c0 <= cc < cu_c1]
                else:
                    if self.lossless:
                        tx = c.TX_4X4
                    else:
                        tx = self._plane_tx_size(plane, plane_bsize) \
                            if plane else bi.tx_size
                    tw4 = c.TX_WIDTH[tx] >> 2
                    th4 = c.TX_HEIGHT[tx] >> 2
                    units = [(r, cc, tx)
                             for r in range(cu_r0, cu_r1, th4)
                             for cc in range(cu_c0, cu_c1, tw4)]
                for (tr4, tc4, tx) in units:
                    self._recon_inter_txb(ts, rd, bi, plane, plane_bsize,
                                          tx, row0, col0, tr4, tc4,
                                          mb_to_right, mb_to_bottom,
                                          ss_x, ss_y, mi_row, mi_col)
                if plane == 0 and cy == 0 and cx == 0 and store_cfl:
                    self._cfl_store_block(bi)

    def _recon_inter_txb(self, ts, rd, bi, plane, plane_bsize, tx_size,
                         row0, col0, row_off, col_off, mb_to_right,
                         mb_to_bottom, ss_x, ss_y, mi_row, mi_col):
        txwpx = c.TX_WIDTH[tx_size]
        txhpx = c.TX_HEIGHT[tx_size]
        txw = txwpx >> 2
        txh = txhpx >> 2
        px = col0 + col_off * 4
        py = row0 + row_off * 4
        ref = self.planes[plane]
        au = ts.above_entropy[plane]
        lu = ts.left_entropy[plane]
        acol = ((mi_col >> ss_x) if plane else mi_col) + col_off
        lrow = ((mi_row >> ss_y) if plane else mi_row) + row_off
        skip_ctx, dc_sign_ctx = CF.txb_ctx(
            plane_bsize, tx_size, plane, au[acol:acol + txw],
            lu[lrow:lrow + txh])
        dqv_dc, dqv_ac = self._dqv(plane, getattr(bi, "qindex",
                                                  self.fh.base_q_idx))
        mm = 32
        if self.lossless:
            tx_type = c.DCT_DCT   # lossless: WHT, coded as DCT_DCT class
            self._last_tx_type = c.DCT_DCT
        elif plane == 0:
            tx_type = self._make_inter_tx_type_reader(
                ts, rd, tx_size, mi_row + row_off, mi_col + col_off)
        else:
            # chroma inter: co-located luma tx type (blockd.h:1291)
            tt = int(self.tx_type_map[mi_row + (row_off << ss_y) + mm,
                                      mi_col + (col_off << ss_x) + mm])
            st = TT.ext_tx_set_type(tx_size, True,
                                    bool(self.fh.reduced_tx_set))
            if not TT.EXT_TX_USED[st][tt]:
                tt = c.DCT_DCT
            if c.TX_SIZE_SQR_UP[tx_size] > c.TX_32X32:
                tt = c.DCT_DCT
            tx_type = tt
            self._last_tx_type = tt
        t0 = rd.tell_frac() if self.acct is not None else 0
        eob, cul_level, dqcoeff = CF.read_coeffs_txb(
            rd, ts.fc, plane, tx_size, tx_type, skip_ctx, dc_sign_ctx,
            dqv_dc, dqv_ac, self.bd,
            iqm_fn=self._iqm_fn(plane, tx_size, bi))
        if self.acct is not None:
            key = "coeffs_y" if plane == 0 else "coeffs_uv"
            self.acct[key] = self.acct.get(key, 0) + rd.tell_frac() - t0
        if plane == 0 and eob == 0:
            self.tx_type_map[mi_row + row_off + mm,
                             mi_col + col_off + mm] = c.DCT_DCT
        pbw4 = blockd.block_wide(plane_bsize) >> 2
        pbh4 = blockd.block_high(plane_bsize) >> 2
        vis_w4 = pbw4 + (min(mb_to_right, 0) >> (2 + ss_x))
        vis_h4 = pbh4 + (min(mb_to_bottom, 0) >> (2 + ss_y))
        CF.set_entropy_spans(au, lu, acol, lrow, txw, txh, cul_level,
                             vis_w4, vis_h4, col_off, row_off,
                             mb_to_right < 0, mb_to_bottom < 0)
        if eob:
            if self.lossless:
                from ..common.txfm import iwht4x4
                res = iwht4x4(dqcoeff.reshape(4, 4))
                block = ref[py:py + txhpx, px:px + txwpx] \
                    .astype(np.int32) + res
                ref[py:py + txhpx, px:px + txwpx] = np.clip(
                    block, 0, (1 << self.bd) - 1).astype(ref.dtype)
            else:
                from ..common import txfm2d as T2
                tt = self._last_tx_type
                ref[py:py + txhpx, px:px + txwpx] = T2.inv_txfm2d_add(
                    dqcoeff, ref[py:py + txhpx, px:px + txwpx], tx_size, tt,
                    self.bd)

    def _make_inter_tx_type_reader(self, ts, rd, tx_size, cell_row,
                                   cell_col):
        """av1_read_tx_type for inter blocks (inter_ext_tx_cdf); records the
        decoded type into tx_type_map for chroma derivation."""
        def read_tx_type():
            st = TT.ext_tx_set_type(tx_size, True,
                                    bool(self.fh.reduced_tx_set))
            # segment-lossless (qindex==0) blocks carry no tx_type
            # symbol (av1_read_tx_type, decodemv.c:637); skip_txfm
            # blocks never reach the coeff reader on the inter side
            if TT.NUM_EXT_TX_SET[st] <= 1 or self.seg_qindex(
                    0, self.fh.base_q_idx) == 0:
                tt = c.DCT_DCT
            else:
                eset = TT.inter_ext_tx_idx(st)
                sqr = c.TX_SIZE_SQR[tx_size]
                sym = rd.decode_symbol_adapt(
                    ts.fc.inter_ext_tx_cdf[eset][sqr],
                    TT.NUM_EXT_TX_SET[st])
                tt = TT.EXT_TX_INV[st][sym]
            self._last_tx_type = tt
            self.tx_type_map[cell_row + 32, cell_col + 32] = tt
            return tt
        return read_tx_type

    # --- motion compensation ----------------------------------------------

    def _ref_pad(self, ref_idx, plane):
        key = (ref_idx, plane)
        pad = self._ref_pad_cache.get(key)
        if pad is None:
            pad = IP.pad_ref_plane(self.refs[ref_idx][plane])
            self._ref_pad_cache[key] = pad
        return pad

    def _ref_sf(self, ref_enum):
        """Scale factors of a reference vs the current coded frame size
        (av1_setup_scale_factors_for_frame; ref stored at its upscaled
        size)."""
        cache = getattr(self, "_ref_sf_cache", None)
        if cache is None:
            cache = self._ref_sf_cache = {}
        sf = cache.get(ref_enum)
        if sf is None:
            rh, rw = self.refs[ref_enum][0].shape
            sf = IP.scale_factors(rw, rh, self.fh.frame_width,
                                  self.fh.frame_height)
            cache[ref_enum] = sf
        return sf

    def _mc_single(self, ref_enum, plane, x0, y0, b_w, b_h, mv, ss_x, ss_y,
                   mb_to_left, mb_to_right, mb_to_top, mb_to_bottom,
                   fx, fy):
        """Single-ref MC dispatching on scaled vs unscaled refs."""
        if ref_enum == MR.INTRABC_REF:
            return self._mc_intrabc(plane, x0, y0, b_w, b_h, mv, ss_x, ss_y,
                                    mb_to_left, mb_to_right, mb_to_top,
                                    mb_to_bottom)
        sf = self._ref_sf(ref_enum)
        if IP.is_scaled(sf):
            rp = self.refs[ref_enum][plane]
            rh, rw = rp.shape
            return IP.predict_inter_block_scaled(
                self._ref_pad(ref_enum, plane), rw, rh, x0, y0, b_w, b_h,
                int(mv[0]), int(mv[1]), ss_x, ss_y, sf, fx, fy, self.bd)
        return IP.predict_inter_block(
            self._ref_pad(ref_enum, plane), x0, y0, b_w, b_h, int(mv[0]),
            int(mv[1]), ss_x, ss_y, mb_to_left, mb_to_right, mb_to_top,
            mb_to_bottom, fx, fy, self.bd)

    def _mc_intrabc(self, plane, x0, y0, b_w, b_h, mv, ss_x, ss_y,
                    mb_to_left, mb_to_right, mb_to_top, mb_to_bottom):
        """IntraBC prediction: bilinear MC from the in-progress recon of the
        current frame (reconinter.c av1_setup_pre_planes with cur_buf; DV
        validity keeps reads inside already-decoded tile area, so a local
        edge-clamped window substitutes for border extension)."""
        src = self.planes[plane]
        row_q4, col_q4 = IP.clamp_mv_to_umv_border(
            int(mv[0]), int(mv[1]), b_w, b_h, ss_x, ss_y, mb_to_left,
            mb_to_right, mb_to_top, mb_to_bottom)
        pos_x = (x0 << IP.SUBPEL_BITS) + col_q4
        pos_y = (y0 << IP.SUBPEL_BITS) + row_q4
        fx = pos_x >> IP.SUBPEL_BITS
        fy = pos_y >> IP.SUBPEL_BITS
        rows = np.clip(np.arange(fy - 3, fy + b_h + 4), 0, src.shape[0] - 1)
        cols = np.clip(np.arange(fx - 3, fx + b_w + 4), 0, src.shape[1] - 1)
        region = src[np.ix_(rows, cols)].astype(np.int32)
        kern = IP.filter_kernels(c.BILINEAR, b_w)
        return IP.convolve_sr(region, pos_x & IP.SUBPEL_MASK,
                              pos_y & IP.SUBPEL_MASK, kern, kern, self.bd)

    def _compound_bufs(self, bi, plane, x0, y0, b_w, b_h, ss_x, ss_y,
                       mb_to_left, mb_to_right, mb_to_top, mb_to_bottom,
                       fx, fy, warp_specs=None):
        """CONV-domain buffers for both refs, handling warp / scaled /
        translated references per ref."""
        bufs = []
        kx = IP.filter_kernels(fx, b_w)
        ky = IP.filter_kernels(fy, b_h)
        for ref in range(2):
            if warp_specs is not None and warp_specs[ref] is not None:
                from ..common import warp as WP
                mat, shear, plane_ref = warp_specs[ref]
                buf = np.empty((b_h, b_w), np.int32)
                WP.warp_affine(mat, plane_ref, buf, x0, y0, b_w, b_h,
                               ss_x, ss_y, *shear, is_compound=True,
                               bd=self.bd)
                bufs.append(buf)
                continue
            ref_enum = bi.ref_frame[ref]
            sf = self._ref_sf(ref_enum)
            if IP.is_scaled(sf):
                rp = self.refs[ref_enum][plane]
                rh, rw = rp.shape
                bufs.append(IP.predict_inter_block_scaled(
                    self._ref_pad(ref_enum, plane), rw, rh, x0, y0,
                    b_w, b_h, int(bi.mv[ref][0]), int(bi.mv[ref][1]),
                    ss_x, ss_y, sf, fx, fy, self.bd, is_compound=True))
                continue
            row_q4, col_q4 = IP.clamp_mv_to_umv_border(
                int(bi.mv[ref][0]), int(bi.mv[ref][1]), b_w, b_h, ss_x,
                ss_y, mb_to_left, mb_to_right, mb_to_top, mb_to_bottom)
            pos_x = (x0 << IP.SUBPEL_BITS) + col_q4
            pos_y = (y0 << IP.SUBPEL_BITS) + row_q4
            fxp = pos_x >> IP.SUBPEL_BITS
            fyp = pos_y >> IP.SUBPEL_BITS
            P = IP.PAD
            region = self._ref_pad(ref_enum, plane)[
                P + fyp - 3:P + fyp + b_h + 4,
                P + fxp - 3:P + fxp + b_w + 4].astype(np.int32)
            bufs.append(IP.convolve_compound(
                region, pos_x & IP.SUBPEL_MASK, pos_y & IP.SUBPEL_MASK,
                kx, ky, self.bd))
        return bufs

    _II_TO_INTRA = (c.DC_PRED, c.V_PRED, c.H_PRED, c.SMOOTH_PRED)

    def _interintra_blend(self, bi, plane, x0, y0, b_w, b_h, inter_pred,
                          ss_x, ss_y):
        """av1_build_interintra_predictor (reconinter.c:1152): intra
        prediction of the whole plane block from recon edges, blended
        with the inter prediction by a wedge or smooth mask."""
        from ..common import intra
        ts = self._last_ts
        mode = self._II_TO_INTRA[bi.interintra_mode]
        ref = self.planes[plane]
        mi_row, mi_col = bi.mi_row, bi.mi_col
        up_avail = mi_row > ts.mi_row_start
        left_avail = mi_col > ts.mi_col_start
        bw_mi = blockd.mi_size_wide(bi.bsize)
        bh_mi = blockd.mi_size_high(bi.bsize)
        xr = ((self.mi_cols - bw_mi - mi_col) * 4) >> ss_x
        yd = ((self.mi_rows - bh_mi - mi_row) * 4) >> ss_y
        edge_type = self._intra_edge_filter_type(
            bi, plane, up_avail, left_avail, up_avail, left_avail)
        ipred = intra.build_intra_predictor(
            ref, x0, y0, b_w, b_h, mode, 0, -1,
            n_top_px=min(b_w, xr + b_w) if up_avail else 0,
            n_topright_px=-1,
            n_left_px=min(b_h, yd + b_h) if left_avail else 0,
            n_bottomleft_px=-1,
            disable_edge_filter=not self.sh.enable_intra_edge_filter,
            intra_edge_filter_type=edge_type, bd=self.bd)
        if bi.use_wedge_interintra:
            # INTERINTRA_WEDGE_SIGN == 0 (blockd.h:40)
            mask = IP.wedge_mask(bi.bsize, 0, bi.interintra_wedge_index)
            return IP.blend_a64_mask_pixel(ipred, inter_pred, mask,
                                           ss_x, ss_y)
        pb = blockd.plane_block_size(bi.bsize, ss_x, ss_y)
        mask = IP.smooth_interintra_mask(pb, bi.interintra_mode)
        return IP.blend_a64_mask_pixel(ipred, inter_pred, mask, 0, 0)

    def _warp_params(self, bi, ref_idx, b_w, b_h):
        """av1_init_warp_params + av1_allow_warp (reconinter.c:33):
        returns (mat, shear) for this ref or None.  Local (WARPED_CAUSAL)
        params win over global motion."""
        if (b_w < 8 or b_h < 8 or self.fh.force_integer_mv
                or bi.is_intrabc):
            return None
        if (ref_idx == 0 and bi.motion_mode == c.WARPED_CAUSAL
                and getattr(bi, "wm", None) is not None):
            mat, alpha, beta, gamma, delta = bi.wm
            return mat, (alpha, beta, gamma, delta)
        gm = self.gm[bi.ref_frame[ref_idx]]
        if (MR.is_global_mv_block(bi.mode, bi.bsize, gm[0])
                and not gm[2] and gm[3] is not None):
            return gm[1], gm[3]
        return None

    def _predict_inter_block(self, bi, mi_row, mi_col):
        """dec_build_inter_predictor + build_inter_predictors
        (reconinter_template.inc)."""
        bsize = bi.bsize
        g = self.g
        m = g.m
        bw_px = blockd.block_wide(bsize)
        bh_px = blockd.block_high(bsize)
        bw4 = blockd.mi_size_wide(bsize)
        bh4 = blockd.mi_size_high(bsize)
        mi_x = mi_col * 4
        mi_y = mi_row * 4
        mb_to_left = -mi_x
        mb_to_right = (self.mi_cols - bw4 - mi_col) * 4
        mb_to_top = -mi_y
        mb_to_bottom = (self.mi_rows - bh4 - mi_row) * 4
        is_chroma_ref = blockd.is_chroma_reference(
            mi_row, mi_col, bsize, self.ss_x, self.ss_y) \
            and self.num_planes > 1
        nplanes = self.num_planes if is_chroma_ref else 1
        fx, fy = bi.interp_filter

        for plane in range(nplanes):
            ss_x = self.ss_x if plane else 0
            ss_y = self.ss_y if plane else 0
            dst = self.planes[plane]
            is_sub4_x = bw_px == 4 and ss_x
            is_sub4_y = bh_px == 4 and ss_y
            sub8x8 = False
            if plane and (is_sub4_x or is_sub4_y):
                sub8x8 = True
                for dr in range(-1 if is_sub4_y else 0, 1):
                    for dcc in range(-1 if is_sub4_x else 0, 1):
                        if g.ref0[mi_row + dr + m, mi_col + dcc + m] <= \
                                c.INTRA_FRAME:
                            sub8x8 = False
            if sub8x8:
                plane_bsize = blockd.plane_block_size(bsize, ss_x, ss_y)
                b4_w = bw_px >> ss_x
                b4_h = bh_px >> ss_y
                b8_w = blockd.block_wide(plane_bsize)
                b8_h = blockd.block_high(plane_bsize)
                row_start = -1 if is_sub4_y else 0
                col_start = -1 if is_sub4_x else 0
                pre_x = (mi_x + 4 * col_start) >> ss_x
                pre_y = (mi_y + 4 * row_start) >> ss_y
                row = row_start
                for y in range(0, b8_h, b4_h):
                    col = col_start
                    for x in range(0, b8_w, b4_w):
                        rr = mi_row + row + m
                        cc = mi_col + col + m
                        sref = int(g.ref0[rr, cc])
                        smv = g.mv[rr, cc, 0]
                        # this_mbmi->interp_filters: each sub-block uses
                        # its own block's filters (reconinter_template
                        # .inc:144)
                        sfy = int(self.interp_grid[rr, cc, 0])
                        sfx = int(self.interp_grid[rr, cc, 1])
                        pred = self._mc_single(
                            sref, plane, pre_x + x, pre_y + y, b4_w, b4_h,
                            smv, ss_x, ss_y, mb_to_left, mb_to_right,
                            mb_to_top, mb_to_bottom, sfx, sfy)
                        dst[pre_y + y:pre_y + y + b4_h,
                            pre_x + x:pre_x + x + b4_w] = pred
                        col += 1
                    row += 1
            else:
                # set_plane_n4 clamps plane dims to >=4 and setup_pred_plane
                # rounds the origin down for sub-8x8 chroma: the prediction
                # covers the full plane block at the rounded-down origin
                row_start = -1 if (bh_px == 4 and ss_y) else 0
                col_start = -1 if (bw_px == 4 and ss_x) else 0
                b_w = max(bw_px >> ss_x, 4) if plane else bw_px
                b_h = max(bh_px >> ss_y, 4) if plane else bh_px
                x0 = (mi_x + 4 * col_start) >> ss_x
                y0 = (mi_y + 4 * row_start) >> ss_y
                wm = getattr(bi, "wm", None)
                if bi.ref_frame[1] > c.INTRA_FRAME:
                    pads = (self._ref_pad(bi.ref_frame[0], plane),
                            self._ref_pad(bi.ref_frame[1], plane))
                    warp_specs = [None, None]
                    for wref in range(2):
                        wp = self._warp_params(bi, wref, b_w, b_h)
                        if wp is not None:
                            warp_specs[wref] = (
                                wp[0], wp[1],
                                self.refs[bi.ref_frame[wref]][plane])
                    have_warp = any(w is not None for w in warp_specs)
                    if getattr(bi, "comp_group_idx", 0):
                        bufs = self._compound_bufs(
                            bi, plane, x0, y0, b_w, b_h, ss_x, ss_y,
                            mb_to_left, mb_to_right, mb_to_top,
                            mb_to_bottom, fx, fy, warp_specs)
                        if bi.comp_type == 1:
                            mask = IP.wedge_mask(bsize, bi.wedge_sign,
                                                 bi.wedge_index)
                        else:
                            if plane == 0:
                                self._diffwtd_mask = IP.diffwtd_mask_d16(
                                    bufs[0], bufs[1],
                                    bool(bi.mask_type), self.bd)
                            mask = self._diffwtd_mask
                        pred = IP.blend_a64_d16(bufs[0], bufs[1], mask,
                                                ss_x, ss_y, self.bd)
                    else:
                        use_dw, fo, bo = self._dist_wtd_weights(bi)
                        if have_warp:
                            bufs = self._compound_bufs(
                                bi, plane, x0, y0, b_w, b_h, ss_x,
                                ss_y, mb_to_left, mb_to_right, mb_to_top,
                                mb_to_bottom, fx, fy, warp_specs)
                            pred = IP.compound_average(
                                bufs[0], bufs[1], use_dw, fo, bo, self.bd)
                        else:
                            bufs = self._compound_bufs(
                                bi, plane, x0, y0, b_w, b_h, ss_x,
                                ss_y, mb_to_left, mb_to_right, mb_to_top,
                                mb_to_bottom, fx, fy, None)
                            pred = IP.compound_average(
                                bufs[0], bufs[1], use_dw, fo, bo, self.bd)
                elif (wp0 := self._warp_params(bi, 0, b_w, b_h)) \
                        is not None:
                    from ..common import warp as WP
                    mat, shear = wp0
                    pred = np.empty((b_h, b_w), dst.dtype)
                    WP.warp_affine(mat, self.refs[bi.ref_frame[0]][plane],
                                   pred, x0, y0, b_w, b_h, ss_x, ss_y,
                                   *shear, bd=self.bd)
                else:
                    pred = self._mc_single(
                        bi.ref_frame[0], plane, x0, y0, b_w, b_h, bi.mv[0],
                        ss_x, ss_y, mb_to_left, mb_to_right, mb_to_top,
                        mb_to_bottom, fx, fy)
                if getattr(bi, "interintra", 0):
                    pred = self._interintra_blend(bi, plane, x0, y0, b_w,
                                                  b_h, pred, ss_x, ss_y)
                dst[y0:y0 + b_h, x0:x0 + b_w] = pred
        if getattr(bi, "motion_mode", 0) == c.OBMC_CAUSAL:
            self._obmc_blend(bi, mi_row, mi_col)

    _QUANT_DIST_WEIGHT = [(2, 3), (2, 5), (2, 7), (1, 31)]
    _QUANT_DIST_LOOKUP = [(9, 7), (11, 5), (12, 4), (13, 3)]

    def _dist_wtd_weights(self, bi):
        """av1_dist_wtd_comp_weight_assign (reconinter.c:668)."""
        if getattr(bi, "compound_idx", 1):
            return False, 8, 8
        cur = self.fh.order_hint
        bck_h = self.ref_hints[bi.ref_frame[0]]
        fwd_h = self.ref_hints[bi.ref_frame[1]]
        d0 = min(31, abs(H.get_relative_dist(self.sh, fwd_h, cur)))
        d1 = min(31, abs(H.get_relative_dist(self.sh, cur, bck_h)))
        order = int(d0 <= d1)
        if d0 == 0 or d1 == 0:
            return (True, self._QUANT_DIST_LOOKUP[3][order],
                    self._QUANT_DIST_LOOKUP[3][1 - order])
        for i in range(3):
            c0 = self._QUANT_DIST_WEIGHT[i][order]
            c1 = self._QUANT_DIST_WEIGHT[i][1 - order]
            if (d0 > d1 and d0 * c0 < d1 * c1) or \
                    (d0 <= d1 and d0 * c0 > d1 * c1):
                break
        else:
            i = 3
        return (True, self._QUANT_DIST_LOOKUP[i][order],
                self._QUANT_DIST_LOOKUP[i][1 - order])

    # --- OBMC -------------------------------------------------------------

    _MAX_NEIGHBOR_OBMC = [0, 1, 2, 3, 4, 4]
    _OBMC_MASKS = {
        1: np.array([64], np.int32),
        2: np.array([45, 64], np.int32),
        4: np.array([39, 50, 59, 64], np.int32),
        8: np.array([36, 42, 48, 53, 57, 61, 64, 64], np.int32),
        16: np.array([34, 37, 40, 43, 46, 49, 52, 54, 56, 58, 60, 61,
                      64, 64, 64, 64], np.int32),
        32: np.array([33, 35, 36, 38, 40, 41, 43, 44, 45, 47, 48, 50,
                      51, 52, 53, 55, 56, 57, 58, 59, 60, 60, 61, 62,
                      64, 64, 64, 64, 64, 64, 64, 64], np.int32),
    }

    def _skip_obmc_chroma(self, bsize, plane, direction):
        """av1_skip_u4x4_pred_in_obmc: one-sided chroma for tiny plane
        blocks (above pass skipped)."""
        if plane == 0:
            return False
        pb = blockd.plane_block_size(bsize, self.ss_x, self.ss_y)
        if pb in (c.BLOCK_4X4, c.BLOCK_8X4, c.BLOCK_4X8):
            return direction == 0
        return False

    def _obmc_blend(self, bi, mi_row, mi_col):
        """dec_build_obmc_inter_predictors_sb (decodeframe.c:799):
        re-predict overlappable neighbors into the overlap region and
        blend with the normative a64 masks."""
        bsize = bi.bsize
        g = self.g
        w4 = blockd.mi_size_wide(bsize)
        h4 = blockd.mi_size_high(bsize)
        bw_px = blockd.block_wide(bsize)
        bh_px = blockd.block_high(bsize)
        mi_x = mi_col * 4
        mi_y = mi_row * 4
        cur_right = (self.mi_cols - w4 - mi_col) * 4
        cur_bottom = (self.mi_rows - h4 - mi_row) * 4
        is_chroma_ref = blockd.is_chroma_reference(
            mi_row, mi_col, bsize, self.ss_x, self.ss_y)             and self.num_planes > 1
        nplanes = self.num_planes if is_chroma_ref else 1

        # --- above pass ---
        if mi_row > 0:
            pred_height = min(bh_px // 2, 32)
            adj_bottom = cur_bottom + (bh_px - pred_height)
            nb_max = self._MAX_NEIGHBOR_OBMC[w4.bit_length() - 1]
            overlap = min(bh_px, 64) >> 1
            count = 0
            acol = mi_col
            end_col = min(mi_col + w4, self.mi_cols)
            while acol < end_col and count < nb_max:
                nb = self._nb_obmc(mi_row - 1, acol)
                step = min(blockd.mi_size_wide(nb.bsize), 16)
                if step == 1:
                    acol &= ~1
                    nb = self._nb_obmc(mi_row - 1, acol + 1)
                    step = 2
                if nb.is_inter:
                    count += 1
                    op = min(w4, step)
                    rel = acol - mi_col
                    nfx, nfy = nb.interp_filter
                    mb_l = -(mi_col + rel) * 4
                    mb_r = cur_right + (w4 - rel - op) * 4
                    for plane in range(nplanes):
                        if self._skip_obmc_chroma(bsize, plane, 0):
                            continue
                        ss_x = self.ss_x if plane else 0
                        ss_y = self.ss_y if plane else 0
                        pw = (op * 4) >> ss_x
                        ph = min(max(bh_px >> (ss_y + 1), 4), 64 >> (ss_y + 1))
                        x0 = ((mi_x + rel * 4) >> ss_x)
                        y0 = mi_y >> ss_y
                        tmp = self._mc_single(
                            nb.ref_frame[0], plane, x0, y0, pw, ph,
                            nb.mv[0], ss_x, ss_y, mb_l, mb_r, -mi_y,
                            adj_bottom, nfx, nfy)
                        bh_b = overlap >> ss_y
                        mask = self._OBMC_MASKS[bh_b][:, None]
                        dstp = self.planes[plane]
                        cur = dstp[y0:y0 + bh_b, x0:x0 + pw].astype(np.int32)
                        nbp = tmp[:bh_b].astype(np.int32)
                        dstp[y0:y0 + bh_b, x0:x0 + pw] =                             ((mask * cur + (64 - mask) * nbp + 32) >> 6)                             .astype(dstp.dtype)
                acol += step

        # --- left pass ---
        if mi_col > 0:
            pred_width = min(bw_px // 2, 32)
            adj_right = cur_right + (bw_px - pred_width)
            nb_max = self._MAX_NEIGHBOR_OBMC[h4.bit_length() - 1]
            overlap = min(bw_px, 64) >> 1
            count = 0
            arow = mi_row
            end_row = min(mi_row + h4, self.mi_rows)
            while arow < end_row and count < nb_max:
                nb = self._nb_obmc(arow, mi_col - 1)
                step = min(blockd.mi_size_high(nb.bsize), 16)
                if step == 1:
                    arow &= ~1
                    nb = self._nb_obmc(arow + 1, mi_col - 1)
                    step = 2
                if nb.is_inter:
                    count += 1
                    op = min(h4, step)
                    rel = arow - mi_row
                    nfx, nfy = nb.interp_filter
                    mb_t = -(mi_row + rel) * 4
                    mb_b = cur_bottom + (h4 - rel - op) * 4
                    for plane in range(nplanes):
                        if self._skip_obmc_chroma(bsize, plane, 1):
                            continue
                        ss_x = self.ss_x if plane else 0
                        ss_y = self.ss_y if plane else 0
                        pw = min(max(bw_px >> (ss_x + 1), 4), 64 >> (ss_x + 1))
                        ph = (op * 4) >> ss_y
                        x0 = mi_x >> ss_x
                        y0 = ((mi_y + rel * 4) >> ss_y)
                        tmp = self._mc_single(
                            nb.ref_frame[0], plane, x0, y0, pw, ph,
                            nb.mv[0], ss_x, ss_y, -mi_x, adj_right, mb_t,
                            mb_b, nfx, nfy)
                        bw_b = overlap >> ss_x
                        mask = self._OBMC_MASKS[bw_b][None, :]
                        dstp = self.planes[plane]
                        cur = dstp[y0:y0 + ph, x0:x0 + bw_b].astype(np.int32)
                        nbp = tmp[:, :bw_b].astype(np.int32)
                        dstp[y0:y0 + ph, x0:x0 + bw_b] =                             ((mask * cur + (64 - mask) * nbp + 32) >> 6)                             .astype(dstp.dtype)
                arow += step
