"""Low-delay inter encoder: key frame + single-reference P-frames.

Builds on the all-intra RD machinery (encoder/lossy.py): the partition
search and emit passes are inherited; this module adds per-block inter
mode decision (motion search + NEW/NEAREST/NEAR/GLOBAL MV), the inter
symbol syntax (mirroring decoder/inter.py read order exactly), motion
compensation, and reference-frame management across frames.

Reference behavior: av1/encoder/encodeframe.c block coding loop,
bitstream.c pack_inter_mode_mvs (write order), mcomp.c motion search
(SAD-driven; our search is diamond+refine, non-normative).

Scope: error-resilient frames with order hints disabled (fresh CDFs per
frame, no skip-mode/compound), single LAST reference, TX_MODE_LARGEST,
non-switchable EIGHTTAP_REGULAR, low-precision MVs.
"""

from __future__ import annotations

import numpy as np

from ..bitstream import constants as c
from ..bitstream import headers as H
from ..common import blockd
from ..common import coeffs as CF
from ..common import interpred as IP
from ..common import mvref as MR
from ..common import quant as Q
from ..common import txfm2d as T2
from ..common import txtype as TT
from .encoder import make_sequence_header
from .lossy import LossyAllIntraEncoder, make_lossy_frame_header


def make_inter_frame_header(sh: H.SequenceHeader, qindex: int,
                            deblock: bool = True,
                            refresh_frame_flags: int = 0x01,
                            ref_frame_idx=(0,) * 7,
                            show_frame: int = 1,
                            showable_frame: int = 0,
                            s_frame: bool = False,
                            gm_params=None,
                            interp_filter: int = c.EIGHTTAP_REGULAR,
                            tx_select: bool = False,
                            aq: bool = False,
                            comp: bool = False,
                            order_hint: int = 0,
                            primary_ref: int = H.PRIMARY_REF_NONE,
                            ref_order_hints=(0,) * 8,
                            prev_gm_params=None,
                            allow_hp=None,
                            motion_modes: bool = False,
                            width: int | None = None,
                            height: int | None = None) -> H.FrameHeader:
    """Non-error-resilient when the sequence carries order hints and a
    primary_ref is given: per-frame CDF carry + backward adaptation
    (av1_common_int.h:414,985 primary_ref_frame / frame contexts)."""
    from ..common.loopfilter import pick_filter_level_from_q
    lvl = pick_filter_level_from_q(qindex, frame_is_key=False,
                                   bd=sh.bit_depth) if deblock \
        else 0
    extra = {}
    if gm_params is not None:
        extra = dict(gm_type=tuple(p[0] for p in gm_params),
                     gm_params=tuple(gm_params))
    non_er = (sh.enable_order_hint
              and primary_ref != H.PRIMARY_REF_NONE and not s_frame)
    if s_frame:
        # SWITCH_FRAME constraints (spec 5.9.2; aom_encoder.h:785-795
        # AOM_EFLAG_SET_S_FRAME): error-resilient implied, every ref
        # slot refreshed, no size override, shown
        refresh_frame_flags = 0xFF
        show_frame, showable_frame = 1, 0
    if allow_hp is None:
        # av1_pick_and_set_high_precision_mv (mv_prec.c): 1/8-pel pays
        # off at low q where residual bits dominate MV bits
        allow_hp = qindex < 128
    cw = width or sh.max_frame_width
    ch = height or sh.max_frame_height
    override = int((cw, ch) != (sh.max_frame_width, sh.max_frame_height))
    if s_frame:
        # SWITCH_FRAME: frame_size_override is IMPLIED 1 (spec 5.9.5) —
        # the explicit size is always coded
        assert not override, "switch frames keep the sequence size"
        override = 1
    fh = H.FrameHeader(
        frame_type=c.SWITCH_FRAME if s_frame else c.INTER_FRAME,
        show_frame=show_frame,
        showable_frame=showable_frame,
        error_resilient_mode=0 if non_er else 1,
        order_hint=order_hint,
        primary_ref_frame=primary_ref if non_er else H.PRIMARY_REF_NONE,
        ref_order_hints=tuple(ref_order_hints),
        prev_gm_params=prev_gm_params,
        disable_cdf_update=0,
        disable_frame_end_update_cdf=0 if non_er else 1,
        frame_size_override=override,
        frame_width=cw, frame_height=ch,
        render_width=cw, render_height=ch,
        base_q_idx=qindex,
        tx_mode=c.TX_MODE_SELECT if tx_select else c.TX_MODE_LARGEST,
        reduced_tx_set=0,
        refresh_frame_flags=refresh_frame_flags,
        ref_frame_idx=tuple(ref_frame_idx),
        allow_high_precision_mv=int(allow_hp),
        allow_ref_frame_mvs=int(non_er and sh.enable_ref_frame_mvs),
        is_filter_switchable=0,
        interpolation_filter=interp_filter,
        is_motion_mode_switchable=int(motion_modes),
        allow_warped_motion=int(motion_modes and non_er
                                and sh.enable_warped_motion),
        reference_mode=(c.REFERENCE_MODE_SELECT if comp
                        else c.SINGLE_REFERENCE),
        delta_q_present=int(aq), delta_q_res_log2=2 if aq else 0,
        filter_level=(lvl, lvl), filter_level_u=lvl, filter_level_v=lvl,
        **extra)
    # skip mode: codeable when the derived fwd/bwd ref pair exists
    # (av1_setup_skip_mode_allowed); flag=1 lets blocks choose it
    if non_er:
        H._setup_skip_mode(fh, sh)
        fh.skip_mode_flag = 1 if fh.skip_mode_refs else 0
    return fh


# single_ref decision-tree coding: ref enum -> [(cdf_col, ctx_fn, bit)]
# (mirrors decoder/inter.py read order / av1 read_single_ref)
def _single_ref_tree(ref, counts):
    if ref <= c.GOLDEN_FRAME:
        bits = [(0, MR.ctx_single_ref_p1(counts), 0)]
        if ref <= c.LAST2_FRAME:
            bits.append((2, MR.ctx_single_ref_p3(counts), 0))
            bits.append((3, MR.ctx_single_ref_p4(counts),
                         int(ref == c.LAST2_FRAME)))
        else:
            bits.append((2, MR.ctx_single_ref_p3(counts), 1))
            bits.append((4, MR.ctx_single_ref_p5(counts),
                         int(ref == c.GOLDEN_FRAME)))
        return bits
    bits = [(0, MR.ctx_single_ref_p1(counts), 1)]
    if ref == c.ALTREF_FRAME:
        bits.append((1, MR.ctx_single_ref_p2(counts), 1))
    else:
        bits.append((1, MR.ctx_single_ref_p2(counts), 0))
        bits.append((5, MR.ctx_single_ref_p6(counts),
                     int(ref == c.ALTREF2_FRAME)))
    return bits


#: block sizes with wedge codebooks (av1_wedge_params_lookup non-null,
#: reconinter.c; mirrors decoder/inter.py wedge_used set)
WEDGE_SIZES = frozenset((c.BLOCK_8X8, c.BLOCK_8X16, c.BLOCK_16X8,
                         c.BLOCK_16X16, c.BLOCK_16X32, c.BLOCK_32X16,
                         c.BLOCK_32X32, c.BLOCK_8X32, c.BLOCK_32X8))


def _mv_class(z: int):
    """av1_get_mv_class: z = |mv| - 1; returns (class, offset)."""
    if z < 16:
        return 0, z
    cls = (z >> 3).bit_length() - 1
    cls = min(cls, 10)
    return cls, z - (2 << (cls + 2))


class InterFrameEncoder(LossyAllIntraEncoder):
    # emit builds MV-ref state; plan replay (LR re-emit) not yet supported
    _lr_capable = False
    """Encode one inter frame against a LAST reference."""

    def __init__(self, sh, fh, refs, use_native=None,
                 block_size=c.BLOCK_16X16, mode_set=(c.DC_PRED,),
                 enable_cfl=False, search_range=16,
                 ref_list=(c.LAST_FRAME,), tune="psnr", luma_bias=0.0,
                 trellis=True, comp_search=None, ref_bufs=None,
                 sharpness=0):
        super().__init__(sh, fh, use_native=use_native,
                         block_size=block_size, mode_set=mode_set,
                         enable_cfl=enable_cfl, tune=tune,
                         luma_bias=luma_bias, trellis=trellis,
                         sharpness=sharpness)
        self.refs = refs                # slot -> (y, u, v) visible planes
        # frame-level interpolation filter (is_filter_switchable=0):
        # av1_pick_interp_filter analog picks it per frame
        self.interp_filter = fh.interpolation_filter \
            if fh.interpolation_filter != c.SWITCHABLE \
            else c.EIGHTTAP_REGULAR
        self.ref_list = tuple(ref_list)  # ref enums searched per block
        # compound-average trial sweep (REFERENCE_MODE_SELECT may be on
        # purely for skip mode; the explicit compound search is separate)
        self.comp_search = (fh.reference_mode == c.REFERENCE_MODE_SELECT
                            if comp_search is None else comp_search)
        self.search_range = search_range
        self.g = MR.MiGrids(self.mi_rows, self.mi_cols)
        #: per-mi skip_mode map (margin-padded like g), skip_mode_ctx input
        self.skip_mode_grid = np.zeros(self.g.ref0.shape, np.uint8)
        #: per-mi comp_group_idx map (comp_group_idx_ctx neighbour state)
        self.comp_group_grid = np.zeros(self.g.ref0.shape, np.uint8)
        #: per-mi compound_idx map (comp_index_ctx neighbour state;
        #: default 1 = COMPOUND_AVERAGE, decoder bi.compound_idx init)
        self.comp_idx_grid = np.ones(self.g.ref0.shape, np.uint8)
        self._ref_pad_cache = {}
        # av1_get_mvpred cost weights (rough): bits per mv step
        self.mv_bit_cost = 1.0
        # global motion per ref enum (decoder.FrameDecoder.gm layout)
        from ..common import warp as WP
        self.gm = [(c.IDENTITY, [0, 0, 65536, 0, 0, 65536], 0, None)]
        for wmtype, mat, invalid in fh.gm_params:
            shear = None
            if wmtype > c.TRANSLATION and not invalid:
                ok, a, b, gmm, d = WP.get_shear_params(list(mat))
                shear = (a, b, gmm, d) if ok else None
                if not ok:
                    invalid = 1
            self.gm.append((wmtype, list(mat), invalid, shear))
        self._gm_types = [e[0] for e in self.gm]
        # ref sign bias / side from order hints (decoder __init__
        # mirror, av1_common_int.h ref_frame_sign_bias); all-zero when
        # the sequence has no order hints
        self.sign_bias = [0] * 8
        self.ref_side = [0] * 8
        self.ref_hints = [0] * 8
        if sh.enable_order_hint:
            for i in range(7):
                slot = fh.ref_frame_idx[i]
                hint = fh.ref_order_hints[slot]
                self.ref_hints[c.LAST_FRAME + i] = hint
                d = H.get_relative_dist(sh, hint, fh.order_hint)
                self.sign_bias[c.LAST_FRAME + i] = int(d > 0)
                if d > 0:
                    self.ref_side[c.LAST_FRAME + i] = 1
                elif hint == fh.order_hint:
                    self.ref_side[c.LAST_FRAME + i] = -1
        # distance-weighted compound weights for (LAST, ALTREF)
        # (av1_dist_wtd_comp_weight_assign, reconinter.c:668; frame-level
        # because they depend only on the order-hint distances)
        self.dw_weights = (False, 8, 8)
        if sh.enable_jnt_comp and sh.enable_order_hint:
            self.dw_weights = self._dist_wtd_weights_enc(
                c.LAST_FRAME, c.ALTREF_FRAME)
        self.jnt_blocks = 0    # diagnostics: dist-wtd winners this frame
        # temporal MV field (av1_setup_motion_field) + per-8x8 storage
        # for future frames (av1_copy_frame_mvs), decoder mirrors
        h2, w2 = (self.mi_rows + 1) >> 1, (self.mi_cols + 1) >> 1
        self.frame_mvs_ref = np.full((h2, w2), -1, np.int8)
        self.frame_mvs = np.zeros((h2, w2, 2), np.int16)
        self.tmvp = None
        if fh.allow_ref_frame_mvs and ref_bufs is not None:
            slot_bufs = [None] * 8
            for i in range(7):
                slot_bufs[c.LAST_FRAME + i] = \
                    ref_bufs[fh.ref_frame_idx[i]]
            self.tmvp = MR.setup_motion_field(
                sh, fh, self.mi_rows, self.mi_cols, slot_bufs,
                self.ref_hints,
                lambda a, b: H.get_relative_dist(sh, a, b))

    # --- motion modes: decoder machinery reused over the encoder state ----
    #
    # The OBMC scans / blend and warp-sample search are the decoder's own
    # methods (decoder/inter.py), bound here so trial and decode use one
    # implementation; only the mi-grid accessor and ref plumbing differ.

    @property
    def planes(self):
        # decoder-side name for the surface _obmc_blend blends into:
        # the encoder's recon (trial scratch; final recon is re-written
        # by _apply_txbs over the same region)
        return self.recon

    def _ref_sf(self, ref_enum):
        """Scale factors of a reference vs the current coded size
        (decoder _ref_sf mirror; spatial-SVC inter-layer refs are
        stored at their own resolution)."""
        slot = self.fh.ref_frame_idx[ref_enum - 1]
        ref = self.refs[slot]
        if ref is None:
            return (IP.REF_NO_SCALE, IP.REF_NO_SCALE, 0, 0)
        rh, rw = ref[0].shape
        return IP.scale_factors(rw, rh, self.fh.frame_width,
                                self.fh.frame_height)

    def _ref_scaled(self, ref_enum) -> bool:
        return IP.is_scaled(self._ref_sf(ref_enum))

    # borrowed decoder methods (single implementation for both sides)
    from ..decoder.inter import InterDecoderMixin as _D
    _has_overlappable_neighbor = _D._has_overlappable_neighbor
    _overlappable_above = _D._overlappable_above
    _overlappable_left = _D._overlappable_left
    _skip_obmc_chroma = _D._skip_obmc_chroma
    _mc_single = _D._mc_single
    _OBMC_MASKS = _D._OBMC_MASKS
    _MAX_NEIGHBOR_OBMC = _D._MAX_NEIGHBOR_OBMC
    del _D

    class _NbInfo:
        __slots__ = ("bsize", "is_inter", "ref_frame", "mv",
                     "interp_filter", "mode", "num_proj_ref",
                     "partition")

    def _nb_obmc(self, r, cc):
        g = self.g
        m = g.m
        nb = InterFrameEncoder._NbInfo()
        r0 = int(g.ref0[r + m, cc + m])
        nb.bsize = int(g.bsize[r + m, cc + m])
        nb.is_inter = r0 > c.INTRA_FRAME and r0 != MR.INTRABC_REF
        nb.ref_frame = (r0, int(g.ref1[r + m, cc + m]))
        nb.mv = (tuple(int(v) for v in g.mv[r + m, cc + m, 0]),
                 tuple(int(v) for v in g.mv[r + m, cc + m, 1]))
        nb.interp_filter = (self.interp_filter, self.interp_filter)
        return nb

    def _motion_mode_allowed_enc(self, mode, ref, bsize, mi_row, mi_col,
                                 partition=c.PARTITION_NONE):
        """motion_mode_allowed + the read gates of decodemv.c:226: the
        motion-mode symbol context for this block, or None when no
        symbol is coded.  Returns (allowed, num_proj_ref, pts,
        pts_inref)."""
        from ..decoder.inter import InterDecoderMixin as D
        fh = self.fh
        bi = InterFrameEncoder._NbInfo()
        bi.bsize = bsize
        bi.ref_frame = (ref, -1)
        bi.mv = ((0, 0), (0, 0))
        bi.is_inter = True
        bi.mode = mode
        bi.partition = partition
        bi.num_proj_ref = 0
        pts = pts_inref = None
        if (blockd.block_wide(bsize) >= 8
                and blockd.block_high(bsize) >= 8):
            bi.num_proj_ref, pts, pts_inref = D._find_samples(
                self, None, bi, mi_row, mi_col, bsize)
        if not fh.is_motion_mode_switchable:
            return c.SIMPLE_TRANSLATION, bi.num_proj_ref, pts, pts_inref
        allowed = D._motion_mode_allowed(self, None, bi, mi_row, mi_col,
                                         bsize, mi_row > 0, mi_col > 0)
        return allowed, bi.num_proj_ref, pts, pts_inref

    def _warp_model(self, mv, num_proj_ref, pts, pts_inref, bsize,
                    mi_row, mi_col):
        """Decoder WARPED_CAUSAL tail (select_samples+find_projection);
        returns (mat, shear) or None when the projection is invalid."""
        from ..common import warp as WP
        np_ref = num_proj_ref
        if np_ref > 1:
            np_ref = WP.select_samples(
                mv[0], mv[1], pts, pts_inref, np_ref,
                blockd.block_wide(bsize), blockd.block_high(bsize))
        ok, mat, alpha, beta, gamma, delta = WP.find_projection(
            np_ref, pts, pts_inref, blockd.block_wide(bsize),
            blockd.block_high(bsize), mv[0], mv[1], mi_row, mi_col)
        return (mat, (alpha, beta, gamma, delta)) if ok else None

    # --- global motion ------------------------------------------------------

    def _gm_mv(self, ref, bsize, mi_row, mi_col):
        return MR.gm_get_motion_vector(
            self.gm[ref], self.fh.allow_high_precision_mv,
            blockd.block_wide(bsize), blockd.block_high(bsize),
            mi_col, mi_row, self.fh.force_integer_mv)

    def _gm_would_warp(self, ref, bsize) -> bool:
        """Mirror of decoder._warp_params' global branch for luma."""
        e = self.gm[ref]
        return (e[0] > c.TRANSLATION and not e[2] and e[3] is not None
                and blockd.block_wide(bsize) >= 8
                and blockd.block_high(bsize) >= 8
                and not self.fh.force_integer_mv)

    def _gm_info(self, gm_mv):
        return {"mv": (gm_mv, (0, 0)), "types": self._gm_types}

    # --- reference access -------------------------------------------------

    def _ref_pad(self, ref_idx, plane):
        key = (ref_idx, plane)
        pad = self._ref_pad_cache.get(key)
        if pad is None:
            slot = self.fh.ref_frame_idx[ref_idx - 1]
            pad = IP.pad_ref_plane(self.refs[slot][plane])
            self._ref_pad_cache[key] = pad
        return pad

    # --- motion search (non-normative) ------------------------------------

    #: full-pel search patterns (mcomp_structs.h:86 SEARCH_METHODS;
    #: site offsets from mcomp.c's search site configs)
    SEARCH_PATTERNS = {
        "diamond": ((-1, 0), (1, 0), (0, -1), (0, 1)),
        "bigdia": ((-1, 0), (1, 0), (0, -1), (0, 1),
                   (-1, -1), (-1, 1), (1, -1), (1, 1)),
        "square": ((-1, -1), (-1, 0), (-1, 1), (0, -1),
                   (0, 1), (1, -1), (1, 0), (1, 1)),
        "hex": ((-2, 0), (2, 0), (-1, -2), (-1, 2), (1, -2), (1, 2)),
    }
    #: selected method ("diamond" | "bigdia" | "square" | "hex" |
    #: "exhaustive" / NSTEP-style mesh)
    search_method = "diamond"

    def _motion_search(self, mi_row, mi_col, bsize, pred_mv,
                       ref_frame=c.LAST_FRAME):
        """Fullpel pattern search + subpel refine on luma SAD.  Returns
        an MV in 1/8-pel with even components (allow_hp=0).
        (av1_full_pixel_search mcomp.c:3864 analog; the pattern is a
        speed feature knob like sf->mv_sf.search_method.)"""
        y0, x0 = mi_row * 4, mi_col * 4
        h = min(blockd.block_high(bsize), self.mi_rows * 4 - y0)
        w = min(blockd.block_wide(bsize), self.mi_cols * 4 - x0)
        src = self.src[0][y0:y0 + h, x0:x0 + w].astype(np.int32)
        ref = self._ref_pad(ref_frame, 0)
        P = IP.PAD

        def sad_full(dy, dx):
            blk = ref[P + y0 + dy:P + y0 + dy + h,
                      P + x0 + dx:P + x0 + dx + w].astype(np.int32)
            return int(np.abs(blk - src).sum())

        # start points: (0,0) and fullpel rounded predicted mv
        starts = {(0, 0), (pred_mv[0] >> 3, pred_mv[1] >> 3)}
        best = None
        for s in starts:
            v = sad_full(*s)
            if best is None or v < best[0]:
                best = (v, s)
        by, bx = best[1]
        if self.search_method == "exhaustive":
            # mesh search (av1_full_pixel_exhaustive): coarse grid then
            # +-1 polish
            r = self.search_range
            for dy in range(by - r, by + r + 1, 2):
                for dx in range(bx - r, bx + r + 1, 2):
                    if abs(dy) > 128 or abs(dx) > 128:
                        continue
                    v = sad_full(dy, dx)
                    if v < best[0]:
                        best = (v, (dy, dx))
            by, bx = best[1]
            pattern = self.SEARCH_PATTERNS["square"]
            step_seq = [1]
        else:
            pattern = self.SEARCH_PATTERNS.get(
                self.search_method, self.SEARCH_PATTERNS["diamond"])
            step_seq = []
            step = max(1, self.search_range // 2)
            while step >= 1:
                step_seq.append(step)
                step >>= 1
        for step in step_seq:
            improved = True
            while improved:
                improved = False
                for (dy, dx) in pattern:
                    ny, nx = by + dy * step, bx + dx * step
                    if abs(ny) > 128 or abs(nx) > 128:
                        continue
                    v = sad_full(ny, nx)
                    if v < best[0]:
                        best = (v, (ny, nx))
                        by, bx = ny, nx
                        improved = True
        # subpel refine at 1/4 pel (even 1/8 units) via interpolation
        best_mv = (by * 8, bx * 8)
        best_cost = None
        mb_to_left = -x0
        mb_to_right = (self.mi_cols * 4 - blockd.block_wide(bsize) - x0)
        mb_to_top = -y0
        mb_to_bottom = (self.mi_rows * 4 - blockd.block_high(bsize) - y0)
        def try_mv(mv):
            nonlocal best_cost, best_mv
            pred = IP.predict_inter_block(
                ref, x0, y0, blockd.block_wide(bsize),
                blockd.block_high(bsize), mv[0], mv[1], 0, 0,
                mb_to_left, mb_to_right, mb_to_top, mb_to_bottom,
                self.interp_filter, self.interp_filter, self.bd)
            v = int(np.abs(pred[:h, :w].astype(np.int32) - src).sum())
            if best_cost is None or v < best_cost:
                best_cost = v
                best_mv = mv

        for dy in (-4, -2, 0, 2, 4):
            for dx in (-4, -2, 0, 2, 4):
                try_mv((by * 8 + dy, bx * 8 + dx))
        if self.fh.allow_high_precision_mv:
            # 1/8-pel refinement ring around the 1/4-pel winner
            # (mcomp.c subpel FULL_PEL->QTR->EIGHTH ladder tail)
            qy, qx = best_mv
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    if dy or dx:
                        try_mv((qy + dy, qx + dx))
        return best_mv

    # --- block trial ------------------------------------------------------

    def _refmv_context(self, mi_row, mi_col, bsize,
                       partition=c.PARTITION_NONE):
        return MR.RefMvContext(
            self.g, mi_row, mi_col, bsize, self.sb_mi if hasattr(
                self, "sb_mi") else (1 << (self.sh.sb_size_log2 - 2)),
            0, self.mi_rows, 0, self.mi_cols, partition)

    # --- trial-time mi-grid coherence ------------------------------------
    #
    # The decoder derives NEAREST/NEAR MVs from already-decoded neighbour
    # state; the trial must therefore run against the same mi grid the
    # emit pass will produce, so trials fill self.g as they commit and
    # the partition search snapshots/restores the grid region alongside
    # recon (reference keeps per-branch xd->mi context the same way,
    # encodeframe_utils.c av1_restore_context).

    def _save_region(self, mi_row, mi_col, bsize):
        base = super()._save_region(mi_row, mi_col, bsize)
        g = self.g
        m = g.m
        h4 = min(blockd.mi_size_high(bsize), self.mi_rows - mi_row)
        w4 = min(blockd.mi_size_wide(bsize), self.mi_cols - mi_col)
        r0, c0 = mi_row + m, mi_col + m
        sl = (slice(r0, r0 + h4), slice(c0, c0 + w4))
        gsnap = (g.ref0[sl].copy(), g.ref1[sl].copy(), g.mode[sl].copy(),
                 g.bsize[sl].copy(), g.partition[sl].copy(),
                 g.mv[sl].copy(), self.comp_group_grid[sl].copy(),
                 self.comp_idx_grid[sl].copy())
        return (base, sl, gsnap)

    def _restore_region(self, mi_row, mi_col, bsize, snap):
        base, sl, gsnap = snap
        super()._restore_region(mi_row, mi_col, bsize, base)
        g = self.g
        (g.ref0[sl], g.ref1[sl], g.mode[sl], g.bsize[sl],
         g.partition[sl], g.mv[sl], self.comp_group_grid[sl],
         self.comp_idx_grid[sl]) = gsnap

    def _fill_trial(self, bplan, partition):
        """Commit one trialed block into the mi grid (emit re-fills the
        same values; contexts match by induction)."""
        bsize = bplan["bsize"]
        bh = blockd.mi_size_high(bsize)
        bw = blockd.mi_size_wide(bsize)
        is_inter = bplan["is_inter"]
        # interintra blocks store ref_frame[1] = INTRA_FRAME (decoder
        # read_interintra_mode mirror), so neighbour contexts match
        ref1 = bplan.get("ref1", -1) if is_inter else -1
        if is_inter and bplan.get("interintra", 0):
            ref1 = c.INTRA_FRAME
        self.g.fill_block(
            bplan["mi_row"], bplan["mi_col"], bh, bw,
            bplan.get("ref", c.LAST_FRAME) if is_inter else c.INTRA_FRAME,
            ref1,
            bplan["mode"] if is_inter else bplan["y_mode"], bsize,
            partition, bplan["mv"], bplan.get("mv1") or (0, 0))
        m = self.g.m
        r = bplan["mi_row"] + m
        cc = bplan["mi_col"] + m
        h4 = min(bh, self.mi_rows - bplan["mi_row"])
        w4 = min(bw, self.mi_cols - bplan["mi_col"])
        self.comp_group_grid[r:r + h4, cc:cc + w4] = \
            bplan.get("comp_group_idx", 0) if is_inter else 0
        self.comp_idx_grid[r:r + h4, cc:cc + w4] = \
            bplan.get("compound_idx", 1) if is_inter else 1

    def _trial_skip_mode(self, mi_row, mi_col, bsize, partition):
        """Skip-mode candidate: derived compound NEAREST_NEARESTMV over
        fh.skip_mode_refs, zero residual (one ~1-bit symbol).  Mirrors
        the decoder's skip-mode derivation exactly (decodemv.c:421,
        mode_info path with ref_mv_idx 0)."""
        fh = self.fh
        r0, r1 = fh.skip_mode_refs
        ctx = self._refmv_context(mi_row, mi_col, bsize, partition)
        bw, bh = blockd.block_wide(bsize), blockd.block_high(bsize)
        gm_mv0 = MR.gm_get_motion_vector(
            self.gm[r0], fh.allow_high_precision_mv, bw, bh,
            mi_col, mi_row, fh.force_integer_mv)
        gm_mv1 = MR.gm_get_motion_vector(
            self.gm[r1], fh.allow_high_precision_mv, bw, bh,
            mi_col, mi_row, fh.force_integer_mv)
        gmi = {"mv": (gm_mv0, gm_mv1), "types": self._gm_types}
        stack, weights, count, mode_ctx, mv_list = MR.find_mv_refs(
            ctx, (r0, r1), sign_bias=self.sign_bias, tmvp=self.tmvp,
            gm=gmi)
        if count:
            mv0 = MR.lower_mv_precision(stack[0][0],
                                        fh.allow_high_precision_mv,
                                        fh.force_integer_mv)
            mv1 = MR.lower_mv_precision(stack[0][1],
                                        fh.allow_high_precision_mv,
                                        fh.force_integer_mv)
        else:
            mv0 = mv1 = (0, 0)
        dist, _bits, txbs = self._code_inter_planes(
            mi_row, mi_col, bsize, mv0, r0, ref1=r1, mv1=mv1,
            force_skip=True)
        cost = dist + self._lam(mi_row, mi_col) * 1.0
        return cost, mv0, mv1, txbs

    def _trial_block(self, mi_row, mi_col, bsize,
                     partition=c.PARTITION_NONE):
        """Try inter modes over every active reference + intra fallback;
        pick by RD."""
        up_avail = mi_row > 0
        left_avail = mi_col > 0
        ctx = self._refmv_context(mi_row, mi_col, bsize, partition)

        best = None
        for ref in self.ref_list:
            gm_mv = self._gm_mv(ref, bsize, mi_row, mi_col)
            stack, weights, count, mode_ctx, mv_list = MR.find_mv_refs(
                ctx, ref, sign_bias=self.sign_bias, tmvp=self.tmvp,
                gm=self._gm_info(gm_mv))
            allow_hp = self.fh.allow_high_precision_mv
            force_int = self.fh.force_integer_mv
            nearest = MR.lower_mv_precision(mv_list[0], allow_hp, force_int)
            near = MR.lower_mv_precision(mv_list[1], allow_hp, force_int)

            if self._ref_scaled(ref):
                # scaled (inter-layer) ref: candidate MVs only — the
                # (0,0)/NEAREST candidates are the upsampled lower layer
                searched = nearest
            else:
                searched = self._motion_search(mi_row, mi_col, bsize,
                                               nearest, ref)
            gw = self._gm_would_warp(ref, bsize)
            cands = [(MR.NEWMV, searched, False)]
            if searched != nearest:
                cands.append((MR.NEARESTMV, nearest, False))
            if near != nearest and near != searched:
                cands.append((MR.NEARMV, near, False))
            if gw or gm_mv not in (searched, nearest, near):
                cands.append((MR.GLOBALMV, gm_mv, gw))
            # NEWMV with mv equal to nearest is wasteful: demote
            if searched == nearest:
                cands[0] = (MR.NEARESTMV, nearest, False)
            seen = set()
            uniq = []
            for mode, mv, w_ in cands:
                if (mode, mv, w_) in seen:
                    continue
                seen.add((mode, mv, w_))
                uniq.append((mode, mv, w_))

            for mode, mv, w_ in uniq:
                dist, bits, txbs = self._code_inter_planes(
                    mi_row, mi_col, bsize, mv, ref, gm_warp=w_)
                bits += self._est_inter_mode_bits(mode, mv, nearest,
                                                  mode_ctx)
                bits += 1.5 * (len(self.ref_list) > 1)  # ref signaling
                cost = dist + self._lam(mi_row, mi_col) * bits
                if best is None or cost < best[0]:
                    best = (cost, mode, mv, txbs, ref, w_, dist, bits)

        # compound candidate: NEAREST_NEARESTMV (LAST, ALTREF) average
        # (compound_type.c COMPOUND_AVERAGE branch of the mode loop)
        if (self.comp_search
                and self.fh.reference_mode == c.REFERENCE_MODE_SELECT
                and c.ALTREF_FRAME in self.ref_list
                and not self._ref_scaled(c.LAST_FRAME)
                and not self._ref_scaled(c.ALTREF_FRAME)
                and min(blockd.block_wide(bsize),
                        blockd.block_high(bsize)) >= 8):
            rf_key = (c.LAST_FRAME, c.ALTREF_FRAME)
            bwpx, bhpx = blockd.block_wide(bsize), blockd.block_high(bsize)
            cgm0 = self._gm_mv(c.LAST_FRAME, bsize, mi_row, mi_col)
            cgm1 = self._gm_mv(c.ALTREF_FRAME, bsize, mi_row, mi_col)
            gmi = {"mv": (cgm0, cgm1), "types": self._gm_types}
            stack, weights, count, mode_ctx, mv_list = MR.find_mv_refs(
                ctx, rf_key, sign_bias=self.sign_bias, tmvp=self.tmvp,
                gm=gmi)
            if count:
                mv0 = MR.lower_mv_precision(stack[0][0],
                                            self.fh.allow_high_precision_mv,
                                            self.fh.force_integer_mv)
                mv1 = MR.lower_mv_precision(stack[0][1],
                                            self.fh.allow_high_precision_mv,
                                            self.fh.force_integer_mv)
            else:
                mv0 = mv1 = (0, 0)
            lam = self._lam(mi_row, mi_col)
            masked_ok = bool(self.sh.enable_masked_compound)
            jnt_ok = bool(self.sh.enable_jnt_comp)
            dist, bits, txbs = self._code_inter_planes(
                mi_row, mi_col, bsize, mv0, c.LAST_FRAME,
                ref1=c.ALTREF_FRAME, mv1=mv1)
            bits += 5.0  # comp flag + ref tree + compound mode symbol
            if masked_ok:
                bits += 1.0  # comp_group_idx = 0 symbol
            if jnt_ok:
                bits += 1.0  # compound_idx symbol
            # compound-type RD: COMPOUND_AVERAGE vs WEDGE vs DIFFWTD
            # (av1/encoder/compound_type.c:1666 av1_compound_type_rd)
            cands = [(dist + lam * bits, None, txbs)]
            if jnt_ok and self.dw_weights[0]:
                # distance-weighted average (compound_idx = 0;
                # compound_type.c:1666 DIST_WTD_COMP trial)
                d_dw, b_dw, t_dw = self._code_inter_planes(
                    mi_row, mi_col, bsize, mv0, c.LAST_FRAME,
                    ref1=c.ALTREF_FRAME, mv1=mv1,
                    comp_weights=self.dw_weights)
                b_dw += 5.0 + (1.0 if masked_ok else 0.0) + 1.0
                cands.append((d_dw + lam * b_dw,
                              dict(compound_idx=0), t_dw))
            if masked_ok:
                cands += self._trial_masked_compound(
                    mi_row, mi_col, bsize, mv0, c.LAST_FRAME, mv1,
                    c.ALTREF_FRAME, lam)
            cost, best_comp_spec, txbs = min(cands, key=lambda t: t[0])
            if best_comp_spec is not None \
                    and best_comp_spec.get("compound_idx", 1) == 0:
                self.jnt_blocks += 1
            if best is None or cost < best[0]:
                best = (cost, MR.NEAREST_NEARESTMV, mv0, txbs,
                        c.LAST_FRAME, False, dist, bits)
                best_comp = mv1
            else:
                best_comp = None
                best_comp_spec = None
        else:
            best_comp = None
            best_comp_spec = None

        # skip-mode candidate (zero residual, derived compound refs)
        skip_best = None
        if (self.fh.skip_mode_flag and self.fh.skip_mode_refs
                and not self.fh.segmentation_enabled
                and min(blockd.block_wide(bsize),
                        blockd.block_high(bsize)) >= 8):
            sk_cost, sk_mv0, sk_mv1, sk_txbs = self._trial_skip_mode(
                mi_row, mi_col, bsize, partition)
            skip_best = (sk_cost, sk_mv0, sk_mv1, sk_txbs)

        # intra fallback (DC)
        intra_best = None
        for mode in self.mode_set:
            dist, bits, txbs = self._code_plane(
                0, mode, mi_row, mi_col, bsize, up_avail, left_avail,
                write_recon=False)
            cost = dist + self._lam(mi_row, mi_col) * (bits + 6.0)
            if intra_best is None or cost < intra_best[0]:
                intra_best = (cost, mode, txbs)

        is_chroma_ref = blockd.is_chroma_reference(
            mi_row, mi_col, bsize, self.ss_x, self.ss_y) \
            and self.num_planes > 1

        if (skip_best is not None and skip_best[0] <= best[0]
                and skip_best[0] <= intra_best[0]):
            sk_cost, sk_mv0, sk_mv1, sk_txbs = skip_best
            for plane in range(self.num_planes if is_chroma_ref else 1):
                self._apply_txbs(plane, [t for t in sk_txbs
                                         if t["plane"] == plane])
            bplan = dict(
                mi_row=mi_row, mi_col=mi_col, bsize=bsize, is_inter=1,
                skip_mode=1, mode=MR.NEAREST_NEARESTMV, mv=sk_mv0,
                mv1=sk_mv1, ref=self.fh.skip_mode_refs[0],
                ref1=self.fh.skip_mode_refs[1], ref_mv_idx=0,
                txbs=sk_txbs, gm_warp=False, is_chroma_ref=is_chroma_ref,
                y_mode=c.DC_PRED, uv_mode=c.DC_PRED, cfl=None)
            self._fill_trial(bplan, partition)
            return sk_cost, bplan

        if best[0] <= intra_best[0]:
            cost, mode, mv, txbs, ref, gm_warp, d0, b0 = best
            is_comp = mode == MR.NEAREST_NEARESTMV and best_comp is not None
            mv1 = best_comp if is_comp else None
            ref1 = c.ALTREF_FRAME if is_comp else -1
            # motion-mode trial on the winner (rdopt.c motion_mode_rd):
            # OBMC / WARPED_CAUSAL vs simple translation
            motion_mode = 0
            ii_extra = {}
            scaled_win = self._ref_scaled(ref)
            if (self.fh.is_motion_mode_switchable and not is_comp
                    and not gm_warp and not scaled_win):
                allowed, npr, pts, ptsr = self._motion_mode_allowed_enc(
                    mode, ref, bsize, mi_row, mi_col, partition)
                if allowed != c.SIMPLE_TRANSLATION:
                    lam = self._lam(mi_row, mi_col)
                    sym = 1.0 if allowed == c.OBMC_CAUSAL else 1.6
                    mm_best = d0 + lam * (b0 + sym)
                    d_o, b_o, t_o = self._code_motion_mode_planes(
                        mi_row, mi_col, bsize, mv, ref, c.OBMC_CAUSAL)
                    if d_o + lam * (b_o + sym) < mm_best:
                        mm_best = d_o + lam * (b_o + sym)
                        motion_mode, txbs = c.OBMC_CAUSAL, t_o
                        cost = mm_best
                    if allowed == c.WARPED_CAUSAL:
                        wm = self._warp_model(mv, npr, pts, ptsr, bsize,
                                              mi_row, mi_col)
                        if wm is not None:
                            d_w, b_w_, t_w = self._code_motion_mode_planes(
                                mi_row, mi_col, bsize, mv, ref,
                                c.WARPED_CAUSAL, wm)
                            if d_w + lam * (b_w_ + sym) < mm_best:
                                mm_best = d_w + lam * (b_w_ + sym)
                                motion_mode, txbs = c.WARPED_CAUSAL, t_w
                                cost = mm_best
            # interintra trial on the winner (is_interintra_allowed
            # gates: single-ref, 8x8..32x32, NEARESTMV..NEWMV; mutually
            # exclusive with motion modes at read time)
            if (self.sh.enable_interintra_compound and not is_comp
                    and not gm_warp and not scaled_win
                    and mode in (MR.NEWMV, MR.NEARESTMV, MR.NEARMV)
                    and c.BLOCK_8X8 <= bsize <= c.BLOCK_32X32):
                lam = self._lam(mi_row, mi_col)
                ii_cost, ii_keys, ii_txbs = self._trial_interintra(
                    mi_row, mi_col, bsize, mv, ref, lam)
                if ii_cost < cost and ii_cost < d0 + lam * (b0 + 1.0):
                    cost = ii_cost
                    txbs = ii_txbs
                    motion_mode = 0
                    ii_extra = ii_keys
            # uniform vartx depth search on the winner
            # (av1_pick_recursive_tx_size_type_yrd analog, depth 1);
            # masked-compound / interintra winners keep their own txbs
            # (the depth-1 re-code below predicts with a plain average)
            if self.tx_select and bsize > c.BLOCK_4X4 and not motion_mode \
                    and not ii_extra \
                    and not (is_comp and best_comp_spec is not None):
                from ..decoder.inter import _MAX_DEPTH
                if _MAX_DEPTH[bsize] >= 1:
                    lam = self._lam(mi_row, mi_col)
                    d1, b1, t1 = self._code_inter_planes(
                        mi_row, mi_col, bsize, mv, ref, gm_warp=gm_warp,
                        tx_depth=1, ref1=ref1, mv1=mv1)
                    if d1 + lam * (b1 + 4.0) < d0 + lam * b0:
                        txbs = t1
            self._apply_txbs(0, [t for t in txbs if t["plane"] == 0])
            for plane in (1, 2):
                self._apply_txbs(plane,
                                 [t for t in txbs if t["plane"] == plane])
            bplan = dict(
                mi_row=mi_row, mi_col=mi_col, bsize=bsize, is_inter=1,
                mode=mode, mv=mv, ref=ref, ref_mv_idx=0, txbs=txbs,
                gm_warp=gm_warp, ref1=ref1, mv1=mv1,
                motion_mode=motion_mode,
                is_chroma_ref=is_chroma_ref, y_mode=c.DC_PRED,
                uv_mode=c.DC_PRED, cfl=None, **ii_extra)
            if is_comp and best_comp_spec is not None:
                bplan.update(best_comp_spec)
            self._fill_trial(bplan, partition)
            return cost, bplan
        # intra path (chroma DC)
        cost, y_mode, y_txbs = intra_best
        self._apply_txbs(0, y_txbs)
        uv_txbs = []
        uv_cost = 0.0
        if is_chroma_ref:
            for plane in (1, 2):
                d, b, t = self._code_plane(
                    plane, c.DC_PRED, mi_row, mi_col, bsize, up_avail,
                    left_avail, write_recon=False)
                uv_cost += d + self._lam(mi_row, mi_col) * b
                uv_txbs += t
                self._apply_txbs(plane, t)
        bplan = dict(
            mi_row=mi_row, mi_col=mi_col, bsize=bsize, is_inter=0,
            mode=0, mv=(0, 0), ref=c.INTRA_FRAME, ref_mv_idx=0,
            txbs=y_txbs + uv_txbs,
            is_chroma_ref=is_chroma_ref, y_mode=y_mode, uv_mode=c.DC_PRED,
            cfl=None)
        self._fill_trial(bplan, partition)
        return cost + uv_cost, bplan

    def _est_inter_mode_bits(self, mode, mv, ref_mv, mode_ctx):
        bits = 6.0  # skip+is_inter+ref frames+mode coarse
        if mode == MR.NEWMV:
            dr = abs(mv[0] - ref_mv[0]) >> 1
            dc = abs(mv[1] - ref_mv[1]) >> 1
            bits += 6.0 + (np.log2(dr + 1) + np.log2(dc + 1)) * 2.0
        return bits

    def _motion_mode_preds(self, mi_row, mi_col, bsize, mv, ref,
                           motion_mode, wm=None):
        """Per-plane predictions for OBMC_CAUSAL / WARPED_CAUSAL.

        OBMC writes base preds into the recon scratch, runs the
        decoder's _obmc_blend over it (neighbor preds re-derived from
        the mi grid), and lifts the blended patches back out; recon is
        restored afterwards.  WARPED warps planes whose dims are >= 8
        (decoder _warp_params gate) and falls back to translation MC
        elsewhere."""
        from ..decoder.inter import InterDecoderMixin as D
        bw4 = blockd.mi_size_wide(bsize)
        bh4 = blockd.mi_size_high(bsize)
        mi_x, mi_y = mi_col * 4, mi_row * 4
        mb_to_left = -mi_x
        mb_to_right = (self.mi_cols - bw4 - mi_col) * 4
        mb_to_top = -mi_y
        mb_to_bottom = (self.mi_rows - bh4 - mi_row) * 4
        is_chroma_ref = blockd.is_chroma_reference(
            mi_row, mi_col, bsize, self.ss_x, self.ss_y) \
            and self.num_planes > 1
        nplanes = self.num_planes if is_chroma_ref else 1
        bw_px = blockd.block_wide(bsize)
        bh_px = blockd.block_high(bsize)
        preds = []
        geo = []
        for plane in range(nplanes):
            ss_x = self.ss_x if plane else 0
            ss_y = self.ss_y if plane else 0
            b_w = max(bw_px >> ss_x, 4) if plane else bw_px
            b_h = max(bh_px >> ss_y, 4) if plane else bh_px
            x0 = mi_x >> ss_x
            y0 = mi_y >> ss_y
            geo.append((plane, ss_x, ss_y, x0, y0, b_w, b_h))
            if (motion_mode == c.WARPED_CAUSAL and wm is not None
                    and b_w >= 8 and b_h >= 8
                    and not self.fh.force_integer_mv):
                from ..common import warp as WP
                slot = self.fh.ref_frame_idx[ref - 1]
                pred = np.empty((b_h, b_w), self.refs[slot][plane].dtype)
                WP.warp_affine(wm[0], self.refs[slot][plane], pred,
                               x0, y0, b_w, b_h, ss_x, ss_y, *wm[1],
                               bd=self.bd)
            else:
                pred = IP.predict_inter_block(
                    self._ref_pad(ref, plane), x0, y0, b_w, b_h,
                    mv[0], mv[1], ss_x, ss_y, mb_to_left, mb_to_right,
                    mb_to_top, mb_to_bottom, self.interp_filter,
                    self.interp_filter, self.bd)
            preds.append(pred)
        if motion_mode == c.OBMC_CAUSAL:
            saved = [self.recon[p][y0:y0 + b_h, x0:x0 + b_w].copy()
                     for (p, _sx, _sy, x0, y0, b_w, b_h) in geo]
            for pred, (p, _sx, _sy, x0, y0, b_w, b_h) in zip(preds, geo):
                self.recon[p][y0:y0 + b_h, x0:x0 + b_w] = pred
            bi = InterFrameEncoder._NbInfo()
            bi.bsize = bsize
            D._obmc_blend(self, bi, mi_row, mi_col)
            preds = [self.recon[p][y0:y0 + b_h, x0:x0 + b_w].copy()
                     for (p, _sx, _sy, x0, y0, b_w, b_h) in geo]
            for sv, (p, _sx, _sy, x0, y0, b_w, b_h) in zip(saved, geo):
                self.recon[p][y0:y0 + b_h, x0:x0 + b_w] = sv
        return preds, geo, (mb_to_right, mb_to_bottom)

    def _code_motion_mode_planes(self, mi_row, mi_col, bsize, mv, ref,
                                 motion_mode, wm=None):
        """Transform-code all planes against a motion-mode prediction."""
        preds, geo, (mb_to_right, mb_to_bottom) = self._motion_mode_preds(
            mi_row, mi_col, bsize, mv, ref, motion_mode, wm)
        dist = 0.0
        bits = 0.0
        txbs = []
        for pred, (plane, ss_x, ss_y, x0, y0, _bw, _bh) in zip(preds, geo):
            plane_bsize = blockd.plane_block_size(bsize, ss_x, ss_y) \
                if plane else bsize
            d, b, t = self._code_inter_plane_txbs(
                plane, plane_bsize, pred, x0, y0, mi_row, mi_col, bsize,
                mb_to_right, mb_to_bottom, ss_x, ss_y)
            dist += d
            bits += b
            txbs += t
        return dist, bits, txbs

    def _code_inter_planes(self, mi_row, mi_col, bsize, mv,
                           ref=c.LAST_FRAME, gm_warp=False, tx_depth=0,
                           ref1=-1, mv1=None, force_skip=False,
                           comp_weights=None):
        """Motion-compensate + transform-code all planes for one MV.
        gm_warp: GLOBALMV with a non-translation model — warp planes
        whose dims are >= 8 (decoder _warp_params global branch)."""
        bw4 = blockd.mi_size_wide(bsize)
        bh4 = blockd.mi_size_high(bsize)
        mi_x, mi_y = mi_col * 4, mi_row * 4
        mb_to_left = -mi_x
        mb_to_right = (self.mi_cols - bw4 - mi_col) * 4
        mb_to_top = -mi_y
        mb_to_bottom = (self.mi_rows - bh4 - mi_row) * 4
        is_chroma_ref = blockd.is_chroma_reference(
            mi_row, mi_col, bsize, self.ss_x, self.ss_y) \
            and self.num_planes > 1
        nplanes = self.num_planes if is_chroma_ref else 1
        bw_px = blockd.block_wide(bsize)
        bh_px = blockd.block_high(bsize)
        dist = 0.0
        bits = 0.0
        txbs = []
        for plane in range(nplanes):
            ss_x = self.ss_x if plane else 0
            ss_y = self.ss_y if plane else 0
            plane_bsize = blockd.plane_block_size(bsize, ss_x, ss_y) \
                if plane else bsize
            row_start = -1 if (plane and bh_px == 4 and ss_y) else 0
            col_start = -1 if (plane and bw_px == 4 and ss_x) else 0
            b_w = max(bw_px >> ss_x, 4) if plane else bw_px
            b_h = max(bh_px >> ss_y, 4) if plane else bh_px
            x0 = (mi_x + 4 * col_start) >> ss_x
            y0 = (mi_y + 4 * row_start) >> ss_y
            if gm_warp and b_w >= 8 and b_h >= 8:
                from ..common import warp as WP
                e = self.gm[ref]
                slot = self.fh.ref_frame_idx[ref - 1]
                pred = np.empty((b_h, b_w),
                                self.refs[slot][plane].dtype)
                WP.warp_affine(e[1], self.refs[slot][plane], pred,
                               x0, y0, b_w, b_h, ss_x, ss_y, *e[3],
                               bd=self.bd)
            elif ref1 > c.INTRA_FRAME:
                # COMPOUND_AVERAGE (compound_idx=1) or DIST_WTD
                # (compound_idx=0, comp_weights=(True, fwd, bck))
                use_dw, fo, bo = comp_weights or (False, 8, 8)
                pred = IP.predict_inter_compound(
                    (self._ref_pad(ref, plane), self._ref_pad(ref1, plane)),
                    x0, y0, b_w, b_h, (mv, mv1), ss_x, ss_y,
                    mb_to_left, mb_to_right, mb_to_top, mb_to_bottom,
                    self.interp_filter, self.interp_filter,
                    use_dist_wtd=use_dw, fwd_offset=fo, bck_offset=bo,
                    bd=self.bd)
            elif self._ref_scaled(ref):
                # inter-layer / resized reference (spatial SVC): scaled
                # subpel MC (decoder _mc_single is_scaled branch)
                slot = self.fh.ref_frame_idx[ref - 1]
                rh_, rw_ = self.refs[slot][plane].shape
                pred = IP.predict_inter_block_scaled(
                    self._ref_pad(ref, plane), rw_, rh_, x0, y0, b_w, b_h,
                    mv[0], mv[1], ss_x, ss_y, self._ref_sf(ref),
                    self.interp_filter, self.interp_filter, self.bd)
            else:
                pred = IP.predict_inter_block(
                    self._ref_pad(ref, plane), x0, y0, b_w, b_h,
                    mv[0], mv[1], ss_x, ss_y, mb_to_left, mb_to_right,
                    mb_to_top, mb_to_bottom, self.interp_filter,
                    self.interp_filter, self.bd)
            d, b, t = self._code_inter_plane_txbs(
                plane, plane_bsize, pred, x0, y0, mi_row, mi_col, bsize,
                mb_to_right, mb_to_bottom, ss_x, ss_y,
                tx_depth=tx_depth if plane == 0 else 0,
                force_skip=force_skip)
            dist += d
            bits += b
            txbs += t
        return dist, bits, txbs

    def _block_edges(self, mi_row, mi_col, bsize):
        """(mi_x, mi_y, mb_to_left/right/top/bottom) in luma pels."""
        bw4 = blockd.mi_size_wide(bsize)
        bh4 = blockd.mi_size_high(bsize)
        mi_x, mi_y = mi_col * 4, mi_row * 4
        return (mi_x, mi_y, -mi_x, (self.mi_cols - bw4 - mi_col) * 4,
                -mi_y, (self.mi_rows - bh4 - mi_row) * 4)

    def _compound_bufs_enc(self, plane, mi_row, mi_col, bsize, mv0, r0,
                           mv1, r1):
        """CONV-domain prediction buffers for both refs of one plane
        (decoder _compound_bufs geometry; compound blocks are >= 8x8 so
        no sub-8 chroma offsets apply)."""
        mi_x, mi_y, mtl, mtr, mtt, mtb = self._block_edges(mi_row, mi_col,
                                                           bsize)
        ss_x = self.ss_x if plane else 0
        ss_y = self.ss_y if plane else 0
        bw_px = blockd.block_wide(bsize)
        bh_px = blockd.block_high(bsize)
        b_w = max(bw_px >> ss_x, 4) if plane else bw_px
        b_h = max(bh_px >> ss_y, 4) if plane else bh_px
        x0 = mi_x >> ss_x
        y0 = mi_y >> ss_y
        bufs = IP.compound_conv_bufs(
            (self._ref_pad(r0, plane), self._ref_pad(r1, plane)),
            x0, y0, b_w, b_h, (mv0, mv1), ss_x, ss_y, mtl, mtr, mtt, mtb,
            self.interp_filter, self.interp_filter, bd=self.bd)
        return bufs, (ss_x, ss_y, x0, y0, b_w, b_h, mtr, mtb)

    def _trial_masked_compound(self, mi_row, mi_col, bsize, mv0, r0, mv1,
                               r1, lam):
        """Candidate (cost, spec, txbs) triples for WEDGE and DIFFWTD
        masked compound.  Mask pre-selection by luma SSE of the blended
        prediction (pick_wedge / pick_interinter_mask analog,
        compound_type.c:282), then one full transform-code RD per type."""
        bufs, (_sx, _sy, x0, y0, b_w, b_h, _mr, _mb) = \
            self._compound_bufs_enc(0, mi_row, mi_col, bsize, mv0, r0,
                                    mv1, r1)
        src = self.src[0][y0:y0 + b_h, x0:x0 + b_w].astype(np.int64)
        out = []
        wedge_used = bsize in WEDGE_SIZES
        if wedge_used:
            best = None
            for sign in (0, 1):
                for widx in range(16):
                    mask = IP.wedge_mask(bsize, sign, widx)
                    blend = IP.blend_a64_d16(bufs[0], bufs[1], mask, 0, 0,
                                             self.bd)
                    sse = float(((src - blend) ** 2).sum())
                    if best is None or sse < best[0]:
                        best = (sse, sign, widx)
            _, ws, wi = best
            d, b, t = self._code_compound_masked(
                mi_row, mi_col, bsize, mv0, r0, mv1, r1, comp_type=1,
                wedge_index=wi, wedge_sign=ws)
            # comp flag + ref tree + mode (5) + comp_group(1)
            # + compound_type(1) + wedge idx(4) + sign(1)
            b += 12.0
            out.append((d + lam * b,
                        dict(comp_group_idx=1, comp_type=1,
                             wedge_index=wi, wedge_sign=ws), t))
        best_mt = None
        for mt in (0, 1):
            mask = IP.diffwtd_mask_d16(bufs[0], bufs[1], bool(mt), self.bd)
            blend = IP.blend_a64_d16(bufs[0], bufs[1], mask, 0, 0, self.bd)
            sse = float(((src - blend) ** 2).sum())
            if best_mt is None or sse < best_mt[0]:
                best_mt = (sse, mt)
        mt = best_mt[1]
        d, b, t = self._code_compound_masked(
            mi_row, mi_col, bsize, mv0, r0, mv1, r1, comp_type=2,
            mask_type=mt)
        b += 5.0 + 1.0 + (1.0 if wedge_used else 0.0) + 1.0
        out.append((d + lam * b,
                    dict(comp_group_idx=1, comp_type=2, mask_type=mt), t))
        return out

    def _code_compound_masked(self, mi_row, mi_col, bsize, mv0, r0, mv1,
                              r1, comp_type, wedge_index=0, wedge_sign=0,
                              mask_type=0):
        """Transform-code all planes against a masked-compound blend
        (decoder comp_group_idx branch mirror: wedge mask at luma
        resolution subsampled per plane; diffwtd mask derived from the
        plane-0 CONV buffers)."""
        is_chroma_ref = blockd.is_chroma_reference(
            mi_row, mi_col, bsize, self.ss_x, self.ss_y) \
            and self.num_planes > 1
        nplanes = self.num_planes if is_chroma_ref else 1
        dist = 0.0
        bits = 0.0
        txbs = []
        diff_mask = None
        for plane in range(nplanes):
            bufs, (ss_x, ss_y, x0, y0, _bw, _bh, mtr, mtb) = \
                self._compound_bufs_enc(plane, mi_row, mi_col, bsize,
                                        mv0, r0, mv1, r1)
            if comp_type == 1:
                mask = IP.wedge_mask(bsize, wedge_sign, wedge_index)
            else:
                if plane == 0:
                    diff_mask = IP.diffwtd_mask_d16(bufs[0], bufs[1],
                                                    bool(mask_type),
                                                    self.bd)
                mask = diff_mask
            pred = IP.blend_a64_d16(bufs[0], bufs[1], mask, ss_x, ss_y,
                                    self.bd)
            plane_bsize = blockd.plane_block_size(bsize, ss_x, ss_y) \
                if plane else bsize
            d, b, t = self._code_inter_plane_txbs(
                plane, plane_bsize, pred, x0, y0, mi_row, mi_col, bsize,
                mtr, mtb, ss_x, ss_y)
            dist += d
            bits += b
            txbs += t
        return dist, bits, txbs

    def _comp_group_ctx_enc(self, mi_row, mi_col, up, left):
        """get_comp_group_idx_context (pred_common.h:141) over the
        encoder mi grids (decoder _comp_group_idx_ctx mirror)."""
        g, m = self.g, self.g.m
        a = l_ = 0
        if up:
            r, cc = mi_row - 1 + m, mi_col + m
            if g.ref1[r, cc] > c.INTRA_FRAME:
                a = int(self.comp_group_grid[r, cc])
            elif g.ref0[r, cc] == c.ALTREF_FRAME:
                a = 3
        if left:
            r, cc = mi_row + m, mi_col - 1 + m
            if g.ref1[r, cc] > c.INTRA_FRAME:
                l_ = int(self.comp_group_grid[r, cc])
            elif g.ref0[r, cc] == c.ALTREF_FRAME:
                l_ = 3
        return min(5, a + l_)

    _II_TO_INTRA = (c.DC_PRED, c.V_PRED, c.H_PRED, c.SMOOTH_PRED)

    def _interintra_intra_pred(self, plane, x0, y0, b_w, b_h, ii_mode,
                               ss_x, ss_y, mi_row, mi_col, bsize):
        """Intra half of the interintra blend against the current recon
        (decoder _interintra_blend mirror; our sequences always carry
        enable_intra_edge_filter=0 so the edge-filter type is moot)."""
        from ..common import intra
        mode = self._II_TO_INTRA[ii_mode]
        up_avail = mi_row > 0
        left_avail = mi_col > 0
        bw_mi = blockd.mi_size_wide(bsize)
        bh_mi = blockd.mi_size_high(bsize)
        xr = ((self.mi_cols - bw_mi - mi_col) * 4) >> ss_x
        yd = ((self.mi_rows - bh_mi - mi_row) * 4) >> ss_y
        return intra.build_intra_predictor(
            self.recon[plane], x0, y0, b_w, b_h, mode, 0, -1,
            n_top_px=min(b_w, xr + b_w) if up_avail else 0,
            n_topright_px=-1,
            n_left_px=min(b_h, yd + b_h) if left_avail else 0,
            n_bottomleft_px=-1,
            disable_edge_filter=not self.sh.enable_intra_edge_filter,
            intra_edge_filter_type=0, bd=self.bd)

    def _code_interintra_planes(self, mi_row, mi_col, bsize, mv, ref,
                                ii_mode, use_wedge=0, wedge_index=0):
        """Transform-code all planes against an interintra blend
        (av1_build_interintra_predictor mirror)."""
        mi_x, mi_y, mtl, mtr, mtt, mtb = self._block_edges(mi_row, mi_col,
                                                           bsize)
        is_chroma_ref = blockd.is_chroma_reference(
            mi_row, mi_col, bsize, self.ss_x, self.ss_y) \
            and self.num_planes > 1
        nplanes = self.num_planes if is_chroma_ref else 1
        bw_px = blockd.block_wide(bsize)
        bh_px = blockd.block_high(bsize)
        dist = 0.0
        bits = 0.0
        txbs = []
        for plane in range(nplanes):
            ss_x = self.ss_x if plane else 0
            ss_y = self.ss_y if plane else 0
            b_w = max(bw_px >> ss_x, 4) if plane else bw_px
            b_h = max(bh_px >> ss_y, 4) if plane else bh_px
            x0 = mi_x >> ss_x
            y0 = mi_y >> ss_y
            inter_pred = IP.predict_inter_block(
                self._ref_pad(ref, plane), x0, y0, b_w, b_h,
                mv[0], mv[1], ss_x, ss_y, mtl, mtr, mtt, mtb,
                self.interp_filter, self.interp_filter, self.bd)
            ipred = self._interintra_intra_pred(
                plane, x0, y0, b_w, b_h, ii_mode, ss_x, ss_y, mi_row,
                mi_col, bsize)
            if use_wedge:
                # INTERINTRA_WEDGE_SIGN == 0 (blockd.h:40)
                mask = IP.wedge_mask(bsize, 0, wedge_index)
                pred = IP.blend_a64_mask_pixel(ipred, inter_pred, mask,
                                               ss_x, ss_y)
            else:
                pb = blockd.plane_block_size(bsize, ss_x, ss_y)
                mask = IP.smooth_interintra_mask(pb, ii_mode)
                pred = IP.blend_a64_mask_pixel(ipred, inter_pred, mask,
                                               0, 0)
            plane_bsize = blockd.plane_block_size(bsize, ss_x, ss_y) \
                if plane else bsize
            d, b, t = self._code_inter_plane_txbs(
                plane, plane_bsize, pred, x0, y0, mi_row, mi_col, bsize,
                mtr, mtb, ss_x, ss_y)
            dist += d
            bits += b
            txbs += t
        return dist, bits, txbs

    def _trial_interintra(self, mi_row, mi_col, bsize, mv, ref, lam):
        """(cost_proxy, extra-bplan-keys, txbs) for the best interintra
        configuration, or None.  Mode pre-selection by luma SSE over the
        4 smooth blends, wedge index likewise (interintra mode loop of
        rdopt.c / compound_type.c pick_interintra_mask)."""
        mi_x, mi_y, mtl, mtr, mtt, mtb = self._block_edges(mi_row, mi_col,
                                                           bsize)
        bw_px = blockd.block_wide(bsize)
        bh_px = blockd.block_high(bsize)
        inter_pred = IP.predict_inter_block(
            self._ref_pad(ref, 0), mi_x, mi_y, bw_px, bh_px, mv[0], mv[1],
            0, 0, mtl, mtr, mtt, mtb, self.interp_filter,
            self.interp_filter, self.bd)
        src = self.src[0][mi_y:mi_y + bh_px,
                          mi_x:mi_x + bw_px].astype(np.int64)
        best_m = None
        ipreds = []
        for iim in range(c.INTERINTRA_MODES):
            ipred = self._interintra_intra_pred(
                0, mi_x, mi_y, bw_px, bh_px, iim, 0, 0, mi_row, mi_col,
                bsize)
            ipreds.append(ipred)
            mask = IP.smooth_interintra_mask(bsize, iim)
            blend = IP.blend_a64_mask_pixel(ipred, inter_pred, mask, 0, 0)
            sse = float(((src - blend) ** 2).sum())
            if best_m is None or sse < best_m[0]:
                best_m = (sse, iim)
        iim = best_m[1]
        d, b, t = self._code_interintra_planes(mi_row, mi_col, bsize, mv,
                                               ref, iim)
        sym = 3.0 + (1.0 if bsize in WEDGE_SIZES else 0.0)
        out = (d + lam * (b + sym),
               dict(interintra=1, interintra_mode=iim,
                    use_wedge_interintra=0), t)
        if bsize in WEDGE_SIZES:
            best_w = None
            for widx in range(16):
                mask = IP.wedge_mask(bsize, 0, widx)
                blend = IP.blend_a64_mask_pixel(ipreds[iim], inter_pred,
                                                mask, 0, 0)
                sse = float(((src - blend) ** 2).sum())
                if best_w is None or sse < best_w[0]:
                    best_w = (sse, widx)
            widx = best_w[1]
            d, b, t = self._code_interintra_planes(
                mi_row, mi_col, bsize, mv, ref, iim, use_wedge=1,
                wedge_index=widx)
            cost_w = d + lam * (b + sym + 4.0)
            if cost_w < out[0]:
                out = (cost_w,
                       dict(interintra=1, interintra_mode=iim,
                            use_wedge_interintra=1,
                            interintra_wedge_index=widx), t)
        return out

    def _code_inter_plane_txbs(self, plane, plane_bsize, pred, x0, y0,
                               mi_row, mi_col, bsize, mb_to_right,
                               mb_to_bottom, ss_x, ss_y, tx_depth=0,
                               force_skip=False):
        from ..decoder.inter import SUB_TX_SIZE_MAP, depth_to_tx_size
        tx_size = self._plane_tx(plane, bsize)
        if tx_depth and plane == 0:
            tx_size = depth_to_tx_size(tx_depth, bsize)
        txw4 = c.TX_WIDTH[tx_size] >> 2
        txh4 = c.TX_HEIGHT[tx_size] >> 2
        pbw = blockd.block_wide(plane_bsize)
        pbh = blockd.block_high(plane_bsize)
        vis_w = pbw + (min(mb_to_right, 0) >> ss_x)
        vis_h = pbh + (min(mb_to_bottom, 0) >> ss_y)
        reduced = bool(self.fh.reduced_tx_set)
        tx_type = c.DCT_DCT
        tx_type_sym = None
        if plane == 0:
            st = TT.ext_tx_set_type(tx_size, True, reduced)
            if TT.NUM_EXT_TX_SET[st] > 1:
                eset = TT.inter_ext_tx_idx(st)
                sqr = c.TX_SIZE_SQR[tx_size]
                tx_type_sym = (("inter_ext_tx_cdf", eset, sqr),
                               TT.EXT_TX_IND[st][tx_type],
                               TT.NUM_EXT_TX_SET[st])
        pq = self.pq[plane]
        adj = CF.adjusted_tx_size(tx_size)
        from ..bitstream import tables
        scan = tables.scan(adj, tx_type)
        log_scale = CF._tx_scale(tx_size)
        dist = 0.0
        bits = 0.0
        txbs = []
        for r4 in range(0, max(vis_h >> 2, 1), txh4):
            for c4 in range(0, max(vis_w >> 2, 1), txw4):
                py = y0 + r4 * 4
                px = x0 + c4 * 4
                p = pred[r4 * 4:r4 * 4 + c.TX_HEIGHT[tx_size],
                         c4 * 4:c4 * 4 + c.TX_WIDTH[tx_size]]
                src = self.src[plane][py:py + p.shape[0], px:px + p.shape[1]]
                if force_skip:
                    # skip-mode: zero residual by construction
                    dist += float(((src.astype(np.int64)
                                    - p.astype(np.int64)) ** 2).sum())
                    txbs.append(dict(
                        plane=plane, tx_size=tx_size, tx_type=c.DCT_DCT,
                        tx_type_sym=None,
                        qcoeff=np.zeros(p.shape, np.int32), eob=0,
                        plane_bsize=plane_bsize, py=py, px=px,
                        recon=p.copy(), acol=px >> 2, lrow=py >> 2,
                        loc_c4=c4, loc_r4=r4,
                        vis_w4=max(vis_w >> 2, 1), vis_h4=max(vis_h >> 2, 1),
                        cross_r=mb_to_right < 0, cross_b=mb_to_bottom < 0))
                    continue
                resid = src.astype(np.int32) - p.astype(np.int32)
                coeff = T2.fwd_txfm2d(resid, tx_size, tx_type, self.bd)
                qcoeff, dqcoeff, eob = Q.quantize_b(coeff, scan, pq,
                                                    log_scale)
                if self.trellis and eob:
                    qcoeff, dqcoeff, eob = Q.optimize_txb(
                        qcoeff, dqcoeff, coeff, scan, pq, log_scale, eob,
                        self._lam(mi_row, mi_col),
                        Q.tx_gain(tx_size, tx_type))
                recon = (T2.inv_txfm2d_add(dqcoeff, p, tx_size, tx_type,
                                           self.bd)
                         if eob else p.copy())
                dist += float(((src.astype(np.int64)
                                - recon.astype(np.int64)) ** 2).sum())
                bits += self._est_txb_bits(qcoeff, eob)
                txbs.append(dict(
                    plane=plane, tx_size=tx_size, tx_type=tx_type,
                    tx_type_sym=tx_type_sym, qcoeff=qcoeff, eob=eob,
                    plane_bsize=plane_bsize, py=py, px=px, recon=recon,
                    acol=px >> 2, lrow=py >> 2,
                    loc_c4=c4, loc_r4=r4,
                    vis_w4=max(vis_w >> 2, 1), vis_h4=max(vis_h >> 2, 1),
                    cross_r=mb_to_right < 0, cross_b=mb_to_bottom < 0))
        return dist, bits, txbs

    def _lf_grids(self, mh, mw):
        m = self.g.m
        ref_grid = self.g.ref0[m:m + mh, m:m + mw].astype(np.int32)
        mode_grid = self.g.mode[m:m + mh, m:m + mw].astype(np.int32)
        skip_inter = (self.mi_skip.astype(np.uint8)
                      & (ref_grid > 0).astype(np.uint8))
        return ref_grid, mode_grid, skip_inter

    # --- emit -------------------------------------------------------------

    def _emit_block(self, bplan, partition):
        mi_row, mi_col, bsize = bplan["mi_row"], bplan["mi_col"], \
            bplan["bsize"]
        bw = blockd.mi_size_wide(bsize)
        bh = blockd.mi_size_high(bsize)
        up_avail = mi_row > 0
        left_avail = mi_col > 0
        txbs = bplan["txbs"]
        skip = all(t["eob"] == 0 for t in txbs)
        is_inter = bplan["is_inter"]

        above_mi = (mi_row - 1, mi_col) if up_avail else None
        left_mi = (mi_row, mi_col - 1) if left_avail else None
        # skip mode (decoder read_skip_mode mirror: before skip_txfm;
        # a skip-mode block implies skip_txfm=1 and is_inter=1, neither
        # coded)
        sk_mode = bplan.get("skip_mode", 0)
        if (self.fh.skip_mode_flag and not self.fh.segmentation_enabled
                and min(blockd.block_wide(bsize),
                        blockd.block_high(bsize)) >= 8):
            smctx = MR.skip_mode_ctx(self.g, mi_row, mi_col, up_avail,
                                     left_avail, self.skip_mode_grid)
            self.sink.symbol(sk_mode, 2, "skip_mode_cdfs", smctx)
        else:
            assert not sk_mode
        if not sk_mode:
            skip_ctx = (int(self.mi_skip[above_mi]) if above_mi else 0) + \
                       (int(self.mi_skip[left_mi]) if left_mi else 0)
            self.sink.symbol(int(skip), 2, "skip_txfm_cdfs", skip_ctx)

        # delta-q (read_delta_q_params: after skip/cdef, before is_inter;
        # cdef_bits == 0 in this encoder so no cdef symbols intervene)
        if self.fh.delta_q_present:
            sbm = self.sb_mi
            first = (mi_row & (sbm - 1)) == 0 and (mi_col & (sbm - 1)) == 0
            if first and (bsize != self.sb_size or not skip):
                tgt = self._block_qindex(mi_row, mi_col)
                d = (tgt - self._emit_cur_q) >> self.fh.delta_q_res_log2
                self._write_delta_q(d)
                self._emit_cur_q = tgt

        if not sk_mode:
            ii_ctx = MR.intra_inter_ctx(self.g, mi_row, mi_col, up_avail,
                                        left_avail)
            self.sink.symbol(int(is_inter), 2, "intra_inter_cdf", ii_ctx)

        from .lossy import MAX_ANGLE_DELTA
        from ..common import intra
        from ..decoder.inter import SIZE_GROUP
        emitted_mode = bplan["mode"]
        if sk_mode:
            emitted_mode = MR.NEAREST_NEARESTMV   # fully derived, no syms
        elif is_inter:
            emitted_mode = self._emit_inter_info(
                bplan, mi_row, mi_col, bsize, up_avail, left_avail,
                partition)
        else:
            y_mode = bplan["y_mode"]
            self.sink.symbol(y_mode, c.INTRA_MODES, "y_mode_cdf",
                             SIZE_GROUP[bsize])
            use_angle_delta = bsize >= c.BLOCK_8X8
            if use_angle_delta and intra.is_directional(y_mode):
                self.sink.symbol(MAX_ANGLE_DELTA + bplan.get("y_angle", 0),
                                 2 * MAX_ANGLE_DELTA + 1,
                                 "angle_delta_cdf", y_mode - c.V_PRED)
            if bplan["is_chroma_ref"]:
                cfl_allowed = self._cfl_allowed_enc(bsize)
                self.sink.symbol(
                    bplan["uv_mode"],
                    c.UV_INTRA_MODES - int(not cfl_allowed),
                    "uv_mode_cdf", int(cfl_allowed), y_mode)
                uv_mode = bplan["uv_mode"]
                uv_base = uv_mode if uv_mode < c.UV_CFL_PRED else c.DC_PRED
                if use_angle_delta and intra.is_directional(uv_base):
                    self.sink.symbol(MAX_ANGLE_DELTA,
                                     2 * MAX_ANGLE_DELTA + 1,
                                     "angle_delta_cdf", uv_mode - c.V_PRED)

        # mi bookkeeping
        rmax = min(mi_row + bh, self.mi_rows)
        cmax = min(mi_col + bw, self.mi_cols)
        m = self.g.m
        self.skip_mode_grid[mi_row + m:rmax + m,
                            mi_col + m:cmax + m] = sk_mode
        self.mi_skip[mi_row:rmax, mi_col:cmax] = int(skip)
        if self.sh.enable_ref_frame_mvs:
            self._store_frame_mvs(bplan, mi_row, mi_col, rmax, cmax,
                                  is_inter)
        self.mi_mode[mi_row:rmax, mi_col:cmax] = \
            emitted_mode if is_inter else bplan["y_mode"]
        self.mi_bsize[mi_row:rmax, mi_col:cmax] = bsize
        emit_ref1 = bplan.get("ref1", -1) if is_inter else -1
        if is_inter and bplan.get("interintra", 0):
            emit_ref1 = c.INTRA_FRAME
        self.g.fill_block(
            mi_row, mi_col, bh, bw,
            bplan.get("ref", c.LAST_FRAME) if is_inter else c.INTRA_FRAME,
            emit_ref1,
            emitted_mode if is_inter else bplan["y_mode"], bsize,
            partition, bplan["mv"],
            bplan.get("mv1") or (0, 0))
        self.comp_group_grid[mi_row + m:rmax + m, mi_col + m:cmax + m] = \
            bplan.get("comp_group_idx", 0) if is_inter else 0
        self.comp_idx_grid[mi_row + m:rmax + m, mi_col + m:cmax + m] = \
            bplan.get("compound_idx", 1) if is_inter else 1

        # block tx size (decoder _read_block_tx_size mirror)
        if self.tx_select:
            self._emit_block_tx_size(mi_row, mi_col, bsize, skip,
                                     is_inter, txbs)

        # residual
        if skip and is_inter:
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

    def _store_frame_mvs(self, bplan, mi_row, mi_col, rmax, cmax,
                         is_inter):
        """av1_copy_frame_mvs mirror (decoder _copy_frame_mvs /
        intra reset): per-8x8 MV storage consumed by future frames'
        motion-field projection."""
        r0, c0 = mi_row >> 1, mi_col >> 1
        y2 = (rmax - mi_row + 1) >> 1
        x2 = (cmax - mi_col + 1) >> 1
        if not is_inter:
            self.frame_mvs_ref[r0:r0 + y2, c0:c0 + x2] = -1
            return
        ref = -1
        mv = (0, 0)
        refs = (bplan.get("ref", c.LAST_FRAME), bplan.get("ref1", -1))
        mvs = (bplan["mv"], bplan.get("mv1") or (0, 0))
        for idx in range(2):
            rf = refs[idx]
            if rf > c.INTRA_FRAME:
                if self.ref_side[rf]:
                    continue
                if abs(mvs[idx][0]) > 4095 or abs(mvs[idx][1]) > 4095:
                    continue
                ref = rf
                mv = mvs[idx]
        self.frame_mvs_ref[r0:r0 + y2, c0:c0 + x2] = ref
        self.frame_mvs[r0:r0 + y2, c0:c0 + x2, 0] = mv[0]
        self.frame_mvs[r0:r0 + y2, c0:c0 + x2, 1] = mv[1]

    def _tx_size_ctx_enc(self, mi_row, mi_col, bsize):
        """get_tx_size_context with the inter-neighbour bsize override
        (decoder/inter.py _tx_size_ctx; lossy version is the key-frame
        simplification)."""
        g = self.g
        m = g.m
        max_tx = blockd.max_tx_size_rect(bsize)
        max_w = c.TX_WIDTH[max_tx]
        max_h = c.TX_HEIGHT[max_tx]
        up = mi_row > 0
        left = mi_col > 0
        above = int(self.above_txfm[mi_col]) >= max_w
        lft = int(self.left_txfm[mi_row]) >= max_h
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

    def _txfm_partition_ctx_enc(self, bsize, tx_size, mi_row, mi_col,
                                blk_row, blk_col):
        """txfm_partition_context mirror (decoder/inter.py:1003)."""
        from ..decoder.inter import _sqr_tx_of_dim
        txw = c.TX_WIDTH[tx_size]
        txh = c.TX_HEIGHT[tx_size]
        above = int(self.above_txfm[mi_col + blk_col]) < txw
        left = int(self.left_txfm[mi_row + blk_row]) < txh
        if tx_size <= c.TX_4X4:
            return 0
        max_tx = _sqr_tx_of_dim(max(blockd.block_wide(bsize),
                                    blockd.block_high(bsize)))
        category = 21
        if max_tx >= c.TX_8X8:
            category = int(c.TX_SIZE_SQR_UP[tx_size] != max_tx
                           and max_tx > c.TX_8X8) + (5 - 1 - max_tx) * 2
        return category * 3 + above + left

    def _txfm_partition_update_enc(self, mi_row, mi_col, blk_row, blk_col,
                                   tx_size, txb_size):
        bh = c.TX_HEIGHT[txb_size] >> 2
        bw = c.TX_WIDTH[txb_size] >> 2
        self.above_txfm[mi_col + blk_col:mi_col + blk_col + bw] = \
            c.TX_WIDTH[tx_size]
        self.left_txfm[mi_row + blk_row:mi_row + blk_row + bh] = \
            c.TX_HEIGHT[tx_size]

    def _emit_vartx_unit(self, bsize, tx_size, depth, blk_row, blk_col,
                         mi_row, mi_col, leaf_tx):
        """write_tx_size_vartx (bitstream.c) mirroring
        decoder._read_tx_size_vartx; uniform leaves only."""
        from ..decoder.inter import MAX_VARTX_DEPTH, SUB_TX_SIZE_MAP
        h4 = blockd.mi_size_high(bsize)
        w4 = blockd.mi_size_wide(bsize)
        if mi_row + h4 > self.mi_rows:
            h4 = self.mi_rows - mi_row
        if mi_col + w4 > self.mi_cols:
            w4 = self.mi_cols - mi_col
        if blk_row >= h4 or blk_col >= w4:
            return
        if depth == MAX_VARTX_DEPTH:
            self._txfm_partition_update_enc(mi_row, mi_col, blk_row,
                                            blk_col, tx_size, tx_size)
            return
        ctx = self._txfm_partition_ctx_enc(bsize, tx_size, mi_row, mi_col,
                                           blk_row, blk_col)
        split = tx_size != leaf_tx
        self.sink.symbol(int(split), 2, "txfm_partition_cdf", ctx)
        if not split:
            self._txfm_partition_update_enc(mi_row, mi_col, blk_row,
                                            blk_col, tx_size, tx_size)
            return
        sub_txs = SUB_TX_SIZE_MAP[tx_size]
        if sub_txs == c.TX_4X4:
            self._txfm_partition_update_enc(mi_row, mi_col, blk_row,
                                            blk_col, sub_txs, tx_size)
            return
        bsw = c.TX_WIDTH[sub_txs] >> 2
        bsh = c.TX_HEIGHT[sub_txs] >> 2
        for row in range(0, c.TX_HEIGHT[tx_size] >> 2, bsh):
            for col in range(0, c.TX_WIDTH[tx_size] >> 2, bsw):
                self._emit_vartx_unit(bsize, sub_txs, depth + 1,
                                      blk_row + row, blk_col + col,
                                      mi_row, mi_col, leaf_tx)

    def _emit_block_tx_size(self, mi_row, mi_col, bsize, skip, is_inter,
                            txbs):
        """Inter: vartx tree (uniform leaves); intra-in-inter: selected
        tx-size depth symbol.  Mirrors decoder._read_block_tx_size."""
        from ..decoder.inter import (_MAX_DEPTH, _TX_SIZE_CAT,
                                     SUB_TX_SIZE_MAP)
        bw = blockd.mi_size_wide(bsize)
        bh = blockd.mi_size_high(bsize)
        rmax = min(mi_row + bh, self.mi_rows)
        cmax = min(mi_col + bw, self.mi_cols)

        def fill_grid(tx):
            # deblock edge grids (decoder _finish_block tx grid fill)
            self.txw4_grid[mi_row:rmax, mi_col:cmax] = c.TX_WIDTH[tx] >> 2
            self.txh4_grid[mi_row:rmax, mi_col:cmax] = c.TX_HEIGHT[tx] >> 2

        if bsize == c.BLOCK_4X4:
            tx = blockd.max_tx_size_rect(bsize)
            self.above_txfm[mi_col:mi_col + bw] = c.TX_WIDTH[tx]
            self.left_txfm[mi_row:mi_row + bh] = c.TX_HEIGHT[tx]
            fill_grid(tx)
            return
        if is_inter:
            if skip:
                self.above_txfm[mi_col:mi_col + bw] = bw * 4
                self.left_txfm[mi_row:mi_row + bh] = bh * 4
                fill_grid(blockd.max_tx_size_rect(bsize))
                return
            leaf = next(t["tx_size"] for t in txbs if t["plane"] == 0)
            fill_grid(leaf)
            max_tx = blockd.max_tx_size_rect(bsize)
            bh4 = c.TX_HEIGHT[max_tx] >> 2
            bw4 = c.TX_WIDTH[max_tx] >> 2
            for idy in range(0, bh, bh4):
                for idx in range(0, bw, bw4):
                    self._emit_vartx_unit(bsize, max_tx, 0, idy, idx,
                                          mi_row, mi_col, leaf)
            return
        # intra block in an inter frame: uniform depth symbol
        tx = next(t["tx_size"] for t in txbs if t["plane"] == 0)
        depth = 0
        t_ = blockd.max_tx_size_rect(bsize)
        while t_ != tx:
            t_ = SUB_TX_SIZE_MAP[t_]
            depth += 1
        ctx = self._tx_size_ctx_enc(mi_row, mi_col, bsize)
        self.sink.symbol(depth, _MAX_DEPTH[bsize] + 1, "tx_size_cdf",
                         _TX_SIZE_CAT[bsize], ctx)
        self.above_txfm[mi_col:mi_col + bw] = c.TX_WIDTH[tx]
        self.left_txfm[mi_row:mi_row + bh] = c.TX_HEIGHT[tx]
        fill_grid(tx)

    def _emit_inter_info(self, bplan, mi_row, mi_col, bsize, up_avail,
                         left_avail, partition=c.PARTITION_NONE):
        """Write ref frame + mode + mv symbols; the mode is re-derived at
        emit time for the planned MV (the trial ran with a stale mv stack,
        so NEAREST/NEAR may map differently here).  Returns the mode."""
        mv = bplan["mv"]
        ref = bplan.get("ref", c.LAST_FRAME)
        ref1 = bplan.get("ref1", -1)
        is_comp = ref1 > c.INTRA_FRAME
        counts = MR.neighbors_ref_counts(self.g, mi_row, mi_col, up_avail,
                                         left_avail)
        if self.fh.reference_mode == c.REFERENCE_MODE_SELECT:
            from ..decoder.inter import InterDecoderMixin as D
            comp_allowed = min(blockd.block_wide(bsize),
                               blockd.block_high(bsize)) >= 8
            if comp_allowed:
                rmctx = D._reference_mode_ctx(self, self.g, mi_row, mi_col,
                                              up_avail, left_avail)
                self.sink.symbol(int(is_comp), 2, "comp_inter_cdf", rmctx)
            if is_comp:
                # BIDIR (LAST, ALTREF): decoder _read_comp_ref_frames
                ctctx = D._comp_ref_type_ctx(self, self.g, mi_row, mi_col,
                                             up_avail, left_avail)
                self.sink.symbol(1, 2, "comp_ref_type_cdf", ctctx)
                self.sink.symbol(0, 2, "comp_ref_cdf",
                                 MR.ctx_single_ref_p3(counts), 0)
                self.sink.symbol(0, 2, "comp_ref_cdf",
                                 MR.ctx_single_ref_p4(counts), 1)
                self.sink.symbol(1, 2, "comp_bwdref_cdf",
                                 MR.ctx_single_ref_p2(counts), 0)
        if is_comp:
            return self._emit_compound_mode(bplan, mi_row, mi_col, bsize,
                                            partition)
        for (col, rctx, bit) in _single_ref_tree(ref, counts):
            self.sink.symbol(bit, 2, "single_ref_cdf", rctx, col)

        ctx = self._refmv_context(mi_row, mi_col, bsize, partition)
        gm_mv = self._gm_mv(ref, bsize, mi_row, mi_col)
        stack, weights, count, mode_ctx, mv_list = MR.find_mv_refs(
            ctx, ref, sign_bias=self.sign_bias, tmvp=self.tmvp,
            gm=self._gm_info(gm_mv))
        nearest = MR.lower_mv_precision(mv_list[0],
                                        self.fh.allow_high_precision_mv,
                                        self.fh.force_integer_mv)
        near = MR.lower_mv_precision(mv_list[1],
                                     self.fh.allow_high_precision_mv,
                                     self.fh.force_integer_mv)
        if bplan.get("gm_warp"):
            # trial predicted with the global warp: only GLOBALMV decodes
            # with warp, so the mode choice is forced
            mode = MR.GLOBALMV
        elif mv == nearest:
            mode = MR.NEARESTMV
        elif mv == near:
            mode = MR.NEARMV
        elif mv == gm_mv and not self._gm_would_warp(ref, bsize):
            mode = MR.GLOBALMV
        else:
            mode = MR.NEWMV

        newmv_ctx = mode_ctx & MR.NEWMV_CTX_MASK
        self.sink.symbol(0 if mode == MR.NEWMV else 1, 2, "newmv_cdf",
                         newmv_ctx)
        if mode != MR.NEWMV:
            zeromv_ctx = (mode_ctx >> MR.GLOBALMV_OFFSET) & \
                MR.GLOBALMV_CTX_MASK
            self.sink.symbol(0 if mode == MR.GLOBALMV else 1, 2,
                             "zeromv_cdf", zeromv_ctx)
            if mode != MR.GLOBALMV:
                refmv_ctx = (mode_ctx >> MR.REFMV_OFFSET) & \
                    MR.REFMV_CTX_MASK
                self.sink.symbol(0 if mode == MR.NEARESTMV else 1, 2,
                                 "refmv_cdf", refmv_ctx)
        # drl (ref_mv_idx always 0 for us)
        if mode == MR.NEWMV:
            for idx in range(2):
                if count > idx + 1:
                    dctx = MR.drl_ctx(weights, idx)
                    self.sink.symbol(0, 2, "drl_cdf", dctx)
                    break
        elif MR.have_nearmv(mode):
            for idx in range(1, 3):
                if count > idx + 1:
                    dctx = MR.drl_ctx(weights, idx)
                    self.sink.symbol(0, 2, "drl_cdf", dctx)
                    break
        if mode == MR.NEWMV:
            ref_mv = nearest
            if count > 1:
                ref_mv = stack[0]
            self._write_mv(mv, ref_mv)
        # interintra (decodemv.c:1382 read mirror: after MVs, before
        # motion mode; every gated block carries the flag symbol)
        ii = bplan.get("interintra", 0)
        if (self.sh.enable_interintra_compound
                and c.BLOCK_8X8 <= bsize <= c.BLOCK_32X32
                and MR.NEARESTMV <= mode <= MR.NEWMV):
            from ..decoder.inter import SIZE_GROUP
            bsg = SIZE_GROUP[bsize]
            self.sink.symbol(int(bool(ii)), 2, "interintra_cdf", bsg)
            if ii:
                self.sink.symbol(bplan["interintra_mode"],
                                 c.INTERINTRA_MODES,
                                 "interintra_mode_cdf", bsg)
                if bsize in WEDGE_SIZES:
                    uw = bplan.get("use_wedge_interintra", 0)
                    self.sink.symbol(uw, 2, "wedge_interintra_cdf", bsize)
                    if uw:
                        self.sink.symbol(
                            bplan["interintra_wedge_index"], 16,
                            "wedge_idx_cdf", bsize)
        else:
            assert not ii
        # motion mode (decodemv.c:226 read_motion_mode write mirror;
        # not read for interintra blocks)
        if self.fh.is_motion_mode_switchable and not ii:
            allowed, _npr, _pts, _ptsr = self._motion_mode_allowed_enc(
                mode, ref, bsize, mi_row, mi_col, partition)
            mm = bplan.get("motion_mode", 0)
            if allowed == c.OBMC_CAUSAL:
                self.sink.symbol(1 if mm == c.OBMC_CAUSAL else 0, 2,
                                 "obmc_cdf", bsize)
            elif allowed == c.WARPED_CAUSAL:
                self.sink.symbol(mm, 3, "motion_mode_cdf", bsize)
            else:
                assert mm == c.SIMPLE_TRANSLATION
        return mode

    _QUANT_DIST_WEIGHT = [(2, 3), (2, 5), (2, 7), (1, 31)]
    _QUANT_DIST_LOOKUP = [(9, 7), (11, 5), (12, 4), (13, 3)]

    def _dist_wtd_weights_enc(self, r0, r1):
        """av1_dist_wtd_comp_weight_assign (reconinter.c:668) for
        compound_idx == 0 — mirror of decoder/inter._dist_wtd_weights."""
        cur = self.fh.order_hint
        bck_h = self.ref_hints[r0]
        fwd_h = self.ref_hints[r1]
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

    def _comp_index_ctx_enc(self, mi_row, mi_col, up, left):
        """av1_get_comp_index_context mirror (decoder _comp_index_ctx)
        over the encoder mi grids; refs are (LAST, ALTREF)."""
        cur = self.fh.order_hint
        fwd = abs(H.get_relative_dist(self.sh,
                                      self.ref_hints[c.ALTREF_FRAME], cur))
        bck = abs(H.get_relative_dist(self.sh, cur,
                                      self.ref_hints[c.LAST_FRAME]))
        offset = int(fwd == bck)
        g = self.g
        m = g.m

        def nb_val(r, col):
            if int(g.ref1[r + m, col + m]) > c.INTRA_FRAME:
                return int(self.comp_idx_grid[r + m, col + m])
            if int(g.ref0[r + m, col + m]) == c.ALTREF_FRAME:
                return 1
            return 0

        a = nb_val(mi_row - 1, mi_col) if up else 0
        l = nb_val(mi_row, mi_col - 1) if left else 0
        return a + l + 3 * offset

    def _emit_compound_mode(self, bplan, mi_row, mi_col, bsize,
                            partition=c.PARTITION_NONE):
        """NEAREST_NEARESTMV compound-mode symbol (no drl, no MV bits),
        then the compound-type symbols (comp_group_idx / compound_type /
        wedge / mask_type, decodemv.c:1428 write mirror); the
        compound_idx symbol is absent with jnt_comp off in the sequence
        header."""
        ctx = self._refmv_context(mi_row, mi_col, bsize, partition)
        gm0 = self._gm_mv(c.LAST_FRAME, bsize, mi_row, mi_col)
        gm1 = self._gm_mv(c.ALTREF_FRAME, bsize, mi_row, mi_col)
        gmi = {"mv": (gm0, gm1), "types": self._gm_types}
        stack, weights, count, mode_ctx, mv_list = MR.find_mv_refs(
            ctx, (c.LAST_FRAME, c.ALTREF_FRAME),
            sign_bias=self.sign_bias, tmvp=self.tmvp, gm=gmi)
        newmv_ctx = mode_ctx & MR.NEWMV_CTX_MASK
        refmv_ctx = (mode_ctx >> MR.REFMV_OFFSET) & MR.REFMV_CTX_MASK
        comp_ctx = MR.COMPOUND_MODE_CTX_MAP[refmv_ctx >> 1][
            min(newmv_ctx, 4)]
        self.sink.symbol(0, 8, "inter_compound_mode_cdf", comp_ctx)
        comp_allowed = min(blockd.block_wide(bsize),
                           blockd.block_high(bsize)) >= 8
        if self.sh.enable_masked_compound and comp_allowed:
            up_avail = mi_row > 0
            left_avail = mi_col > 0
            gctx = self._comp_group_ctx_enc(mi_row, mi_col, up_avail,
                                            left_avail)
            cg = bplan.get("comp_group_idx", 0)
            self.sink.symbol(cg, 2, "comp_group_idx_cdf", gctx)
            if cg:
                ct = bplan["comp_type"]
                if bsize in WEDGE_SIZES:
                    self.sink.symbol(ct - 1, 2, "compound_type_cdf",
                                     bsize)
                else:
                    assert ct == 2
                if ct == 1:
                    self.sink.symbol(bplan["wedge_index"], 16,
                                     "wedge_idx_cdf", bsize)
                    self.sink.bit(bplan["wedge_sign"])
                else:
                    self.sink.bit(bplan["mask_type"])
            elif self.sh.enable_jnt_comp:
                ictx = self._comp_index_ctx_enc(mi_row, mi_col,
                                                up_avail, left_avail)
                self.sink.symbol(bplan.get("compound_idx", 1), 2,
                                 "compound_index_cdf", ictx)
        else:
            assert not bplan.get("comp_group_idx", 0)
            if self.sh.enable_jnt_comp:
                # masked compound absent: the decoder still reads
                # compound_idx when comp_group_idx == 0 (decodemv.c:1449)
                self.sink.symbol(bplan.get("compound_idx", 1), 2,
                                 "compound_index_cdf",
                                 self._comp_index_ctx_enc(
                                     mi_row, mi_col, mi_row > 0,
                                     mi_col > 0))
        return MR.NEAREST_NEARESTMV

    def _write_mv(self, mv, ref_mv):
        dr = mv[0] - ref_mv[0]
        dc = mv[1] - ref_mv[1]
        joint = (1 if dc else 0) | (2 if dr else 0)
        usehp = bool(self.fh.allow_high_precision_mv) \
            and not self.fh.force_integer_mv
        self.sink.symbol(joint, 4, "nmv_joints_cdf")
        if dr:
            self._write_mv_component(dr, 0, usehp)
        if dc:
            self._write_mv_component(dc, 1, usehp)

    def _write_mv_component(self, d, comp, usehp=False):
        """Mirror of decodemv.c read_mv_component: the hp symbol is
        coded only when usehp; otherwise hp is implied 1."""
        pre = f"nmv_comp{comp}_"
        sign = 1 if d < 0 else 0
        z = abs(d) - 1
        cls, offset = _mv_class(z)
        self.sink.symbol(sign, 2, pre + "sign_cdf")
        self.sink.symbol(cls, 11, pre + "classes_cdf")
        intd = offset >> 3
        fr = (offset >> 1) & 3
        hp = offset & 1
        assert usehp or hp == 1, "low-precision MV must have hp bit 1"
        if cls == 0:
            self.sink.symbol(intd, 2, pre + "class0_cdf")
        else:
            for i in range(cls):
                self.sink.symbol((intd >> i) & 1, 2, pre + "bits_cdf", i)
        if cls == 0:
            self.sink.symbol(fr, 4, pre + "class0_fp_cdf", intd)
        else:
            self.sink.symbol(fr, 4, pre + "fp_cdf")
        if usehp:
            self.sink.symbol(hp, 2,
                             pre + ("class0_hp_cdf" if cls == 0
                                    else "hp_cdf"))


class LowDelayEncoder:
    """Key frame + P-frames, conformant single-ref low-delay encoding."""

    def __init__(self, width, height, qindex=60, use_native=None,
                 block_size=c.BLOCK_16X16, deblock=True, gm=False, **kw):
        self.sh = make_sequence_header(width, height)
        self.qindex = qindex
        self.use_native = use_native
        self.block_size = block_size
        self.deblock = deblock
        self.gm = gm
        self.kw = kw
        self.slots = [None] * 8
        self.frame_idx = 0

    def encode_frame(self, planes) -> bytes:
        if self.frame_idx == 0:
            fh = make_lossy_frame_header(self.sh, self.qindex,
                                         deblock=self.deblock)
            enc = LossyAllIntraEncoder(
                self.sh, fh, use_native=self.use_native,
                block_size=self.block_size, **self.kw)
        else:
            gm_params = None
            if self.gm and self.slots[0] is not None:
                from .global_motion import estimate_global_motion
                est = estimate_global_motion(planes[0],
                                             self.slots[0][0])
                gm_params = (est,) + ((c.IDENTITY,
                                       (0, 0, 65536, 0, 0, 65536),
                                       0),) * 6
            fh = make_inter_frame_header(self.sh, self.qindex,
                                         deblock=self.deblock,
                                         gm_params=gm_params)
            enc = InterFrameEncoder(
                self.sh, fh, self.slots, use_native=self.use_native,
                block_size=self.block_size)
        payload = enc.encode_frame(planes)
        w, h = self.sh.max_frame_width, self.sh.max_frame_height
        cw = (w + 1) >> 1
        ch = (h + 1) >> 1
        out = (enc.recon[0][:h, :w].copy(),
               enc.recon[1][:ch, :cw].copy(),
               enc.recon[2][:ch, :cw].copy())
        for slot in range(8):
            if fh.refresh_frame_flags & (1 << slot):
                self.slots[slot] = out
        self.frame_idx += 1
        return payload


def encode_lowdelay_ivf(path: str, frames, width: int, height: int,
                        qindex: int = 60, fps=(30, 1), **kw) -> None:
    from ..bitstream.ivf import write_ivf
    enc = LowDelayEncoder(width, height, qindex=qindex, **kw)
    payloads = []
    for i, f in enumerate(frames):
        payloads.append((enc.encode_frame(f), i))
    write_ivf(path, payloads, width, height, fps[0], fps[1])


def pick_interp_filter(src_y, ref_y, bd: int = 8) -> int:
    """Frame-level interpolation-filter decision
    (av1_pick_interp_filter / interp_search.c at frame granularity:
    with is_filter_switchable=0 one filter serves the whole frame).

    Samples a grid of 16x16 blocks, finds their full-pel MVs, then
    scores each filter on the half-pel-refined prediction SSE.
    """
    from ..common import interpred as IP
    from .global_motion import _block_motion_field
    src = np.asarray(src_y)
    ref = np.asarray(ref_y)
    pts, mvs, _ = _block_motion_field(src, ref, blk=16, rad=8, step=2)
    if len(pts) == 0:
        return c.EIGHTTAP_REGULAR
    # limit the sample for speed
    idx = np.linspace(0, len(pts) - 1, min(24, len(pts))).astype(int)
    h, w = src.shape
    sse = [0.0, 0.0, 0.0]
    refp = IP.pad_ref_plane(np.ascontiguousarray(ref))
    for i in idx:
        x0, y0 = int(pts[i][0]), int(pts[i][1])
        dy, dx = int(mvs[i][1]), int(mvs[i][0])
        blk = src[y0:y0 + 16, x0:x0 + 16].astype(np.int32)
        for f in (c.EIGHTTAP_REGULAR, c.EIGHTTAP_SMOOTH, c.MULTITAP_SHARP):
            best = None
            for sub_y in (0, 4):
                for sub_x in (0, 4):
                    mv = ((dy * 8) + sub_y, (dx * 8) + sub_x)
                    pred = IP.predict_inter_block(
                        refp, x0, y0, 16, 16, mv[0], mv[1], 0, 0,
                        -x0, w - 16 - x0, -y0, h - 16 - y0, f, f, bd)
                    v = float(((pred.astype(np.int32) - blk) ** 2).sum())
                    if best is None or v < best:
                        best = v
            sse[f] += best
    return int(np.argmin(sse))
