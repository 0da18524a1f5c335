"""Deblocking loop filter — normative, vectorized host implementation.

AV1 spec §7.14 (reference behavior: av1/common/av1_loopfilter.c
set_lpf_parameters + aom_dsp/loopfilter.c kernels).  Operates on the recon
planes after the whole frame is reconstructed: a vertical-edge pass then a
horizontal-edge pass per plane.  Per-block filter levels honor the ref/mode deltas
(av1_loopfilter.c:68 av1_get_filter_level) and skipped inter blocks only
filter prediction-unit edges (av1_loopfilter.c:240 set_lpf_parameters).

Vectorization: per 4x4 edge unit compute (filter_length, level), then apply
each filter length to all its units batched (numpy fancy indexing).
"""

from __future__ import annotations

import numpy as np

from ..bitstream import constants as c

MAX_LOOP_FILTER = 63
TX_DIM_TO_FILTER_LENGTH = [4, 8, 14, 14, 14]  # by log2(dim4)


def sharpness_limits(sharpness: int):
    """Per-level (lim, mblim) tables (av1_loopfilter.c:47)."""
    lim = np.zeros(MAX_LOOP_FILTER + 1, np.int32)
    mblim = np.zeros(MAX_LOOP_FILTER + 1, np.int32)
    for lvl in range(MAX_LOOP_FILTER + 1):
        bil = lvl >> ((sharpness > 0) + (sharpness > 4))
        if sharpness > 0:
            bil = min(bil, 9 - sharpness)
        bil = max(bil, 1)
        lim[lvl] = bil
        mblim[lvl] = 2 * (lvl + 2) + bil
    return lim, mblim


def pick_filter_level_from_q(qindex: int, frame_is_key: bool,
                             bd: int = 8) -> int:
    """Encoder-side level estimate (picklpf.c LPF_PICK_FROM_Q)."""
    from . import quant as Q
    q = Q.ac_quant_qtx(qindex, 0, bd)
    if bd == 8:
        if frame_is_key:
            guess = (q * 17563 - 421574 + (1 << 17)) >> 18
        else:
            guess = (q * 6017 + 650707 + (1 << 17)) >> 18
    else:
        guess = (q * 20723 + 4060632 + (1 << 19)) >> 20
        if frame_is_key:
            guess -= 4
    return max(0, min(MAX_LOOP_FILTER, guess))


def _filter4(p1, p0, q0, q1, mask, thresh, bd=8):
    """Vectorized filter4 over int32 arrays; returns new (p1, p0, q0, q1).
    For bd > 8 the signed range widens per signed_char_clamp_high."""
    hev = ((np.abs(p1 - p0) > thresh) | (np.abs(q1 - q0) > thresh))
    shift = bd - 8
    mid = 0x80 << shift
    ps1 = p1 - mid
    ps0 = p0 - mid
    qs0 = q0 - mid
    qs1 = q1 - mid
    clamp = lambda x: np.clip(x, -mid, mid - 1)  # noqa: E731
    f = clamp(ps1 - qs1) * hev
    f = clamp(f + 3 * (qs0 - ps0)) * mask
    f1 = clamp(f + 4) >> 3
    f2 = clamp(f + 3) >> 3
    oq0 = clamp(qs0 - f1) + mid
    op0 = clamp(ps0 + f2) + mid
    f3 = ((f1 + 1) >> 1) * (~hev)
    oq1 = clamp(qs1 - f3) + mid
    op1 = clamp(ps1 + f3) + mid
    return op1, op0, oq0, oq1


def _apply_edge_filters(plane, xs, ys, horizontal, length, lim, mblim,
                        thresh, bd=8):
    """Filter the 4-sample edges at (ys, xs) (top-left of each 4-px run).

    For vertical edges, samples run down 4 rows at column xs; for
    horizontal, across 4 columns at row ys.  `length` in {4, 6, 8, 14}.
    """
    if len(xs) == 0:
        return
    shift = bd - 8
    lim = lim << shift
    mblim = mblim << shift
    thresh = thresh << shift
    flat_thr = 1 << shift
    ntaps = {4: 2, 6: 3, 8: 4, 14: 7}[length]
    offs = np.arange(-ntaps, ntaps)
    lane = np.arange(4)
    if horizontal:
        rows = ys[:, None, None] + offs[None, :, None]
        cols = xs[:, None, None] + lane[None, None, :]
    else:
        rows = ys[:, None, None] + lane[None, :, None]
        cols = xs[:, None, None] + offs[None, None, :]
        # orient so axis -2 is the tap axis
    s = plane[rows, cols].astype(np.int32)
    if not horizontal:
        s = np.swapaxes(s, 1, 2)  # (N, taps, 4)
    # s[:, k, :] = sample at offset offs[k]; p_i = s[ntaps-1-i], q_i = s[ntaps+i]
    P = [s[:, ntaps - 1 - i, :] for i in range(ntaps)]
    Qv = [s[:, ntaps + i, :] for i in range(ntaps)]
    lim = lim[:, None]
    mblim = mblim[:, None]
    thresh = thresh[:, None]

    def gt(a, b):
        return np.abs(a - b)

    if length == 4:
        mask = ~((gt(P[1], P[0]) > lim) | (gt(Qv[1], Qv[0]) > lim)
                 | (gt(P[0], Qv[0]) * 2 + (gt(P[1], Qv[1]) >> 1) > mblim))
        o = _filter4(P[1], P[0], Qv[0], Qv[1], mask, thresh, bd)
        out = [o[0], o[1], o[2], o[3]]
        res_p = {1: out[0], 0: out[1]}
        res_q = {0: out[2], 1: out[3]}
    elif length == 6:
        mask = ~((gt(P[2], P[1]) > lim) | (gt(P[1], P[0]) > lim)
                 | (gt(Qv[1], Qv[0]) > lim) | (gt(Qv[2], Qv[1]) > lim)
                 | (gt(P[0], Qv[0]) * 2 + (gt(P[1], Qv[1]) >> 1) > mblim))
        flat = ~((gt(P[1], P[0]) > flat_thr) | (gt(Qv[1], Qv[0]) > flat_thr)
                 | (gt(P[2], P[0]) > flat_thr) | (gt(Qv[2], Qv[0]) > flat_thr))
        fm = flat & mask
        r2 = lambda x: (x + 4) >> 3  # noqa: E731
        n_p1 = r2(P[2] * 3 + P[1] * 2 + P[0] * 2 + Qv[0])
        n_p0 = r2(P[2] + P[1] * 2 + P[0] * 2 + Qv[0] * 2 + Qv[1])
        n_q0 = r2(P[1] + P[0] * 2 + Qv[0] * 2 + Qv[1] * 2 + Qv[2])
        n_q1 = r2(P[0] + Qv[0] * 2 + Qv[1] * 2 + Qv[2] * 3)
        o = _filter4(P[1], P[0], Qv[0], Qv[1], mask & ~flat, thresh, bd)
        res_p = {1: np.where(fm, n_p1, o[0]), 0: np.where(fm, n_p0, o[1])}
        res_q = {0: np.where(fm, n_q0, o[2]), 1: np.where(fm, n_q1, o[3])}
    else:
        mask = ~((gt(P[3], P[2]) > lim) | (gt(P[2], P[1]) > lim)
                 | (gt(P[1], P[0]) > lim) | (gt(Qv[1], Qv[0]) > lim)
                 | (gt(Qv[2], Qv[1]) > lim) | (gt(Qv[3], Qv[2]) > lim)
                 | (gt(P[0], Qv[0]) * 2 + (gt(P[1], Qv[1]) >> 1) > mblim))
        flat = ~((gt(P[1], P[0]) > flat_thr) | (gt(Qv[1], Qv[0]) > flat_thr)
                 | (gt(P[2], P[0]) > flat_thr) | (gt(Qv[2], Qv[0]) > flat_thr)
                 | (gt(P[3], P[0]) > flat_thr)
                 | (gt(Qv[3], Qv[0]) > flat_thr))
        r2 = lambda x: (x + 4) >> 3  # noqa: E731
        f8 = {}
        f8["p2"] = r2(P[3] * 3 + 2 * P[2] + P[1] + P[0] + Qv[0])
        f8["p1"] = r2(P[3] * 2 + P[2] + 2 * P[1] + P[0] + Qv[0] + Qv[1])
        f8["p0"] = r2(P[3] + P[2] + P[1] + 2 * P[0] + Qv[0] + Qv[1] + Qv[2])
        f8["q0"] = r2(P[2] + P[1] + P[0] + 2 * Qv[0] + Qv[1] + Qv[2] + Qv[3])
        f8["q1"] = r2(P[1] + P[0] + Qv[0] + 2 * Qv[1] + Qv[2] + 2 * Qv[3])
        f8["q2"] = r2(P[0] + Qv[0] + Qv[1] + 2 * Qv[2] + 3 * Qv[3])
        o = _filter4(P[1], P[0], Qv[0], Qv[1], mask & ~flat, thresh, bd)
        fm = flat & mask
        res_p = {2: np.where(fm, f8["p2"], P[2]),
                 1: np.where(fm, f8["p1"], o[0]),
                 0: np.where(fm, f8["p0"], o[1])}
        res_q = {0: np.where(fm, f8["q0"], o[2]),
                 1: np.where(fm, f8["q1"], o[3]),
                 2: np.where(fm, f8["q2"], Qv[2])}
        if length == 14:
            flat2 = ~((gt(P[6], P[0]) > flat_thr)
                      | (gt(P[5], P[0]) > flat_thr)
                      | (gt(P[4], P[0]) > flat_thr)
                      | (gt(Qv[4], Qv[0]) > flat_thr)
                      | (gt(Qv[5], Qv[0]) > flat_thr)
                      | (gt(Qv[6], Qv[0]) > flat_thr))
            fm2 = flat2 & fm
            r4 = lambda x: (x + 8) >> 4  # noqa: E731
            p6, p5, p4, p3, p2, p1, p0 = P[6], P[5], P[4], P[3], P[2], \
                P[1], P[0]
            q0, q1, q2, q3, q4, q5, q6 = Qv[0], Qv[1], Qv[2], Qv[3], \
                Qv[4], Qv[5], Qv[6]
            n = {}
            n["p5"] = r4(p6 * 7 + p5 * 2 + p4 * 2 + p3 + p2 + p1 + p0 + q0)
            n["p4"] = r4(p6 * 5 + p5 * 2 + p4 * 2 + p3 * 2 + p2 + p1 + p0
                         + q0 + q1)
            n["p3"] = r4(p6 * 4 + p5 + p4 * 2 + p3 * 2 + p2 * 2 + p1 + p0
                         + q0 + q1 + q2)
            n["p2"] = r4(p6 * 3 + p5 + p4 + p3 * 2 + p2 * 2 + p1 * 2 + p0
                         + q0 + q1 + q2 + q3)
            n["p1"] = r4(p6 * 2 + p5 + p4 + p3 + p2 * 2 + p1 * 2 + p0 * 2
                         + q0 + q1 + q2 + q3 + q4)
            n["p0"] = r4(p6 + p5 + p4 + p3 + p2 + p1 * 2 + p0 * 2 + q0 * 2
                         + q1 + q2 + q3 + q4 + q5)
            n["q0"] = r4(p5 + p4 + p3 + p2 + p1 + p0 * 2 + q0 * 2 + q1 * 2
                         + q2 + q3 + q4 + q5 + q6)
            n["q1"] = r4(p4 + p3 + p2 + p1 + p0 + q0 * 2 + q1 * 2 + q2 * 2
                         + q3 + q4 + q5 + q6 * 2)
            n["q2"] = r4(p3 + p2 + p1 + p0 + q0 + q1 * 2 + q2 * 2 + q3 * 2
                         + q4 + q5 + q6 * 3)
            n["q3"] = r4(p2 + p1 + p0 + q0 + q1 + q2 * 2 + q3 * 2 + q4 * 2
                         + q5 + q6 * 4)
            n["q4"] = r4(p1 + p0 + q0 + q1 + q2 + q3 * 2 + q4 * 2 + q5 * 2
                         + q6 * 5)
            n["q5"] = r4(p0 + q0 + q1 + q2 + q3 + q4 * 2 + q5 * 2 + q6 * 7)
            res_p = {5: np.where(fm2, n["p5"], P[5]),
                     4: np.where(fm2, n["p4"], P[4]),
                     3: np.where(fm2, n["p3"], P[3]),
                     2: np.where(fm2, n["p2"], res_p[2]),
                     1: np.where(fm2, n["p1"], res_p[1]),
                     0: np.where(fm2, n["p0"], res_p[0])}
            res_q = {0: np.where(fm2, n["q0"], res_q[0]),
                     1: np.where(fm2, n["q1"], res_q[1]),
                     2: np.where(fm2, n["q2"], res_q[2]),
                     3: np.where(fm2, n["q3"], Qv[3]),
                     4: np.where(fm2, n["q4"], Qv[4]),
                     5: np.where(fm2, n["q5"], Qv[5])}

    # write back modified taps
    out = s.copy()
    for i, v in res_p.items():
        out[:, ntaps - 1 - i, :] = v
    for i, v in res_q.items():
        out[:, ntaps + i, :] = v
    out = np.clip(out, 0, (1 << bd) - 1).astype(plane.dtype)
    if not horizontal:
        out = np.swapaxes(out, 1, 2)
    plane[rows, cols] = out


# mode_lf_lut (av1_loopfilter.c): prediction mode -> mode-delta bucket
MODE_LF_LUT = np.array([0] * 13 + [1, 1, 0, 1, 1, 1, 1, 1, 1, 1, 0, 1],
                       np.int32)


# seg_lvl_lf_lut (av1_loopfilter.c:31): feature id per (plane, dir)
_SEG_LF_FEATURE = ((1, 2), (3, 3), (4, 4))


def build_filter_levels(fh):
    """lvl[seg][plane][dir][ref0][mode_bucket]
    (av1_loop_filter_frame_init)."""
    base = [(fh.filter_level[0], fh.filter_level[1]),
            (fh.filter_level_u, fh.filter_level_u),
            (fh.filter_level_v, fh.filter_level_v)]
    nseg = 8 if fh.segmentation_enabled else 1
    lvl = np.zeros((nseg, 3, 2, 8, 2), np.int32)
    for seg_id in range(nseg):
        for plane in range(3):
            for d in range(2):
                seg = base[plane][d]
                feat = _SEG_LF_FEATURE[plane][d]
                if (fh.segmentation_enabled
                        and fh.seg_feature_mask[seg_id] & (1 << feat)):
                    seg = int(np.clip(
                        seg + fh.seg_feature_data[seg_id][feat],
                        0, MAX_LOOP_FILTER))
                if not fh.loop_filter_delta_enabled:
                    lvl[seg_id, plane, d, :, :] = seg
                    continue
                scale = 1 << (seg >> 5)
                lvl[seg_id, plane, d, 0, :] = np.clip(
                    seg + fh.ref_deltas[0] * scale, 0, MAX_LOOP_FILTER)
                for ref in range(1, 8):
                    for mb in range(2):
                        v = seg + fh.ref_deltas[ref] * scale                             + fh.mode_deltas[mb] * scale
                        lvl[seg_id, plane, d, ref, mb] = np.clip(
                            v, 0, MAX_LOOP_FILTER)
    return lvl


def loop_filter_frame(planes, fh, sh, luma_txw4, luma_txh4, bsize_grid,
                      ref_grid, mode_grid, skip_inter_grid, plane_tx_fn,
                      seg_grid=None, bd=8):
    """Filter recon planes in place.

    luma_txw4/txh4: (mi_h, mi_w) luma tx dims per mi in 4x4 units.
    bsize_grid: luma BLOCK_* per mi.  ref_grid/mode_grid/skip_inter_grid:
    per luma mi ref_frame[0], prediction mode, skip&&inter flag.
    plane_tx_fn(plane, bsize) -> chroma TX_* for a block.
    """
    from . import blockd
    lvl_tab = build_filter_levels(fh)
    lim_tab, mblim_tab = sharpness_limits(fh.sharpness_level)
    num_planes = 1 if sh.mono_chrome else 3
    mh, mw = bsize_grid.shape
    mode_bucket = MODE_LF_LUT[np.clip(mode_grid, 0, 24)]
    ref_clip = np.clip(ref_grid, 0, 7)
    txw4_of = np.array([c.TX_WIDTH[t] >> 2 for t in range(c.TX_SIZES_ALL)])
    txh4_of = np.array([c.TX_HEIGHT[t] >> 2 for t in range(c.TX_SIZES_ALL)])
    bw4_of = np.array([blockd.block_wide(b) >> 2
                       for b in range(c.BLOCK_SIZES_ALL)])
    bh4_of = np.array([blockd.block_high(b) >> 2
                       for b in range(c.BLOCK_SIZES_ALL)])

    # decodeframe.c:5267 gates the whole filter on the luma base levels;
    # thread_common.c check_planes_to_loop_filter gates chroma per plane
    if fh.filter_level[0] == 0 and fh.filter_level[1] == 0:
        return
    for plane in range(num_planes):
        if plane == 1 and fh.filter_level_u == 0:
            continue
        if plane == 2 and fh.filter_level_v == 0:
            continue
        ss_x = sh.subsampling_x if plane else 0
        ss_y = sh.subsampling_y if plane else 0
        buf = planes[plane]
        if plane == 0:
            sel_r = np.arange(mh)
            sel_c = np.arange(mw)
        else:
            gh = (mh + ss_y) >> ss_y
            gw = (mw + ss_x) >> ss_x
            sel_r = np.minimum((np.arange(gh) << ss_y) | ss_y, mh - 1)
            sel_c = np.minimum((np.arange(gw) << ss_x) | ss_x, mw - 1)
        bs_sel = bsize_grid[sel_r[:, None], sel_c[None, :]]
        ref_sel = ref_clip[sel_r[:, None], sel_c[None, :]]
        mb_sel = mode_bucket[sel_r[:, None], sel_c[None, :]]
        skip_sel = skip_inter_grid[sel_r[:, None], sel_c[None, :]]
        if seg_grid is not None and lvl_tab.shape[0] > 1:
            seg_sel = seg_grid[sel_r[:, None], sel_c[None, :]]                 .astype(np.int64)
        else:
            seg_sel = None
        gh, gw = bs_sel.shape
        if plane == 0:
            dimw4 = luma_txw4.astype(np.int64)
            dimh4 = luma_txh4.astype(np.int64)
            pbw4 = bw4_of[bs_sel]
            pbh4 = bh4_of[bs_sel]
        else:
            txsel = np.zeros((gh, gw), np.int32)
            for b in np.unique(bs_sel):
                txsel[bs_sel == b] = plane_tx_fn(plane, int(b))
            dimw4 = txw4_of[txsel]
            dimh4 = txh4_of[txsel]
            pb = np.zeros((gh, gw), np.int32)
            for b in np.unique(bs_sel):
                pb[bs_sel == b] = blockd.plane_block_size(int(b), ss_x, ss_y)
            pbw4 = bw4_of[pb]
            pbh4 = bh4_of[pb]
        lvl_all = lvl_tab[:, plane]  # [seg][dir][ref][modebucket]
        for horizontal in (False, True):
            d = 1 if horizontal else 0
            dim4 = dimh4 if horizontal else dimw4
            pdim4 = pbh4 if horizontal else pbw4
            if seg_sel is None:
                lvl_map = lvl_all[0, d][ref_sel, mb_sel]
            else:
                lvl_map = lvl_all[seg_sel, d, ref_sel, mb_sel]
            r_idx, c_idx = np.mgrid[0:gh, 0:gw]
            coord = r_idx if horizontal else c_idx
            tu_edge = (coord % dim4) == 0
            tu_edge &= coord > 0
            rs, cs = np.nonzero(tu_edge)
            if len(rs) == 0:
                continue
            pr = rs - (1 if horizontal else 0)
            pc = cs - (0 if horizontal else 1)
            curr_lvl = lvl_map[rs, cs]
            pv_lvl = lvl_map[pr, pc]
            curr_skip = skip_sel[rs, cs] != 0
            pv_skip = skip_sel[pr, pc] != 0
            pu_edge = (coord[rs, cs] % pdim4[rs, cs]) == 0
            keep = ((curr_lvl > 0) | (pv_lvl > 0)) &                 (~pv_skip | ~curr_skip | pu_edge)
            if not keep.any():
                continue
            rs, cs, pr, pc = rs[keep], cs[keep], pr[keep], pc[keep]
            level = np.where(curr_lvl[keep] > 0, curr_lvl[keep],
                             pv_lvl[keep])
            d_cur = dim4[rs, cs]
            d_prev = dim4[pr, pc]
            dmin = np.minimum(d_cur, d_prev)
            dim_log2 = np.log2(dmin).astype(int)
            if plane:
                flen = np.where(dim_log2 == 0, 4, 6)
            else:
                flen = np.array(TX_DIM_TO_FILTER_LENGTH)[dim_log2]
            lim = lim_tab[level]
            mblim = mblim_tab[level]
            thr = (level >> 4).astype(np.int32)
            ys = rs * 4
            xs = cs * 4
            for L in (4, 6, 8, 14):
                m = flen == L
                if not m.any():
                    continue
                _apply_edge_filters(buf, xs[m], ys[m], horizontal, L,
                                    lim[m], mblim[m], thr[m], bd)


def tx_grid_for_plane(mi_bsize, plane, ss_x, ss_y, lossless,
                      plane_tx_fn):
    """Build the per-4x4 tx-size grid for a plane from the luma-mi bsize
    grid.  plane_tx_fn(plane, bsize) -> TX_*."""
    mh, mw = mi_bsize.shape
    if plane == 0:
        out = np.zeros((mh, mw), np.int32)
        for b in np.unique(mi_bsize):
            out[mi_bsize == b] = (c.TX_4X4 if lossless
                                  else plane_tx_fn(0, int(b)))
        return out
    # chroma grid in chroma mi units; mbmi taken from the bottom/right mi
    ch, cw = (mh + ss_y) >> ss_y, (mw + ss_x) >> ss_x
    out = np.zeros((ch, cw), np.int32)
    src_r = np.minimum((np.arange(ch) << ss_y) | ss_y, mh - 1)
    src_c = np.minimum((np.arange(cw) << ss_x) | ss_x, mw - 1)
    sel = mi_bsize[src_r[:, None], src_c[None, :]]
    for b in np.unique(sel):
        out[sel == b] = (c.TX_4X4 if lossless
                         else plane_tx_fn(plane, int(b)))
    return out
