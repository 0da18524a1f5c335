"""Motion-vector reference list construction + inter prediction contexts.

Behavioral port of the normative MV predictor machinery:
 - setup_ref_mv_list / av1_find_mv_refs (av1/common/mvref_common.c:474,783)
 - scan_row/col/blk_mbmi (mvref_common.c:142,189,236)
 - has_top_right (mvref_common.c:259 - distinct from the partition-tree
   availability rule used for intra edges)
 - neighbor ref counts + single-ref signalling contexts
   (av1/common/pred_common.c:124-501)
 - av1_mode_context_analyzer / av1_drl_ctx (mvref_common.h:170,185)

Single-reference path only for now (compound stacks TBD).  Operates on
margin-padded numpy mi grids supplied by the caller; out-of-frame cells
must be initialized to intra (ref0 == 0) so they contribute nothing.
"""

from __future__ import annotations

import numpy as np

from ..bitstream import constants as c

MAX_REF_MV_STACK_SIZE = 8
MAX_MV_REF_CANDIDATES = 2
MVREF_ROW_COLS = 3
REF_CAT_LEVEL = 640
NEWMV_CTX_MASK = (1 << 3) - 1        # GLOBALMV_OFFSET = 3
GLOBALMV_OFFSET = 3
GLOBALMV_CTX_MASK = (1 << (4 - 3)) - 1
REFMV_OFFSET = 4
REFMV_CTX_MASK = (1 << (8 - 4)) - 1
MV_BORDER = 16 << 3
# mi-grid ref0 sentinel for intraBC blocks: is_inter_block() == true with
# ref_frame[0] == INTRA_FRAME (blockd.h:372).  Any value > ALTREF works;
# consumers that mean "is inter" test ref0 > INTRA_FRAME and the candidate
# scans translate it back to INTRA_FRAME.
INTRABC_REF = 9
# av1_find_ref_dv (mvref_common.h:263)
INTRABC_DELAY_PIXELS = 256

# prediction modes (av1/common/enums.h) - inter portion
NEARESTMV = 13
NEARMV = 14
GLOBALMV = 15
NEWMV = 16
NEAREST_NEARESTMV = 17
NEAR_NEARMV = 18
NEAREST_NEWMV = 19
NEW_NEARESTMV = 20
NEAR_NEWMV = 21
NEW_NEARMV = 22
GLOBAL_GLOBALMV = 23
NEW_NEWMV = 24

_NEWMV_MODES = {NEWMV, NEW_NEWMV, NEAREST_NEWMV, NEW_NEARESTMV,
                NEAR_NEWMV, NEW_NEARMV}

# compound_mode_ctx_map (mvref_common.h:164)
COMPOUND_MODE_CTX_MAP = [
    [0, 1, 1, 1, 1],
    [1, 2, 3, 4, 4],
    [4, 4, 5, 6, 7],
]
_NEARMV_MODES = {NEARMV, NEAR_NEARMV, NEAR_NEWMV, NEW_NEARMV}


def have_newmv(mode: int) -> bool:
    return mode in _NEWMV_MODES


def have_nearmv(mode: int) -> bool:
    return mode in _NEARMV_MODES


class MiGrids:
    """Margin-padded per-mi arrays for one frame decode/encode."""

    def __init__(self, mi_rows: int, mi_cols: int, margin: int = 32):
        self.mi_rows, self.mi_cols, self.m = mi_rows, mi_cols, margin
        shape = (mi_rows + 2 * margin, mi_cols + 2 * margin)
        self.ref0 = np.zeros(shape, np.int8)           # INTRA_FRAME
        self.ref1 = np.full(shape, -1, np.int8)        # NONE_FRAME
        self.mode = np.zeros(shape, np.uint8)
        self.bsize = np.zeros(shape, np.uint8)
        self.partition = np.zeros(shape, np.uint8)
        self.mv = np.zeros(shape + (2, 2), np.int16)   # [..][which][row,col]

    def at(self, mi_row: int, mi_col: int):
        """Candidate view (ref0, ref1, mode, bsize, mv) at a grid position."""
        r, ccol = mi_row + self.m, mi_col + self.m
        return (int(self.ref0[r, ccol]), int(self.ref1[r, ccol]),
                int(self.mode[r, ccol]), int(self.bsize[r, ccol]),
                self.mv[r, ccol])

    def fill_block(self, mi_row: int, mi_col: int, h4: int, w4: int,
                   ref0: int, ref1: int, mode: int, bsize: int,
                   partition: int, mv0, mv1) -> None:
        r, ccol = mi_row + self.m, mi_col + self.m
        h4 = min(h4, self.mi_rows - mi_row)
        w4 = min(w4, self.mi_cols - mi_col)
        self.ref0[r:r + h4, ccol:ccol + w4] = ref0
        self.ref1[r:r + h4, ccol:ccol + w4] = ref1
        self.mode[r:r + h4, ccol:ccol + w4] = mode
        self.bsize[r:r + h4, ccol:ccol + w4] = bsize
        self.partition[r:r + h4, ccol:ccol + w4] = partition
        self.mv[r:r + h4, ccol:ccol + w4, 0] = mv0
        self.mv[r:r + h4, ccol:ccol + w4, 1] = mv1


def _mi_wide(bsize: int) -> int:
    from . import blockd
    return blockd.block_wide(bsize) >> 2


def _mi_high(bsize: int) -> int:
    from . import blockd
    return blockd.block_high(bsize) >> 2


class RefMvContext:
    """Inputs describing the block being predicted."""

    def __init__(self, grids: MiGrids, mi_row: int, mi_col: int, bsize: int,
                 sb_mi_size: int, tile_row_start: int, tile_row_end: int,
                 tile_col_start: int, tile_col_end: int, partition: int):
        self.g = grids
        self.mi_row, self.mi_col = mi_row, mi_col
        self.bsize = bsize
        self.w4, self.h4 = _mi_wide(bsize), _mi_high(bsize)
        self.sb_mi = sb_mi_size
        self.trs, self.tre = tile_row_start, tile_row_end
        self.tcs, self.tce = tile_col_start, tile_col_end
        self.partition = partition
        self.up_available = mi_row > tile_row_start
        self.left_available = mi_col > tile_col_start
        # 1/8-pel block edges (set_mi_row_col semantics)
        self.mb_to_top = -(mi_row * 4) * 8
        self.mb_to_bottom = (grids.mi_rows - self.h4 - mi_row) * 4 * 8
        self.mb_to_left = -(mi_col * 4) * 8
        self.mb_to_right = (grids.mi_cols - self.w4 - mi_col) * 4 * 8
        # set_mi_row_col rect-order flags (av1_common_int.h:1409)
        self.is_last_vertical_rect = (
            self.w4 < self.h4 and not ((mi_col + self.w4) & (self.h4 - 1)))
        self.is_first_horizontal_rect = (
            self.w4 > self.h4 and not (mi_row & (self.w4 - 1)))


def _has_top_right(ctx: RefMvContext) -> int:
    """mvref_common.c:259 has_top_right."""
    bs = max(ctx.w4, ctx.h4)
    mask_row = ctx.mi_row & (ctx.sb_mi - 1)
    mask_col = ctx.mi_col & (ctx.sb_mi - 1)
    if bs > 16:
        return 0
    has_tr = not ((mask_row & bs) and (mask_col & bs))
    b = bs
    while b < ctx.sb_mi:
        if mask_col & b:
            if (mask_col & (2 * b)) and (mask_row & (2 * b)):
                has_tr = 0
                break
        else:
            break
        b <<= 1
    if ctx.w4 < ctx.h4 and not ctx.is_last_vertical_rect:
        has_tr = 1
    if ctx.w4 > ctx.h4 and not ctx.is_first_horizontal_rect:
        has_tr = 0
    if ctx.partition == c.PARTITION_VERT_A:
        if ctx.w4 == ctx.h4 and (mask_row & bs):
            has_tr = 0
    return int(has_tr)


def _add_candidate(cand, ref_frame, stack, weights, counts, weight,
                   gm=None):
    """add_ref_mv_candidate (mvref_common.c:74).  ref_frame is either a
    single ref or a (rf0, rf1) compound pair; counts = [refmv_count,
    ref_match_count, newmv_count].  gm = {"mv": (mv0, mv1), "types":
    per-ref wmtype} substitutes global-mv candidates."""
    ref0, ref1, mode, cand_bsize, mv = cand
    if ref0 == INTRABC_REF:
        # intrabc neighbor: is_inter_block with ref_frame[0]==INTRA_FRAME,
        # its mv[0] is the DV (add_ref_mv_candidate via read_intrabc_info)
        ref0 = c.INTRA_FRAME
    elif ref0 <= c.INTRA_FRAME:         # not inter
        return
    if isinstance(ref_frame, tuple):
        rf0, rf1 = ref_frame
        if ref0 == rf0 and ref1 == rf1:
            pair = []
            for which in range(2):
                if gm is not None and is_global_mv_block(
                        mode, cand_bsize,
                        gm["types"][ref_frame[which]]):
                    pair.append(gm["mv"][which])
                else:
                    pair.append((int(mv[which][0]), int(mv[which][1])))
            this = tuple(pair)
            for idx in range(counts[0]):
                if stack[idx] == this:
                    weights[idx] += weight
                    break
            else:
                if counts[0] < MAX_REF_MV_STACK_SIZE:
                    stack[counts[0]] = this
                    weights[counts[0]] = weight
                    counts[0] += 1
            if have_newmv(mode):
                counts[2] += 1
            counts[1] += 1
        return
    for which in range(2):
        rr = ref0 if which == 0 else ref1
        if rr == ref_frame:
            if gm is not None and is_global_mv_block(
                    mode, cand_bsize, gm["types"][ref_frame]):
                this = gm["mv"][0]
            else:
                this = (int(mv[which][0]), int(mv[which][1]))
            for idx in range(counts[0]):
                if stack[idx] == this:
                    weights[idx] += weight
                    break
            else:
                if counts[0] < MAX_REF_MV_STACK_SIZE:
                    stack[counts[0]] = this
                    weights[counts[0]] = weight
                    counts[0] += 1
            if have_newmv(mode):
                counts[2] += 1
            counts[1] += 1


def _scan_row(ctx, ref_frame, row_offset, stack, weights, counts,
              max_row_offset, processed_rows, gm=None):
    g = ctx.g
    end_mi = min(ctx.w4, g.mi_cols - ctx.mi_col, 16)
    col_offset = 0
    if abs(row_offset) > 1:
        col_offset = 1
        if (ctx.mi_col & 1) and ctx.w4 < 2:
            col_offset -= 1
    use_step_16 = ctx.w4 >= 16
    i = 0
    while i < end_mi:
        cand = g.at(ctx.mi_row + row_offset, ctx.mi_col + col_offset + i)
        n4_w = _mi_wide(cand[3])
        length = min(ctx.w4, n4_w)
        if use_step_16:
            length = max(4, length)
        elif abs(row_offset) > 1:
            length = max(length, 2)
        weight = 2
        if 2 <= ctx.w4 <= n4_w:
            inc = min(-max_row_offset + row_offset + 1, _mi_high(cand[3]))
            weight = max(weight, inc)
            processed_rows[0] = inc - row_offset - 1
        _add_candidate(cand, ref_frame, stack, weights, counts,
                       length * weight, gm)
        i += length


def _scan_col(ctx, ref_frame, col_offset, stack, weights, counts,
              max_col_offset, processed_cols, gm=None):
    g = ctx.g
    end_mi = min(ctx.h4, g.mi_rows - ctx.mi_row, 16)
    row_offset = 0
    if abs(col_offset) > 1:
        row_offset = 1
        if (ctx.mi_row & 1) and ctx.h4 < 2:
            row_offset -= 1
    use_step_16 = ctx.h4 >= 16
    i = 0
    while i < end_mi:
        cand = g.at(ctx.mi_row + row_offset + i, ctx.mi_col + col_offset)
        n4_h = _mi_high(cand[3])
        length = min(ctx.h4, n4_h)
        if use_step_16:
            length = max(4, length)
        elif abs(col_offset) > 1:
            length = max(length, 2)
        weight = 2
        if 2 <= ctx.h4 <= n4_h:
            inc = min(-max_col_offset + col_offset + 1, _mi_wide(cand[3]))
            weight = max(weight, inc)
            processed_cols[0] = inc - col_offset - 1
        _add_candidate(cand, ref_frame, stack, weights, counts,
                       length * weight, gm)
        i += length


def _is_inside(ctx, row_off, col_off) -> bool:
    r = ctx.mi_row + row_off
    col = ctx.mi_col + col_off
    return not (r < ctx.trs or col < ctx.tcs or r >= ctx.tre
                or col >= ctx.tce)


def _scan_blk(ctx, ref_frame, row_off, col_off, stack, weights, counts,
              gm=None):
    if _is_inside(ctx, row_off, col_off):
        cand = ctx.g.at(ctx.mi_row + row_off, ctx.mi_col + col_off)
        _add_candidate(cand, ref_frame, stack, weights, counts, 2 * 2, gm)


def _clamp_mv_ref(mv, ctx):
    bw = ctx.w4 * 4
    bh = ctx.h4 * 4
    lo_c = ctx.mb_to_left - (bw * 8) - MV_BORDER
    hi_c = ctx.mb_to_right + (bw * 8) + MV_BORDER
    lo_r = ctx.mb_to_top - (bh * 8) - MV_BORDER
    hi_r = ctx.mb_to_bottom + (bh * 8) + MV_BORDER
    return (min(max(mv[0], lo_r), hi_r), min(max(mv[1], lo_c), hi_c))


_DIV_MULT = [0, 16384, 8192, 5461, 4096, 3276, 2730, 2340,
             2048, 1820, 1638, 1489, 1365, 1260, 1170, 1092,
             1024, 963, 910, 862, 819, 780, 744, 712,
             682, 655, 630, 606, 585, 564, 546, 528]
MAX_FRAME_DISTANCE = 31


def _round2s(x, n):
    if x < 0:
        return -((-x + (1 << (n - 1))) >> n)
    return (x + (1 << (n - 1))) >> n


def mv_projection(mv, num, den):
    """get_mv_projection (mvref_common.c:26)."""
    den = min(den, MAX_FRAME_DISTANCE)
    num = min(num, MAX_FRAME_DISTANCE) if num > 0 \
        else max(num, -MAX_FRAME_DISTANCE)
    r = _round2s(mv[0] * num * _DIV_MULT[den], 14)
    cc = _round2s(mv[1] * num * _DIV_MULT[den], 14)
    clamp_max = (1 << 14) - 1
    clamp_min = -(1 << 14) + 1
    return (max(clamp_min, min(clamp_max, r)),
            max(clamp_min, min(clamp_max, cc)))


def find_mv_refs(ctx: RefMvContext, ref_frame, sign_bias=None, tmvp=None,
                 gm=None):
    """Single-ref av1_find_mv_refs.  Returns (stack, weights, count,
    mode_context, mv_ref_list) where stack entries are (row, col) in
    1/8 pel.  Global motion is identity-only, so gm candidates are 0."""
    g = ctx.g
    stack = [(0, 0)] * MAX_REF_MV_STACK_SIZE
    weights = [0] * MAX_REF_MV_STACK_SIZE
    counts = [0, 0, 0]  # refmv, row+col match via split counters below
    row_match = [0, 0, 0]
    col_match = [0, 0, 0]

    row_adj = ctx.h4 < 2 and (ctx.mi_row & 1)
    col_adj = ctx.w4 < 2 and (ctx.mi_col & 1)
    max_row_offset = 0
    max_col_offset = 0
    if ctx.up_available:
        max_row_offset = -(MVREF_ROW_COLS << 1) + row_adj
        if ctx.h4 < 2:
            max_row_offset = -(2 << 1) + row_adj
        max_row_offset = min(max(max_row_offset, ctx.trs - ctx.mi_row),
                             ctx.tre - ctx.mi_row - 1)
    if ctx.left_available:
        max_col_offset = -(MVREF_ROW_COLS << 1) + col_adj
        if ctx.w4 < 2:
            max_col_offset = -(2 << 1) + col_adj
        max_col_offset = min(max(max_col_offset, ctx.tcs - ctx.mi_col),
                             ctx.tce - ctx.mi_col - 1)

    processed_rows = [0]
    processed_cols = [0]

    def merge(dst, src):
        dst[0] = src[0]
        dst[1] += src[1]
        dst[2] += src[2]

    # nearest row / col / top-right
    if abs(max_row_offset) >= 1:
        sub = [counts[0], 0, 0]
        _scan_row(ctx, ref_frame, -1, stack, weights, sub, max_row_offset,
                  processed_rows, gm)
        counts[0] = sub[0]
        row_match[1] += sub[1]
        counts[2] += sub[2]
    if abs(max_col_offset) >= 1:
        sub = [counts[0], 0, 0]
        _scan_col(ctx, ref_frame, -1, stack, weights, sub, max_col_offset,
                  processed_cols, gm)
        counts[0] = sub[0]
        col_match[1] += sub[1]
        counts[2] += sub[2]
    if _has_top_right(ctx):
        sub = [counts[0], 0, 0]
        _scan_blk(ctx, ref_frame, -1, ctx.w4, stack, weights, sub, gm)
        counts[0] = sub[0]
        row_match[1] += sub[1]
        counts[2] += sub[2]

    nearest_match = (row_match[1] > 0) + (col_match[1] > 0)
    nearest_refmv_count = counts[0]
    for idx in range(nearest_refmv_count):
        weights[idx] += REF_CAT_LEVEL
    newmv_count = counts[2]

    mode_context_extra = 0
    if tmvp is not None:
        # temporal MV candidates (mvref_common.c:542 + add_tpl_ref_mv:324)
        is_comp = isinstance(ref_frame, tuple)
        rf0 = ref_frame[0] if is_comp else ref_frame
        rf1 = ref_frame[1] if is_comp else -1
        cur = tmvp["cur_hint"]
        off0 = tmvp["rel"](cur, tmvp["hints"][rf0])
        off1 = tmvp["rel"](cur, tmvp["hints"][rf1]) if rf1 > 0 else 0
        tpl_valid = tmvp["valid"]
        tpl_mv = tmvp["mfmv"]
        tpl_off = tmvp["offset"]
        h2, w2 = tpl_valid.shape
        allow_hp = tmvp["allow_hp"]
        force_int = tmvp["force_int"]

        def add_tpl(blk_row, blk_col):
            nonlocal mode_context_extra
            pr = blk_row if (ctx.mi_row & 1) else blk_row + 1
            pc = blk_col if (ctx.mi_col & 1) else blk_col + 1
            if not _is_inside(ctx, pr, pc):
                return 0
            tr = (ctx.mi_row + pr) >> 1
            tc = (ctx.mi_col + pc) >> 1
            if tr >= h2 or tc >= w2 or not tpl_valid[tr, tc]:
                return 0
            base = (int(tpl_mv[tr, tc, 0]), int(tpl_mv[tr, tc, 1]))
            this = lower_mv_precision(
                mv_projection(base, off0, int(tpl_off[tr, tc])),
                allow_hp, force_int)
            gm_mv = gm["mv"] if gm is not None else ((0, 0), (0, 0))
            if not is_comp:
                if blk_row == 0 and blk_col == 0:
                    if (abs(this[0] - gm_mv[0][0]) >= 16
                            or abs(this[1] - gm_mv[0][1]) >= 16):
                        mode_context_extra |= 1 << GLOBALMV_OFFSET
                for idx in range(counts[0]):
                    if stack[idx] == this:
                        weights[idx] += 2
                        break
                else:
                    if counts[0] < MAX_REF_MV_STACK_SIZE:
                        stack[counts[0]] = this
                        weights[counts[0]] = 2
                        counts[0] += 1
            else:
                comp = lower_mv_precision(
                    mv_projection(base, off1, int(tpl_off[tr, tc])),
                    allow_hp, force_int)
                pair = (this, comp)
                if blk_row == 0 and blk_col == 0:
                    if (abs(this[0] - gm_mv[0][0]) >= 16
                            or abs(this[1] - gm_mv[0][1]) >= 16
                            or abs(comp[0] - gm_mv[1][0]) >= 16
                            or abs(comp[1] - gm_mv[1][1]) >= 16):
                        mode_context_extra |= 1 << GLOBALMV_OFFSET
                for idx in range(counts[0]):
                    if stack[idx] == pair:
                        weights[idx] += 2
                        break
                else:
                    if counts[0] < MAX_REF_MV_STACK_SIZE:
                        stack[counts[0]] = pair
                        weights[counts[0]] = 2
                        counts[0] += 1
            return 1

        voffset = max(2, ctx.h4)
        hoffset = max(2, ctx.w4)
        blk_row_end = min(ctx.h4, 16)
        blk_col_end = min(ctx.w4, 16)
        allow_ext = (2 <= ctx.h4 < 16) and (2 <= ctx.w4 < 16)
        step_h = 4 if ctx.h4 >= 16 else 2
        step_w = 4 if ctx.w4 >= 16 else 2
        is_available = 0
        for blk_row in range(0, blk_row_end, step_h):
            for blk_col in range(0, blk_col_end, step_w):
                ret = add_tpl(blk_row, blk_col)
                if blk_row == 0 and blk_col == 0:
                    is_available = ret
        if is_available == 0:
            mode_context_extra |= 1 << GLOBALMV_OFFSET
        if allow_ext:
            for (br, bc) in ((voffset, -2), (voffset, hoffset),
                             (voffset - 2, hoffset)):
                row_in_sb = ctx.mi_row & 15
                col_in_sb = ctx.mi_col & 15
                if (0 <= row_in_sb + br < 16
                        and 0 <= col_in_sb + bc < 16):
                    add_tpl(br, bc)

    # outer area
    sub = [counts[0], 0, 0]
    _scan_blk(ctx, ref_frame, -1, -1, stack, weights, sub, gm)
    counts[0] = sub[0]
    row_match[1] += sub[1]
    for idx in range(2, MVREF_ROW_COLS + 1):
        row_offset = -(idx << 1) + 1 + row_adj
        col_offset = -(idx << 1) + 1 + col_adj
        if (abs(row_offset) <= abs(max_row_offset)
                and abs(row_offset) > processed_rows[0]):
            sub = [counts[0], 0, 0]
            _scan_row(ctx, ref_frame, row_offset, stack, weights, sub,
                      max_row_offset, processed_rows, gm)
            counts[0] = sub[0]
            row_match[1] += sub[1]
        if (abs(col_offset) <= abs(max_col_offset)
                and abs(col_offset) > processed_cols[0]):
            sub = [counts[0], 0, 0]
            _scan_col(ctx, ref_frame, col_offset, stack, weights, sub,
                      max_col_offset, processed_cols, gm)
            counts[0] = sub[0]
            col_match[1] += sub[1]

    ref_match_count = (row_match[1] > 0) + (col_match[1] > 0)
    mode_context = mode_context_extra
    if nearest_match == 0:
        if ref_match_count >= 1:
            mode_context |= 1
        if ref_match_count == 1:
            mode_context |= 1 << REFMV_OFFSET
        elif ref_match_count >= 2:
            mode_context |= 2 << REFMV_OFFSET
    elif nearest_match == 1:
        mode_context |= 2 if newmv_count > 0 else 3
        if ref_match_count == 1:
            mode_context |= 3 << REFMV_OFFSET
        elif ref_match_count >= 2:
            mode_context |= 4 << REFMV_OFFSET
    else:
        mode_context |= 4 if newmv_count >= 1 else 5
        mode_context |= 5 << REFMV_OFFSET

    refmv_count = counts[0]

    # stable partial bubble sorts (mvref_common.c:641)
    def sort_range(start, length):
        ln = length
        while ln > start:
            nr = start
            for idx in range(start + 1, ln):
                if weights[idx - 1] < weights[idx]:
                    stack[idx - 1], stack[idx] = stack[idx], stack[idx - 1]
                    weights[idx - 1], weights[idx] = (weights[idx],
                                                      weights[idx - 1])
                    nr = idx
            ln = nr

    sort_range(0, nearest_refmv_count)
    sort_range(nearest_refmv_count, refmv_count)

    mi_width = min(16, ctx.w4, g.mi_cols - ctx.mi_col)
    mi_height = min(16, ctx.h4, g.mi_rows - ctx.mi_row)
    mi_size = min(mi_width, mi_height)

    if isinstance(ref_frame, tuple):
        # compound extension (mvref_common.c:680): derive up to two
        # candidate pairs from above/left rows, pad with global mvs
        if refmv_count < MAX_MV_REF_CANDIDATES:
            ref_id = [[], []]
            ref_diff = [[], []]

            def process_comp(cand):
                r0, r1, _, _, mv = cand
                for which, rr in ((0, r0), (1, r1)):
                    if rr <= c.INTRA_FRAME:
                        continue
                    for cmp_idx in range(2):
                        if rr == ref_frame[cmp_idx] and \
                                len(ref_id[cmp_idx]) < 2:
                            ref_id[cmp_idx].append(
                                (int(mv[which][0]), int(mv[which][1])))
                        elif len(ref_diff[cmp_idx]) < 2:
                            this = (int(mv[which][0]), int(mv[which][1]))
                            if sign_bias is not None and \
                                    sign_bias[rr] != \
                                    sign_bias[ref_frame[cmp_idx]]:
                                this = (-this[0], -this[1])
                            ref_diff[cmp_idx].append(this)

            idx = 0
            while abs(max_row_offset) >= 1 and idx < mi_size:
                cand = g.at(ctx.mi_row - 1, ctx.mi_col + idx)
                process_comp(cand)
                idx += _mi_wide(cand[3])
            idx = 0
            while abs(max_col_offset) >= 1 and idx < mi_size:
                cand = g.at(ctx.mi_row + idx, ctx.mi_col - 1)
                process_comp(cand)
                idx += _mi_high(cand[3])

            comp_list = [[(0, 0)] * 2 for _ in range(MAX_MV_REF_CANDIDATES)]
            for cmp_idx in range(2):
                cands = (ref_id[cmp_idx] + ref_diff[cmp_idx]
                         )[:MAX_MV_REF_CANDIDATES]
                gm_fill = gm["mv"][cmp_idx] if gm is not None else (0, 0)
                for k in range(MAX_MV_REF_CANDIDATES):
                    comp_list[k][cmp_idx] = cands[k] if k < len(cands) \
                        else gm_fill
            if refmv_count:
                if (comp_list[0][0] == stack[0][0]
                        and comp_list[0][1] == stack[0][1]):
                    stack[refmv_count] = (comp_list[1][0], comp_list[1][1])
                else:
                    stack[refmv_count] = (comp_list[0][0], comp_list[0][1])
                weights[refmv_count] = 2
                refmv_count += 1
            else:
                for k in range(MAX_MV_REF_CANDIDATES):
                    stack[refmv_count] = (comp_list[k][0], comp_list[k][1])
                    weights[refmv_count] = 2
                    refmv_count += 1
        for i in range(refmv_count):
            stack[i] = (_clamp_mv_ref(stack[i][0], ctx),
                        _clamp_mv_ref(stack[i][1], ctx))
        return stack, weights, refmv_count, mode_context, None

    def process_single(cand):
        nonlocal refmv_count
        ref0, ref1, _, _, mv = cand
        if ref0 == INTRABC_REF:
            # intrabc neighbor: ref_frame[0] is INTRA_FRAME, never added by
            # process_single_ref_mv_candidate (mvref_common.c:449)
            ref0 = c.INTRA_FRAME
        for which, rr in ((0, ref0), (1, ref1)):
            if rr > c.INTRA_FRAME and refmv_count < MAX_MV_REF_CANDIDATES:
                this = (int(mv[which][0]), int(mv[which][1]))
                if sign_bias is not None and \
                        sign_bias[rr] != sign_bias[ref_frame]:
                    this = (-this[0], -this[1])
                for idx in range(refmv_count):
                    if stack[idx] == this:
                        break
                else:
                    stack[refmv_count] = this
                    weights[refmv_count] = 2
                    refmv_count += 1

    idx = 0
    while (abs(max_row_offset) >= 1 and idx < mi_size
           and refmv_count < MAX_MV_REF_CANDIDATES):
        cand = g.at(ctx.mi_row - 1, ctx.mi_col + idx)
        process_single(cand)
        idx += _mi_wide(cand[3])
    idx = 0
    while (abs(max_col_offset) >= 1 and idx < mi_size
           and refmv_count < MAX_MV_REF_CANDIDATES):
        cand = g.at(ctx.mi_row + idx, ctx.mi_col - 1)
        process_single(cand)
        idx += _mi_high(cand[3])

    for i in range(refmv_count):
        stack[i] = _clamp_mv_ref(stack[i], ctx)

    gm_fill = gm["mv"][0] if gm is not None else (0, 0)
    mv_ref_list = [gm_fill] * MAX_MV_REF_CANDIDATES
    for i in range(min(MAX_MV_REF_CANDIDATES, refmv_count)):
        mv_ref_list[i] = stack[i]
    return stack, weights, refmv_count, mode_context, mv_ref_list


def find_ref_dv(tile_mi_row_start: int, sb_mi: int, mi_row: int):
    """av1_find_ref_dv (mvref_common.h:266): fallback DV predictor when the
    ref-MV stack yields nothing; q8 (row, col)."""
    if mi_row - sb_mi < tile_mi_row_start:
        full = (0, -4 * sb_mi - INTRABC_DELAY_PIXELS)
    else:
        full = (-4 * sb_mi, 0)
    return (full[0] * 8, full[1] * 8)


def _round2s(x: int, n: int) -> int:
    if x < 0:
        return -((-x + (1 << (n - 1))) >> n)
    return (x + (1 << (n - 1))) >> n


def _integer_mv_component(v: int) -> int:
    """integer_mv_precision (mv.h:199), one component."""
    mod = v - (v // 8) * 8 if v >= 0 else -((-v) - ((-v) // 8) * 8)
    if mod != 0:
        v -= mod
        if abs(mod) > 4:
            v += 8 if mod > 0 else -8
    return v


def _convert_to_trans_prec(allow_hp: int, coor: int) -> int:
    if allow_hp:
        return _round2s(coor, 16 - 3)
    return _round2s(coor, 16 - 2) * 2


def gm_get_motion_vector(gm_entry, allow_hp, bw, bh, mi_col, mi_row,
                         is_integer):
    """gm_get_motion_vector (mv.h:231).  gm_entry = (wmtype, mat,
    invalid, shear); bw/bh = block dims in pixels.  Keeps the spec's
    row/col swap for TRANSLATION models (crbug.com/aomedia/3328)."""
    wmtype, mat = gm_entry[0], gm_entry[1]
    if wmtype == c.IDENTITY:
        return (0, 0)
    if wmtype == c.TRANSLATION:
        row = mat[0] >> 13          # GM_TRANS_ONLY_PREC_DIFF
        col = mat[1] >> 13
        if is_integer:
            row = _integer_mv_component(row)
            col = _integer_mv_component(col)
        return (row, col)
    x = mi_col * 4 + bw // 2 - 1
    y = mi_row * 4 + bh // 2 - 1
    xc = (mat[2] - (1 << 16)) * x + mat[3] * y + mat[0]
    yc = mat[4] * x + (mat[5] - (1 << 16)) * y + mat[1]
    tx = _convert_to_trans_prec(allow_hp, xc)
    ty = _convert_to_trans_prec(allow_hp, yc)
    if is_integer:
        ty = _integer_mv_component(ty)
        tx = _integer_mv_component(tx)
    return (ty, tx)


def is_global_mv_block(mode, bsize, wmtype) -> bool:
    """is_global_mv_block (blockd.h:421)."""
    return (mode in (GLOBALMV, GLOBAL_GLOBALMV) and wmtype > c.TRANSLATION
            and _mi_wide(bsize) >= 2 and _mi_high(bsize) >= 2)


def lower_mv_precision(mv, allow_hp: int, force_int: int):
    row, col = mv
    if force_int:
        row = (row // 8 if row >= 0 else -((-row) // 8)) * 8
        col = (col // 8 if col >= 0 else -((-col) // 8)) * 8
        return (row, col)
    if not allow_hp:
        if row & 1:
            row += -1 if row > 0 else 1
        if col & 1:
            col += -1 if col > 0 else 1
    return (row, col)


def drl_ctx(weights, idx: int) -> int:
    if weights[idx] >= REF_CAT_LEVEL and weights[idx + 1] >= REF_CAT_LEVEL:
        return 0
    if weights[idx] >= REF_CAT_LEVEL > weights[idx + 1]:
        return 1
    if weights[idx] < REF_CAT_LEVEL and weights[idx + 1] < REF_CAT_LEVEL:
        return 2
    return 0


# ---------------------------------------------------------------------------
# neighbor-based signalling contexts (pred_common.c)
# ---------------------------------------------------------------------------


def _neighbor(g: MiGrids, mi_row: int, mi_col: int):
    return (int(g.ref0[mi_row + g.m, mi_col + g.m]),
            int(g.ref1[mi_row + g.m, mi_col + g.m]))


def neighbors_ref_counts(g: MiGrids, mi_row: int, mi_col: int,
                         up: bool, left: bool) -> np.ndarray:
    counts = np.zeros(c.REF_FRAMES, np.int32)
    if up:
        r0, r1 = _neighbor(g, mi_row - 1, mi_col)
        if r0 > c.INTRA_FRAME:
            counts[r0] += 1
            if r1 > c.INTRA_FRAME:
                counts[r1] += 1
    if left:
        r0, r1 = _neighbor(g, mi_row, mi_col - 1)
        if r0 > c.INTRA_FRAME:
            counts[r0] += 1
            if r1 > c.INTRA_FRAME:
                counts[r1] += 1
    return counts


def _vote(a: int, b: int) -> int:
    return 1 if a == b else (0 if a < b else 2)


def ctx_single_ref_p1(counts) -> int:
    fwd = int(counts[1] + counts[2] + counts[3] + counts[4])
    bwd = int(counts[5] + counts[6] + counts[7])
    return _vote(fwd, bwd)


def ctx_single_ref_p2(counts) -> int:   # BWD/ALT2 vs ALT
    return _vote(int(counts[5] + counts[6]), int(counts[7]))


def ctx_single_ref_p3(counts) -> int:   # L/L2 vs L3/G
    return _vote(int(counts[1] + counts[2]), int(counts[3] + counts[4]))


def ctx_single_ref_p4(counts) -> int:   # L vs L2
    return _vote(int(counts[1]), int(counts[2]))


def ctx_single_ref_p5(counts) -> int:   # L3 vs G
    return _vote(int(counts[3]), int(counts[4]))


def ctx_single_ref_p6(counts) -> int:   # BWD vs ALT2
    return _vote(int(counts[5]), int(counts[6]))


def intra_inter_ctx(g: MiGrids, mi_row: int, mi_col: int, up: bool,
                    left: bool) -> int:
    """pred_common.c:124."""
    if up and left:
        a = _neighbor(g, mi_row - 1, mi_col)[0] <= c.INTRA_FRAME
        l = _neighbor(g, mi_row, mi_col - 1)[0] <= c.INTRA_FRAME
        return 3 if (a and l) else int(a or l)
    if up or left:
        edge = (_neighbor(g, mi_row - 1, mi_col) if up
                else _neighbor(g, mi_row, mi_col - 1))
        return 2 * (edge[0] <= c.INTRA_FRAME)
    return 0


def skip_mode_ctx(g: MiGrids, mi_row: int, mi_col: int, up: bool, left: bool,
                  skip_mode_grid: np.ndarray) -> int:
    """above skip_mode + left skip_mode (pred_common.h
    av1_get_skip_mode_context)."""
    m = g.m
    a = int(skip_mode_grid[mi_row - 1 + m, mi_col + m]) if up else 0
    l = int(skip_mode_grid[mi_row + m, mi_col - 1 + m]) if left else 0
    return a + l


# ---------------------------------------------------------------------------
# temporal motion-field projection (shared encoder/decoder, vectorized)
# ---------------------------------------------------------------------------

def _motion_field_projection_np(tpl_mfmv, tpl_valid, tpl_offset, buf,
                                cur_hint, rel, mi_rows, mi_cols,
                                direction) -> int:
    """motion_field_projection (mvref_common.c:911), numpy formulation.

    Scatters the stored per-8x8 MVs of `buf` into the current frame's
    temporal MV field.  Duplicate targets resolve to the last source in
    row-major order (C fancy-assignment), matching the reference's scan
    order.  Both the encoder and the decoder call this, so trial-time
    and decode-time fields agree by construction."""
    import numpy as _np
    from ..bitstream import constants as c
    if buf is None or buf.get("mvs") is None:
        return 0
    if buf.get("frame_type", c.INTER_FRAME) in (c.KEY_FRAME,
                                                c.INTRA_ONLY_FRAME):
        return 0
    if buf.get("mi_dims") != (mi_rows, mi_cols):
        return 0
    start_hint = buf["order_hint"]
    ref_hints_of_start = buf.get("ref_order_hints", (0,) * 7)
    s2c = rel(start_hint, cur_hint)
    if direction == 2:
        s2c = -s2c
    if abs(s2c) > MAX_FRAME_DISTANCE:
        return 1
    ref_offset = _np.zeros(8, _np.int32)
    for rf in range(1, 8):
        ref_offset[rf] = rel(start_hint, ref_hints_of_start[rf - 1])
    mv_ref, mv_mv = buf["mvs"]
    h2, w2 = mv_ref.shape
    rf = mv_ref.astype(_np.int32)
    roff = ref_offset[_np.clip(rf, 0, 7)]
    ok = (rf > c.INTRA_FRAME) & (roff > 0) & (roff <= 31)
    if not ok.any():
        return 1
    # get_mv_projection, vectorized (num=s2c, den=roff)
    num = max(-MAX_FRAME_DISTANCE, min(MAX_FRAME_DISTANCE, s2c))
    mult = _np.asarray(_DIV_MULT, _np.int64)[_np.clip(roff, 0, 31)]
    mv64 = mv_mv.astype(_np.int64)
    pr = mv64[..., 0] * num * mult
    pc = mv64[..., 1] * num * mult

    def r2s(x):
        neg = x < 0
        mag = _np.where(neg, -x, x)
        out = (mag + (1 << 13)) >> 14
        return _np.where(neg, -out, out).astype(_np.int32)

    pr = _np.clip(r2s(pr), -(1 << 14) + 1, (1 << 14) - 1)
    pc = _np.clip(r2s(pc), -(1 << 14) + 1, (1 << 14) - 1)
    # get_block_position (mvref_common.c:873)

    def shr6(x):
        neg = x < 0
        mag = _np.where(neg, -x, x) >> 6
        return _np.where(neg, -mag, mag)

    br = _np.arange(h2, dtype=_np.int32)[:, None].repeat(w2, 1)
    bc = _np.arange(w2, dtype=_np.int32)[None, :].repeat(h2, 0)
    sb = direction >> 1
    ro, co = shr6(pr), shr6(pc)
    row = br - ro if sb == 1 else br + ro
    col = bc - co if sb == 1 else bc + co
    ok &= (row >= 0) & (row < (mi_rows >> 1)) \
        & (col >= 0) & (col < (mi_cols >> 1))
    base_r = (br >> 3) << 3
    base_c = (bc >> 3) << 3
    ok &= (base_r <= row) & (row < base_r + 8) \
        & (base_c - 8 <= col) & (col < base_c + 16)
    if not ok.any():
        return 1
    fr = row[ok]
    fcc = col[ok]
    tpl_mfmv[fr, fcc, 0] = mv_mv[..., 0][ok]
    tpl_mfmv[fr, fcc, 1] = mv_mv[..., 1][ok]
    tpl_offset[fr, fcc] = roff[ok]
    tpl_valid[fr, fcc] = True
    return 1


def setup_motion_field(sh, fh, mi_rows, mi_cols, ref_slot_bufs, ref_hints,
                       rel):
    """av1_setup_motion_field (mvref_common.c:1006): returns the tmvp
    dict find_mv_refs consumes, or the empty field when no ref
    projects.  ref_slot_bufs/ref_hints are enum-indexed (LAST..ALTREF at
    1..7) like decoder.FrameDecoder's."""
    import numpy as _np
    from ..bitstream import constants as c
    h2 = (mi_rows + 1) >> 1
    w2 = (mi_cols + 1) >> 1
    tpl_mfmv = _np.zeros((h2, w2, 2), _np.int16)
    tpl_valid = _np.zeros((h2, w2), bool)
    tpl_offset = _np.zeros((h2, w2), _np.int32)
    tmvp = {
        "mfmv": tpl_mfmv, "valid": tpl_valid, "offset": tpl_offset,
        "cur_hint": fh.order_hint, "hints": ref_hints, "rel": rel,
        "allow_hp": fh.allow_high_precision_mv,
        "force_int": fh.force_integer_mv,
    }

    def proj(ref, direction):
        return _motion_field_projection_np(
            tpl_mfmv, tpl_valid, tpl_offset, ref_slot_bufs[ref],
            fh.order_hint, rel, mi_rows, mi_cols, direction)

    cur = fh.order_hint
    ref_stamp = 2  # MFMV_STACK_SIZE - 1
    lst = ref_slot_bufs[c.LAST_FRAME]
    if lst is not None:
        alt_of_lst = lst.get("ref_order_hints", (0,) * 7)[
            c.ALTREF_FRAME - c.LAST_FRAME]
        if alt_of_lst != ref_hints[c.GOLDEN_FRAME]:
            proj(c.LAST_FRAME, 2)
        ref_stamp -= 1
    if rel(ref_hints[c.BWDREF_FRAME], cur) > 0:
        if proj(c.BWDREF_FRAME, 0):
            ref_stamp -= 1
    if rel(ref_hints[c.ALTREF2_FRAME], cur) > 0:
        if proj(c.ALTREF2_FRAME, 0):
            ref_stamp -= 1
    if rel(ref_hints[c.ALTREF_FRAME], cur) > 0 and ref_stamp >= 0:
        if proj(c.ALTREF_FRAME, 0):
            ref_stamp -= 1
    if ref_stamp >= 0:
        proj(c.LAST2_FRAME, 2)
    return tmvp
