"""Loop restoration: Wiener and self-guided (SGR) filters with the
normative stripe/unit geometry.

Behavioral port of av1/common/restoration.c (av1_loop_restoration_filter_
unit:1024, setup/restore_processing_stripe_boundary:283/387, boxsum:467,
calculate_intermediate_result:674, av1_apply_selfguided_restoration:912,
save_deblock/cdef_boundary_lines:1407/1463) and the Wiener convolve
(av1/common/convolve.c av1_wiener_convolve_add_src_c:1267).  The SGR
x/(x+1) table (with its index-255 special case) is loaded from
data/sgr_x_by_xplus1.npy.
"""

from __future__ import annotations

import os

import numpy as np

RESTORE_NONE = 0
RESTORE_WIENER = 1
RESTORE_SGRPROJ = 2
RESTORE_SWITCHABLE = 3
RESTORE_SWITCHABLE_TYPES = 3

PROC_UNIT_SIZE = 64          # RESTORATION_PROC_UNIT_SIZE
UNIT_OFFSET = 8              # RESTORATION_UNIT_OFFSET
BORDER = 3                   # RESTORATION_BORDER
CTX_VERT = 2                 # RESTORATION_CTX_VERT
UNITSIZE_MAX = 256

# Wiener filter coding (restoration.h:120-167)
WIENER_WIN = 7
WIENER_HALFWIN = 3
WIENER_FILT_STEP = 128
WIENER_TAP_MID = (3, -7, 15)
WIENER_TAP_MIN = (3 - 8, -7 - 16, 15 - 32)
WIENER_TAP_MAX = (3 - 1 + 8, -7 - 1 + 16, 15 - 1 + 32)
WIENER_TAP_K = (1, 2, 3)

# SGR coding (restoration.h:95-118)
SGRPROJ_PARAMS_BITS = 4
SGRPROJ_PRJ_BITS = 7
SGRPROJ_RST_BITS = 4
SGRPROJ_SGR_BITS = 8
SGRPROJ_PRJ_MIN0 = -(1 << SGRPROJ_PRJ_BITS) * 3 // 4
SGRPROJ_PRJ_MAX0 = SGRPROJ_PRJ_MIN0 + (1 << SGRPROJ_PRJ_BITS) - 1
SGRPROJ_PRJ_MIN1 = -(1 << SGRPROJ_PRJ_BITS) // 4
SGRPROJ_PRJ_MAX1 = SGRPROJ_PRJ_MIN1 + (1 << SGRPROJ_PRJ_BITS) - 1
SGRPROJ_PRJ_SUBEXP_K = 4
SGRPROJ_MTABLE_BITS = 20
SGRPROJ_RECIP_BITS = 12

# av1_sgr_params (restoration.c:31): (r0, r1, s0, s1)
SGR_PARAMS = (
    (2, 1, 140, 3236), (2, 1, 112, 2158), (2, 1, 93, 1618),
    (2, 1, 80, 1438), (2, 1, 70, 1295), (2, 1, 58, 1177),
    (2, 1, 47, 1079), (2, 1, 37, 996), (2, 1, 30, 925),
    (2, 1, 25, 863), (0, 1, -1, 2589), (0, 1, -1, 1618),
    (0, 1, -1, 1177), (0, 1, -1, 925), (2, 0, 56, -1), (2, 0, 22, -1),
)

_ONE_BY_X = np.round(4096.0 / (np.arange(1, 26))).astype(np.int64)

_X_BY_XPLUS1 = None


def _x_by_xplus1():
    global _X_BY_XPLUS1
    if _X_BY_XPLUS1 is None:
        _X_BY_XPLUS1 = np.load(os.path.join(
            os.path.dirname(__file__), "..", "..", "data",
            "sgr_x_by_xplus1.npy")).astype(np.int64)
    return _X_BY_XPLUS1


def count_units_in_tile(unit_size: int, tile_size: int) -> int:
    """av1_lr_count_units_in_tile (restoration.c:62)."""
    return max((tile_size + (unit_size >> 1)) // unit_size, 1)


def default_wiener():
    """set_default_wiener (restoration.h:318): 8-tap padded arrays."""
    t0, t1, t2 = WIENER_TAP_MID
    mid = -2 * (t0 + t1 + t2)
    return [t0, t1, t2, mid, t2, t1, t0, 0]


def default_sgrproj():
    # C integer division truncates toward zero: (-96+31)/2 == -32
    return [int((SGRPROJ_PRJ_MIN0 + SGRPROJ_PRJ_MAX0) / 2),
            int((SGRPROJ_PRJ_MIN1 + SGRPROJ_PRJ_MAX1) / 2)]


# ---------------------------------------------------------------------------
# Wiener filter (convolve.c:1217-1296)

def wiener_filter(src, y0, x0, w, h, hfilter, vfilter, bd=8):
    """av1_(highbd_)wiener_convolve_add_src_c on a region of the padded
    plane.

    src: int array with valid pixels surrounding rows [y0-6, y0+h+6) etc;
    output (h, w) pixels.  round_0=3 (+2 at 12-bit per the 16-bit im
    range rule), round_1 = 14 - round_0."""
    hf = np.asarray(hfilter, np.int64)
    vf = np.asarray(vfilter, np.int64)
    r0 = 3 + max(bd + 7 - 3 - 14, 0)
    r1 = 2 * 7 - r0
    ih = h + 7
    # horizontal pass over rows y0-3 .. y0+h+3, producing temp (ih, w)
    reg = src[y0 - 3:y0 + h + 4, x0 - 3:x0 + w + 4].astype(np.int64)
    temp = np.zeros((ih, w), np.int64)
    for k in range(8):
        temp += reg[:, k:k + w] * hf[k]
    temp += (reg[:, 3:3 + w] << 7) + (1 << (bd + 6))
    temp = (temp + (1 << (r0 - 1))) >> r0
    np.clip(temp, 0, (1 << (bd + 1 + 7 - r0)) - 1, out=temp)
    # vertical pass
    out = np.zeros((h, w), np.int64)
    for k in range(8):
        out += temp[k:k + h] * vf[k]
    out += (temp[3:3 + h] << 7) - (1 << (bd + 2 * 7 - r0 - 1))
    out = (out + (1 << (r1 - 1))) >> r1
    return np.clip(out, 0, (1 << bd) - 1).astype(
        np.uint8 if bd == 8 else np.uint16)


# ---------------------------------------------------------------------------
# Self-guided restoration (restoration.c:467-969)

def _boxsum(x, r):
    """boxsum1/boxsum2: vertical then horizontal windowed sums with
    zero-truncated edges (restoration.c:467)."""
    k = 2 * r + 1
    h, w = x.shape
    vp = np.zeros((h + 2 * r, w), np.int64)
    vp[r:r + h] = x
    c = np.zeros((h + 2 * r + 1, w), np.int64)
    np.cumsum(vp, axis=0, out=c[1:])
    v = c[k:] - c[:-k]                       # (h, w)
    hp = np.zeros((h, w + 2 * r), np.int64)
    hp[:, r:r + w] = v
    c2 = np.zeros((h, w + 2 * r + 1), np.int64)
    np.cumsum(hp, axis=1, out=c2[:, 1:])
    return c2[:, k:] - c2[:, :-k]


def _sgr_transform_ab(dgd_ext, r, s, bd=8):
    """calculate_intermediate_result (restoration.c:674): dgd_ext is the
    (h+6, w+6) int window (rows/cols -3..h+2); returns transformed A, B
    over the full extended grid.  For bd > 8 the variance terms are
    pre-rounded (a by 2*(bd-8), b by bd-8) while the B recip keeps the
    unrounded boxsum (restoration.c:709-745)."""
    n = (2 * r + 1) * (2 * r + 1)
    b = _boxsum(dgd_ext, r)
    a = _boxsum(dgd_ext * dgd_ext, r)
    if bd > 8:
        sh = bd - 8
        a_r = (a + (1 << (2 * sh - 1))) >> (2 * sh)
        b_r = (b + (1 << (sh - 1))) >> sh
    else:
        a_r, b_r = a, b
    p = a_r * n - b_r * b_r
    np.maximum(p, 0, out=p)
    # the reference computes p*s in uint32: edge-truncated boxsum windows
    # can push p past the Popoviciu bound and wrap (restoration.c:761)
    z = ((p.astype(np.uint32) * np.uint32(s)
          + np.uint32(1 << (SGRPROJ_MTABLE_BITS - 1)))
         >> np.uint32(SGRPROJ_MTABLE_BITS)).astype(np.int64)
    a2 = _x_by_xplus1()[np.minimum(z, 255)]
    b2 = ((256 - a2) * b * _ONE_BY_X[n - 1]
          + (1 << (SGRPROJ_RECIP_BITS - 1))) >> SGRPROJ_RECIP_BITS
    return a2, b2


def _sgr_flt_fast(dgd_ext, w, h, s, bd=8):
    """selfguided_restoration_fast_internal (r=2, every other row)."""
    a2, b2 = _sgr_transform_ab(dgd_ext, 2, s, bd)
    # index [i+3, j+3] addresses logical (i, j)
    dgd = dgd_ext[3:3 + h, 3:3 + w]
    flt = np.zeros((h, w), np.int64)
    ao = a2[2:, :]  # offset so ao[i, j+2] == A[i-1, j-1] ... simpler slices:

    def A(di, dj):
        return a2[3 + di:3 + di + h, 3 + dj:3 + dj + w]

    def B(di, dj):
        return b2[3 + di:3 + di + h, 3 + dj:3 + dj + w]
    del ao
    even = np.arange(h) % 2 == 0
    a_e = (A(-1, 0) + A(1, 0)) * 6 + \
        (A(-1, -1) + A(1, -1) + A(-1, 1) + A(1, 1)) * 5
    b_e = (B(-1, 0) + B(1, 0)) * 6 + \
        (B(-1, -1) + B(1, -1) + B(-1, 1) + B(1, 1)) * 5
    v_e = a_e * dgd + b_e
    flt_e = (v_e + (1 << 8)) >> 9     # nb=5, SGR_BITS+nb-RST_BITS = 9
    a_o = A(0, 0) * 6 + (A(0, -1) + A(0, 1)) * 5
    b_o = B(0, 0) * 6 + (B(0, -1) + B(0, 1)) * 5
    v_o = a_o * dgd + b_o
    flt_o = (v_o + (1 << 7)) >> 8     # nb=4
    flt[even] = flt_e[even]
    flt[~even] = flt_o[~even]
    return flt


def _sgr_flt_normal(dgd_ext, w, h, s, bd=8):
    """selfguided_restoration_internal (r=1)."""
    a2, b2 = _sgr_transform_ab(dgd_ext, 1, s, bd)
    dgd = dgd_ext[3:3 + h, 3:3 + w]

    def A(di, dj):
        return a2[3 + di:3 + di + h, 3 + dj:3 + dj + w]

    def B(di, dj):
        return b2[3 + di:3 + di + h, 3 + dj:3 + dj + w]
    a = (A(0, 0) + A(0, -1) + A(0, 1) + A(-1, 0) + A(1, 0)) * 4 + \
        (A(-1, -1) + A(1, -1) + A(-1, 1) + A(1, 1)) * 3
    b = (B(0, 0) + B(0, -1) + B(0, 1) + B(-1, 0) + B(1, 0)) * 4 + \
        (B(-1, -1) + B(1, -1) + B(-1, 1) + B(1, 1)) * 3
    v = a * dgd + b
    return (v + (1 << 8)) >> 9


def sgr_filter(src, y0, x0, w, h, ep, xqd, bd=8):
    """av1_apply_selfguided_restoration_c (restoration.c:912) on a region
    of the padded plane; output (h, w) pixels."""
    r0, r1, s0, s1 = SGR_PARAMS[ep]
    dgd_ext = src[y0 - 3:y0 + h + 3, x0 - 3:x0 + w + 3].astype(np.int64)
    dat = dgd_ext[3:3 + h, 3:3 + w]
    u = dat << SGRPROJ_RST_BITS
    v = u << SGRPROJ_PRJ_BITS
    if r0 == 0:
        xq = [0, (1 << SGRPROJ_PRJ_BITS) - xqd[1]]
    elif r1 == 0:
        xq = [xqd[0], 0]
    else:
        xq = [xqd[0], (1 << SGRPROJ_PRJ_BITS) - xqd[0] - xqd[1]]
    if r0 > 0:
        flt0 = _sgr_flt_fast(dgd_ext, w, h, s0, bd)
        v = v + xq[0] * (flt0 - u)
    if r1 > 0:
        flt1 = _sgr_flt_normal(dgd_ext, w, h, s1, bd)
        v = v + xq[1] * (flt1 - u)
    out = (v + (1 << (SGRPROJ_PRJ_BITS + SGRPROJ_RST_BITS - 1))) \
        >> (SGRPROJ_PRJ_BITS + SGRPROJ_RST_BITS)
    return np.clip(out, 0, (1 << bd) - 1).astype(
        np.uint8 if bd == 8 else np.uint16)


# ---------------------------------------------------------------------------
# Stripe / unit orchestration

class PlaneRestoration:
    """Per-plane restoration state for one frame."""

    def __init__(self, frame_rtype: int, unit_size: int, plane_w: int,
                 plane_h: int):
        self.frame_rtype = frame_rtype
        self.unit_size = unit_size
        self.hunits = count_units_in_tile(unit_size, plane_w)
        self.vunits = count_units_in_tile(unit_size, plane_h)
        self.plane_w, self.plane_h = plane_w, plane_h
        # unit_info[idx] = (rtype, info); info = (hf, vf) or (ep, xqd)
        self.unit_info = [(RESTORE_NONE, None)] * (self.hunits * self.vunits)


def save_boundary_lines(plane, ss_y, after_cdef, bounds, upscale_to=None,
                        bd=8, upscale_in_w=None):
    """av1_loop_restoration_save_boundary_lines (restoration.c:1563) for
    one plane.  plane: current (deblocked or CDEFed) pixels; bounds:
    dict with 'above'/'below' arrays [n_stripes][CTX_VERT][w+8] (with 4px
    horizontal extension, RESTORATION_EXTRA_HORZ).  upscale_to: superres
    target width — pre-CDEF lines are upscaled at save time
    (save_deblock_boundary_lines)."""
    h, w = plane.shape
    if upscale_to is not None:
        from . import resize as RS
        logical_w = upscale_in_w if upscale_in_w is not None else w

        def _xform(rows):
            return RS.upscale_normative_rows(rows, upscale_to, bd,
                                             in_w=logical_w)
        w_out = upscale_to
        w = logical_w
    else:
        def _xform(rows):
            return rows
        w_out = w
    stripe_height = PROC_UNIT_SIZE >> ss_y
    stripe_off = UNIT_OFFSET >> ss_y
    tile_stripe = 0
    while True:
        rel_y0 = max(0, tile_stripe * stripe_height - stripe_off)
        y0 = rel_y0
        if y0 >= h:
            break
        rel_y1 = (tile_stripe + 1) * stripe_height - stripe_off
        y1 = min(rel_y1, h)
        use_deblock_above = tile_stripe > 0
        use_deblock_below = y1 < h
        if not after_cdef:
            if use_deblock_above:
                rows = _xform(plane[y0 - CTX_VERT:y0])
                bounds["above"][tile_stripe] = _extend_rows(rows, w_out)
            if use_deblock_below:
                rows = plane[y1:y1 + CTX_VERT]
                if rows.shape[0] == 1:
                    rows = np.repeat(rows, CTX_VERT, axis=0)
                bounds["below"][tile_stripe] = _extend_rows(_xform(rows),
                                                            w_out)
        else:
            if not use_deblock_above:
                rows = np.repeat(plane[y0:y0 + 1], CTX_VERT, axis=0)
                bounds["above"][tile_stripe] = _extend_rows(rows, w)
            if not use_deblock_below:
                rows = np.repeat(plane[y1 - 1:y1], CTX_VERT, axis=0)
                bounds["below"][tile_stripe] = _extend_rows(rows, w)
        tile_stripe += 1


def _extend_rows(rows, w):
    """extend_lines: replicate 4 pixels (RESTORATION_EXTRA_HORZ) on both
    sides; returned width w + 2*4 with logical col0 at index 4."""
    out = np.empty((rows.shape[0], w + 8), rows.dtype)
    out[:, 4:4 + w] = rows[:, :w]
    out[:, :4] = rows[:, :1]
    out[:, 4 + w:] = rows[:, w - 1:w]
    return out


# padding of the working buffer: the Wiener procunit width rounds up to a
# multiple of 16, so the filter can read up to 15+4 px past the unit edge
# plus 3 border taps
PAD = 24


def filter_frame_plane(plane, pr: PlaneRestoration, ss_y, bounds,
                       optimized, bd=8):
    """av1_loop_restoration_filter_frame for one plane: returns the
    restored plane.  plane: post-CDEF pixels."""
    h, w = plane.shape
    # working buffer: plane with replicate border (av1_extend_frame uses
    # RESTORATION_BORDER=3; use PAD for safety on wiener column rounding)
    data = np.empty((h + 2 * PAD, w + 2 * PAD), plane.dtype)
    data[PAD:PAD + h, PAD:PAD + w] = plane
    data[PAD:PAD + h, :PAD] = plane[:, :1]
    data[PAD:PAD + h, PAD + w:] = plane[:, w - 1:]
    data[:PAD] = data[PAD]
    data[PAD + h:] = data[PAD + h - 1]
    dst = data.copy()

    unit_size = pr.unit_size
    ext_size = unit_size * 3 // 2
    stripe_height = PROC_UNIT_SIZE >> ss_y
    stripe_off = UNIT_OFFSET >> ss_y

    y0 = 0
    ri = 0
    while y0 < h:
        remaining_h = h - y0
        uh = remaining_h if remaining_h < ext_size else unit_size
        v_start = max(0, y0 - stripe_off)
        v_end = y0 + uh
        if v_end < h:
            v_end -= stripe_off
        x0 = 0
        ci = 0
        while x0 < w:
            remaining_w = w - x0
            uw = remaining_w if remaining_w < ext_size else unit_size
            rtype, info = pr.unit_info[ri * pr.hunits + ci]
            _filter_unit(data, dst, v_start, v_end, x0, x0 + uw, rtype,
                         info, ss_y, h, bounds, optimized, bd)
            x0 += uw
            ci += 1
        y0 += uh
        ri += 1
    return dst[PAD:PAD + h, PAD:PAD + w]


def _filter_unit(data, dst, v_start, v_end, h_start, h_end, rtype, info,
                 ss_y, plane_h, bounds, optimized, bd=8):
    """av1_loop_restoration_filter_unit (restoration.c:1024)."""
    if rtype == RESTORE_NONE:
        dst[PAD + v_start:PAD + v_end, PAD + h_start:PAD + h_end] = \
            data[PAD + v_start:PAD + v_end, PAD + h_start:PAD + h_end]
        return
    full_stripe_height = PROC_UNIT_SIZE >> ss_y
    runit_offset = UNIT_OFFSET >> ss_y
    unit_w = h_end - h_start
    i = 0
    while v_start + i < v_end:
        ys = v_start + i
        # get_stripe_boundary_info
        first_stripe = ys == 0
        this_stripe_h = full_stripe_height - (runit_offset if first_stripe
                                              else 0)
        last_stripe = ys + this_stripe_h >= plane_h
        copy_above = not first_stripe
        copy_below = not last_stripe
        tile_stripe = (ys + runit_offset) // full_stripe_height
        nominal_h = full_stripe_height - (runit_offset
                                          if tile_stripe == 0 else 0)
        sh = min(nominal_h, v_end - ys)

        saved = _setup_stripe_boundary(
            data, ys, sh, h_start, h_end, tile_stripe, bounds,
            copy_above, copy_below, plane_h, optimized)

        if rtype == RESTORE_WIENER:
            # procunit loop with 16-col rounding (wiener_filter_stripe)
            j = 0
            while j < unit_w:
                pw = min(PROC_UNIT_SIZE, (unit_w - j + 15) & ~15)
                out = wiener_filter(data, PAD + ys, PAD + h_start + j,
                                    pw, sh, info[0], info[1], bd)
                dst[PAD + ys:PAD + ys + sh,
                    PAD + h_start + j:PAD + h_start + j + pw] = out
                j += PROC_UNIT_SIZE
        else:  # RESTORE_SGRPROJ
            j = 0
            while j < unit_w:
                pw = min(PROC_UNIT_SIZE, unit_w - j)
                out = sgr_filter(data, PAD + ys, PAD + h_start + j,
                                 pw, sh, info[0], info[1], bd)
                dst[PAD + ys:PAD + ys + sh,
                    PAD + h_start + j:PAD + h_start + j + pw] = out
                j += PROC_UNIT_SIZE

        _restore_stripe_boundary(data, saved)
        i += sh


def _setup_stripe_boundary(data, ys, sh, h_start, h_end, tile_stripe,
                           bounds, copy_above, copy_below, plane_h,
                           optimized):
    """setup_processing_stripe_boundary (restoration.c:283).  Returns the
    saved rows for restore.  Columns replaced span
    [h_start - 4, h_end + 4) (RESTORATION_EXTRA_HORZ)."""
    c0 = PAD + h_start - 4
    c1 = PAD + h_end + 4
    saved = []
    if not optimized:
        if copy_above:
            ab = bounds["above"][tile_stripe]
            # boundary buffer logical col0 at index 4; our slice starts at
            # h_start-4 -> buffer index h_start-4+4 = h_start
            bs = h_start
            be = bs + (c1 - c0)
            for i in range(-BORDER, 0):
                row = PAD + ys + i
                buf_row = max(i + CTX_VERT, 0)
                saved.append((row, c0, data[row, c0:c1].copy()))
                data[row, c0:c1] = ab[buf_row, bs:be]
        if copy_below:
            bb = bounds["below"][tile_stripe]
            bs = h_start
            be = bs + (c1 - c0)
            for i in range(BORDER):
                row = PAD + ys + sh + i
                buf_row = min(i, CTX_VERT - 1)
                saved.append((row, c0, data[row, c0:c1].copy()))
                data[row, c0:c1] = bb[buf_row, bs:be]
    else:
        if copy_above:
            row = PAD + ys - BORDER
            saved.append((row, c0, data[row, c0:c1].copy()))
            data[row, c0:c1] = data[row + 1, c0:c1]
        if copy_below:
            row = PAD + ys + sh + 2
            saved.append((row, c0, data[row, c0:c1].copy()))
            data[row, c0:c1] = data[row - 1, c0:c1]
    return saved


def _restore_stripe_boundary(data, saved):
    for row, c0, vals in saved:
        data[row, c0:c0 + len(vals)] = vals
