"""Warped motion: sample collection, affine LS fit, shear params, and the
normative warp filter.

Behavioral port of av1/common/warped_motion.c (find_affine_int:894,
av1_get_shear_params:218, av1_warp_affine_c:538, resolve_divisor:170) and
mvref_common.c av1_findSamples:1109 / av1_selectSamples:1083.  The warp
kernel table (spec 7.11.3.7) is loaded from data/warp_filter.npy.
"""

from __future__ import annotations

import os

import numpy as np

WARPEDMODEL_PREC_BITS = 16
WARPEDMODEL_TRANS_CLAMP = 128 << WARPEDMODEL_PREC_BITS
WARPEDMODEL_NONDIAGAFFINE_CLAMP = 1 << (WARPEDMODEL_PREC_BITS - 3)
WARPEDPIXEL_PREC_BITS = 6
WARPEDPIXEL_PREC_SHIFTS = 1 << WARPEDPIXEL_PREC_BITS
WARPEDDIFF_PREC_BITS = WARPEDMODEL_PREC_BITS - WARPEDPIXEL_PREC_BITS
WARP_PARAM_REDUCE_BITS = 6
LEAST_SQUARES_SAMPLES_MAX = 8
LS_MV_MAX = 256
LS_STEP = 8
DIV_LUT_PREC_BITS = 14
DIV_LUT_BITS = 8

_WARP_FILTER = None


def warp_filter():
    global _WARP_FILTER
    if _WARP_FILTER is None:
        _WARP_FILTER = np.load(os.path.join(
            os.path.dirname(__file__), "..", "..", "data",
            "warp_filter.npy")).astype(np.int32)
    return _WARP_FILTER


# div_lut (warped_motion.c:141): mult = round(2^14 * 256/(256+f)) form
_DIV_LUT = None


def _div_lut():
    global _DIV_LUT
    if _DIV_LUT is None:
        f = np.arange(257, dtype=np.float64)
        _DIV_LUT = np.floor((1 << DIV_LUT_PREC_BITS) * 256.0 / (256.0 + f)
                            + 0.5).astype(np.int64)
    return _DIV_LUT


def _round2(x: int, n: int) -> int:
    if n == 0:
        return x
    return (x + (1 << (n - 1))) >> n


def _round2s(x: int, n: int) -> int:
    if n == 0:
        return x
    return -_round2(-x, n) if x < 0 else _round2(x, n)


def _msb(v: int) -> int:
    return max(0, v.bit_length() - 1)


def resolve_divisor_64(d: int):
    shift = _msb(d)
    e = d - (1 << shift)
    if shift > DIV_LUT_BITS:
        f = _round2(e, shift - DIV_LUT_BITS)
    else:
        f = e << (DIV_LUT_BITS - shift)
    return int(_div_lut()[f]), shift + DIV_LUT_PREC_BITS


def resolve_divisor_32(d: int):
    return resolve_divisor_64(d)


def get_shear_params(mat):
    """av1_get_shear_params; returns (ok, alpha, beta, gamma, delta)."""
    if mat[2] <= 0:
        return False, 0, 0, 0, 0

    def clamp16(v):
        return max(-32768, min(32767, v))
    alpha = clamp16(mat[2] - (1 << WARPEDMODEL_PREC_BITS))
    beta = clamp16(mat[3])
    y, shift = resolve_divisor_32(abs(mat[2]))
    if mat[2] < 0:
        y = -y
    v = (mat[4] << WARPEDMODEL_PREC_BITS) * y
    gamma = clamp16(_round2s(v, shift))
    v = (mat[3] * mat[4]) * y
    delta = clamp16(mat[5] - _round2s(v, shift)
                    - (1 << WARPEDMODEL_PREC_BITS))

    def reduce(v):
        return _round2s(v, WARP_PARAM_REDUCE_BITS) * \
            (1 << WARP_PARAM_REDUCE_BITS)
    alpha, beta, gamma, delta = map(reduce, (alpha, beta, gamma, delta))
    if (4 * abs(alpha) + 7 * abs(beta) >= (1 << WARPEDMODEL_PREC_BITS)
            or 4 * abs(gamma) + 4 * abs(delta)
            >= (1 << WARPEDMODEL_PREC_BITS)):
        return False, alpha, beta, gamma, delta
    return True, alpha, beta, gamma, delta


def _ls_square(a):
    return (a * a * 4 + a * 4 * LS_STEP + LS_STEP * LS_STEP * 2) >> 4


def _ls_product1(a, b):
    return (a * b * 4 + (a + b) * 2 * LS_STEP + LS_STEP * LS_STEP) >> 4


def _ls_product2(a, b):
    return (a * b * 4 + (a + b) * 2 * LS_STEP + LS_STEP * LS_STEP * 2) >> 4


def _mult_shift_ndiag(px, idet, shift):
    v = px * idet
    c = WARPEDMODEL_NONDIAGAFFINE_CLAMP
    return max(-c + 1, min(c - 1, _round2s(v, shift)))


def _mult_shift_diag(px, idet, shift):
    v = px * idet
    c = WARPEDMODEL_NONDIAGAFFINE_CLAMP
    one = 1 << WARPEDMODEL_PREC_BITS
    return max(one - c + 1, min(one + c - 1, _round2s(v, shift)))


def find_projection(np_, pts1, pts2, bw, bh, mvy, mvx, mi_row, mi_col):
    """av1_find_projection: returns (ok, mat[6], alpha, beta, gamma, delta).
    pts in 1/8 pel relative to block top-left (pts1 source, pts2 in-ref)."""
    a00 = a01 = a11 = bx0 = bx1 = by0 = by1 = 0
    rsuy = bh // 2 - 1
    rsux = bw // 2 - 1
    suy = rsuy * 8
    sux = rsux * 8
    duy = suy + mvy
    dux = sux + mvx
    for i in range(np_):
        dx = pts2[2 * i] - dux
        dy = pts2[2 * i + 1] - duy
        sx = pts1[2 * i] - sux
        sy = pts1[2 * i + 1] - suy
        if abs(sx - dx) < LS_MV_MAX and abs(sy - dy) < LS_MV_MAX:
            a00 += _ls_square(sx)
            a01 += _ls_product1(sx, sy)
            a11 += _ls_square(sy)
            bx0 += _ls_product2(sx, dx)
            bx1 += _ls_product1(sy, dx)
            by0 += _ls_product1(sx, dy)
            by1 += _ls_product2(sy, dy)
    det = a00 * a11 - a01 * a01
    if det == 0:
        return False, None, 0, 0, 0, 0
    idet, shift = resolve_divisor_64(abs(det))
    if det < 0:
        idet = -idet
    shift -= WARPEDMODEL_PREC_BITS
    if shift < 0:
        idet <<= -shift
        shift = 0
    px0 = a11 * bx0 - a01 * bx1
    px1 = -a01 * bx0 + a00 * bx1
    py0 = a11 * by0 - a01 * by1
    py1 = -a01 * by0 + a00 * by1
    mat = [0] * 6
    mat[2] = _mult_shift_diag(px0, idet, shift)
    mat[3] = _mult_shift_ndiag(px1, idet, shift)
    mat[4] = _mult_shift_ndiag(py0, idet, shift)
    mat[5] = _mult_shift_diag(py1, idet, shift)
    isuy = mi_row * 4 + rsuy
    isux = mi_col * 4 + rsux
    one = 1 << WARPEDMODEL_PREC_BITS
    vx = mvx * (1 << (WARPEDMODEL_PREC_BITS - 3)) \
        - (isux * (mat[2] - one) + isuy * mat[3])
    vy = mvy * (1 << (WARPEDMODEL_PREC_BITS - 3)) \
        - (isux * mat[4] + isuy * (mat[5] - one))
    tc = WARPEDMODEL_TRANS_CLAMP
    mat[0] = max(-tc, min(tc - 1, vx))
    mat[1] = max(-tc, min(tc - 1, vy))
    ok, alpha, beta, gamma, delta = get_shear_params(mat)
    return ok, mat, alpha, beta, gamma, delta


def select_samples(mv_row, mv_col, pts, pts_inref, length, bw, bh):
    """av1_selectSamples: filter samples by MV difference; returns
    (n, pts, pts_inref) with arrays compacted in place."""
    thresh = max(16, min(112, max(bw, bh)))
    ret = 0
    for i in range(length):
        diff = abs(pts_inref[2 * i] - pts[2 * i] - mv_col) + \
            abs(pts_inref[2 * i + 1] - pts[2 * i + 1] - mv_row)
        if diff > thresh:
            continue
        if ret != i:
            pts[2 * ret:2 * ret + 2] = pts[2 * i:2 * i + 2]
            pts_inref[2 * ret:2 * ret + 2] = pts_inref[2 * i:2 * i + 2]
        ret += 1
    return max(ret, 1)


def warp_affine(mat, ref, pred, p_col, p_row, p_width, p_height, ss_x, ss_y,
                alpha, beta, gamma, delta, is_compound=False, bd=8):
    """av1_warp_affine_c / av1_highbd_warp_affine_c (round_0=3 growing
    with bd per the 16-bit im range rule; round_1=11 single-ref / 7
    compound).  ref: the (unpadded) reference plane; pred: output
    (p_height, p_width) pixel array (or int32 CONV_BUF when
    is_compound); p_col/p_row: block position in plane pixels."""
    height, width = ref.shape
    r32 = ref.astype(np.int32)
    filt = warp_filter()
    reduce_bits_horiz = 3 + max(bd + 7 - 3 - 14, 0)
    reduce_bits_vert = 7 if is_compound else 2 * 7 - reduce_bits_horiz
    offset_bits_horiz = bd + 7 - 1
    offset_bits_vert = bd + 2 * 7 - reduce_bits_horiz
    for i in range(p_row, p_row + p_height, 8):
        for j in range(p_col, p_col + p_width, 8):
            src_x = (j + 4) << ss_x
            src_y = (i + 4) << ss_y
            dst_x = mat[2] * src_x + mat[3] * src_y + mat[0]
            dst_y = mat[4] * src_x + mat[5] * src_y + mat[1]
            x4 = dst_x >> ss_x
            y4 = dst_y >> ss_y
            ix4 = x4 >> WARPEDMODEL_PREC_BITS
            sx4 = x4 & ((1 << WARPEDMODEL_PREC_BITS) - 1)
            iy4 = y4 >> WARPEDMODEL_PREC_BITS
            sy4 = y4 & ((1 << WARPEDMODEL_PREC_BITS) - 1)
            sx4 += alpha * (-4) + beta * (-4)
            sy4 += gamma * (-4) + delta * (-4)
            sx4 &= ~((1 << WARP_PARAM_REDUCE_BITS) - 1)
            sy4 &= ~((1 << WARP_PARAM_REDUCE_BITS) - 1)

            # horizontal pass -> tmp (15, 8)
            tmp = np.empty((15, 8), np.int32)
            ks = np.arange(-7, 8)
            iy = np.clip(iy4 + ks, 0, height - 1)
            ls = np.arange(-4, 4)
            sx = sx4 + beta * (ks[:, None] + 4) + alpha * (ls[None, :] + 4)
            offs = _round2(sx, WARPEDDIFF_PREC_BITS) + WARPEDPIXEL_PREC_SHIFTS
            coeffs = filt[offs]                     # (15, 8, 8taps)
            sample_x = np.clip(ix4 + ls[None, :, None] - 3
                               + np.arange(8)[None, None, :], 0, width - 1)
            samples = r32[iy[:, None, None], sample_x]   # (15, 8, 8)
            sums = (samples * coeffs).sum(-1) + (1 << offset_bits_horiz)
            tmp[:] = (sums + (1 << (reduce_bits_horiz - 1))) \
                >> reduce_bits_horiz

            # vertical pass
            kv = np.arange(-4, min(4, p_row + p_height - i - 4))
            lv = np.arange(-4, min(4, p_col + p_width - j - 4))
            sy = sy4 + delta * (kv[:, None] + 4) + gamma * (lv[None, :] + 4)
            offs = _round2(sy, WARPEDDIFF_PREC_BITS) + WARPEDPIXEL_PREC_SHIFTS
            coeffs = filt[offs]                     # (kh, kw, 8)
            rows = kv[:, None, None] + np.arange(8)[None, None, :] + 4
            cols = lv[None, :, None] + 4
            vals = tmp[rows, cols]
            sums = (vals * coeffs).sum(-1) + (1 << offset_bits_vert)
            res = (sums + (1 << (reduce_bits_vert - 1))) >> reduce_bits_vert
            oy = i - p_row + 4 + kv[0]
            ox = j - p_col + 4 + lv[0]
            if is_compound:
                pred[oy:oy + len(kv), ox:ox + len(lv)] = res
            else:
                sub = ((1 << (offset_bits_vert - reduce_bits_vert))
                       + (1 << (offset_bits_vert - reduce_bits_vert - 1)))
                out = np.clip(res - sub, 0, (1 << bd) - 1)
                pred[oy:oy + len(kv), ox:ox + len(lv)] = \
                    out.astype(pred.dtype)
