"""Inter prediction: subpel interpolation filters + motion compensation.

Normative behavior: av1/common/convolve.c (av1_convolve_2d_sr_c:76,
av1_convolve_x_sr_c:156, av1_convolve_y_sr_c:135, copy path), filter
kernels av1/common/filter.h:111-232, MV clamping
av1/common/reconinter.h:341 clamp_mv_to_umv_border_sb.

Single-reference ("sr") paths use round_0=3, round_1=11, compound 7
(av1/common/convolve.h av1_get_conv_params_no_round); for 12-bit round_0
grows by 2 and round_1 shrinks to keep the 16-bit im buffer in range.
8/10/12-bit handled via the `bd` parameter (av1_highbd_convolve_2d_sr_c
convolve.c:735 semantics; identical shifts for 8- and 10-bit).  Reference-frame
borders are handled by replicate-padding the ref planes (PAD pixels),
mirroring aom_extend_frame_borders + extend_mc_border.

Vectorized with numpy over whole blocks (host decode path); the batched
TPU analogue lives in ops/.
"""

from __future__ import annotations

import numpy as np

from ..bitstream import constants as c

FILTER_BITS = 7
SUBPEL_BITS = 4          # q4: 1/16-pel within a plane
SUBPEL_MASK = 15
ROUND0 = 3
ROUND1 = 11


def conv_rounds(bd: int, is_compound: bool = False):
    """(round_0, round_1) per av1_get_conv_params_no_round."""
    r0 = ROUND0
    r1 = 7 if is_compound else 2 * FILTER_BITS - r0
    extra = max(0, (bd + FILTER_BITS - r0 + 2) - 16)
    r0 += extra
    if not is_compound:
        r1 -= extra
    return r0, r1


def pix_dtype(bd: int):
    return np.uint8 if bd == 8 else np.uint16
AOM_INTERP_EXTEND = 4
PAD = 160                # replicated ref border (>= 128-wide block + taps)

# normative subpel kernels (av1/common/filter.h)
BILINEAR_FILTERS = np.array([
    [0, 0, 0, 128, 0, 0, 0, 0], [0, 0, 0, 120, 8, 0, 0, 0],
    [0, 0, 0, 112, 16, 0, 0, 0], [0, 0, 0, 104, 24, 0, 0, 0],
    [0, 0, 0, 96, 32, 0, 0, 0], [0, 0, 0, 88, 40, 0, 0, 0],
    [0, 0, 0, 80, 48, 0, 0, 0], [0, 0, 0, 72, 56, 0, 0, 0],
    [0, 0, 0, 64, 64, 0, 0, 0], [0, 0, 0, 56, 72, 0, 0, 0],
    [0, 0, 0, 48, 80, 0, 0, 0], [0, 0, 0, 40, 88, 0, 0, 0],
    [0, 0, 0, 32, 96, 0, 0, 0], [0, 0, 0, 24, 104, 0, 0, 0],
    [0, 0, 0, 16, 112, 0, 0, 0], [0, 0, 0, 8, 120, 0, 0, 0]], np.int32)

SUBPEL_FILTERS_8 = np.array([
    [0, 0, 0, 128, 0, 0, 0, 0], [0, 2, -6, 126, 8, -2, 0, 0],
    [0, 2, -10, 122, 18, -4, 0, 0], [0, 2, -12, 116, 28, -8, 2, 0],
    [0, 2, -14, 110, 38, -10, 2, 0], [0, 2, -14, 102, 48, -12, 2, 0],
    [0, 2, -16, 94, 58, -12, 2, 0], [0, 2, -14, 84, 66, -12, 2, 0],
    [0, 2, -14, 76, 76, -14, 2, 0], [0, 2, -12, 66, 84, -14, 2, 0],
    [0, 2, -12, 58, 94, -16, 2, 0], [0, 2, -12, 48, 102, -14, 2, 0],
    [0, 2, -10, 38, 110, -14, 2, 0], [0, 2, -8, 28, 116, -12, 2, 0],
    [0, 0, -4, 18, 122, -10, 2, 0], [0, 0, -2, 8, 126, -6, 2, 0]], np.int32)

SUBPEL_FILTERS_8SHARP = np.array([
    [0, 0, 0, 128, 0, 0, 0, 0], [-2, 2, -6, 126, 8, -2, 2, 0],
    [-2, 6, -12, 124, 16, -6, 4, -2], [-2, 8, -18, 120, 26, -10, 6, -2],
    [-4, 10, -22, 116, 38, -14, 6, -2], [-4, 10, -22, 108, 48, -18, 8, -2],
    [-4, 10, -24, 100, 60, -20, 8, -2], [-4, 10, -24, 90, 70, -22, 10, -2],
    [-4, 12, -24, 80, 80, -24, 12, -4], [-2, 10, -22, 70, 90, -24, 10, -4],
    [-2, 8, -20, 60, 100, -24, 10, -4], [-2, 8, -18, 48, 108, -22, 10, -4],
    [-2, 6, -14, 38, 116, -22, 10, -4], [-2, 6, -10, 26, 120, -18, 8, -2],
    [-2, 4, -6, 16, 124, -12, 6, -2], [0, 2, -2, 8, 126, -6, 2, -2]],
    np.int32)

SUBPEL_FILTERS_8SMOOTH = np.array([
    [0, 0, 0, 128, 0, 0, 0, 0], [0, 2, 28, 62, 34, 2, 0, 0],
    [0, 0, 26, 62, 36, 4, 0, 0], [0, 0, 22, 62, 40, 4, 0, 0],
    [0, 0, 20, 60, 42, 6, 0, 0], [0, 0, 18, 58, 44, 8, 0, 0],
    [0, 0, 16, 56, 46, 10, 0, 0], [0, -2, 16, 54, 48, 12, 0, 0],
    [0, -2, 14, 52, 52, 14, -2, 0], [0, 0, 12, 48, 54, 16, -2, 0],
    [0, 0, 10, 46, 56, 16, 0, 0], [0, 0, 8, 44, 58, 18, 0, 0],
    [0, 0, 6, 42, 60, 20, 0, 0], [0, 0, 4, 40, 62, 22, 0, 0],
    [0, 0, 4, 36, 62, 26, 0, 0], [0, 0, 2, 34, 62, 28, 2, 0]], np.int32)

SUBPEL_FILTERS_4 = np.array([
    [0, 0, 0, 128, 0, 0, 0, 0], [0, 0, -4, 126, 8, -2, 0, 0],
    [0, 0, -8, 122, 18, -4, 0, 0], [0, 0, -10, 116, 28, -6, 0, 0],
    [0, 0, -12, 110, 38, -8, 0, 0], [0, 0, -12, 102, 48, -10, 0, 0],
    [0, 0, -14, 94, 58, -10, 0, 0], [0, 0, -12, 84, 66, -10, 0, 0],
    [0, 0, -12, 76, 76, -12, 0, 0], [0, 0, -10, 66, 84, -12, 0, 0],
    [0, 0, -10, 58, 94, -14, 0, 0], [0, 0, -10, 48, 102, -12, 0, 0],
    [0, 0, -8, 38, 110, -12, 0, 0], [0, 0, -6, 28, 116, -10, 0, 0],
    [0, 0, -4, 18, 122, -8, 0, 0], [0, 0, -2, 8, 126, -4, 0, 0]], np.int32)

SUBPEL_FILTERS_4SMOOTH = np.array([
    [0, 0, 0, 128, 0, 0, 0, 0], [0, 0, 30, 62, 34, 2, 0, 0],
    [0, 0, 26, 62, 36, 4, 0, 0], [0, 0, 22, 62, 40, 4, 0, 0],
    [0, 0, 20, 60, 42, 6, 0, 0], [0, 0, 18, 58, 44, 8, 0, 0],
    [0, 0, 16, 56, 46, 10, 0, 0], [0, 0, 14, 54, 48, 12, 0, 0],
    [0, 0, 12, 52, 52, 12, 0, 0], [0, 0, 12, 48, 54, 14, 0, 0],
    [0, 0, 10, 46, 56, 16, 0, 0], [0, 0, 8, 44, 58, 18, 0, 0],
    [0, 0, 6, 42, 60, 20, 0, 0], [0, 0, 4, 40, 62, 22, 0, 0],
    [0, 0, 4, 36, 62, 26, 0, 0], [0, 0, 2, 34, 62, 30, 0, 0]], np.int32)


def filter_kernels(interp_filter: int, block_w: int) -> np.ndarray:
    """16x8 kernel table for a filter type and prediction block width
    (av1/common/filter.h get_interp_filter_params_with_block_size:
    w<=4 uses the 4-tap variants; SHARP falls back to regular there)."""
    if interp_filter == c.BILINEAR:
        return BILINEAR_FILTERS
    if block_w <= 4:
        if interp_filter == c.EIGHTTAP_SMOOTH:
            return SUBPEL_FILTERS_4SMOOTH
        return SUBPEL_FILTERS_4
    return (SUBPEL_FILTERS_8, SUBPEL_FILTERS_8SMOOTH,
            SUBPEL_FILTERS_8SHARP)[interp_filter]


def _round2(x: np.ndarray, n: int) -> np.ndarray:
    return (x + (1 << (n - 1))) >> n


def _conv_axis(region: np.ndarray, kern: np.ndarray, axis: int) -> np.ndarray:
    """Correlate along axis with an 8-tap kernel; output loses 7 samples."""
    n = region.shape[axis] - 7
    acc = np.zeros((region.shape[0] - (7 if axis == 0 else 0),
                    region.shape[1] - (7 if axis == 1 else 0)), np.int32)
    for k in range(8):
        if kern[k] == 0:
            continue
        if axis == 1:
            acc += kern[k] * region[:, k:k + n]
        else:
            acc += kern[k] * region[k:k + n, :]
    return acc


def convolve_sr(region: np.ndarray, subx: int, suby: int,
                kern_x: np.ndarray, kern_y: np.ndarray,
                bd: int = 8) -> np.ndarray:
    """Single-ref convolution of a (bh+7, bw+7) int32 region whose
    fullpel anchor is at [3,3]; returns pixels (bh, bw)."""
    bh, bw = region.shape[0] - 7, region.shape[1] - 7
    maxv = (1 << bd) - 1
    dtype = pix_dtype(bd)
    r0, r1 = conv_rounds(bd)
    if subx == 0 and suby == 0:
        return region[3:3 + bh, 3:3 + bw].astype(dtype)
    if suby == 0:  # av1_convolve_x_sr_c
        res = _round2(_conv_axis(region[3:3 + bh, :], kern_x[subx], 1), r0)
        return np.clip(_round2(res, FILTER_BITS - r0), 0,
                       maxv).astype(dtype)
    if subx == 0:  # av1_convolve_y_sr_c
        res = _conv_axis(region[:, 3:3 + bw], kern_y[suby], 0)
        return np.clip(_round2(res, FILTER_BITS), 0, maxv).astype(dtype)
    # av1_convolve_2d_sr_c
    im = _round2(_conv_axis(region, kern_x[subx], 1)
                 + (1 << (bd + FILTER_BITS - 1)), r0)
    im = im.astype(np.int16).astype(np.int32)
    sum_ = _conv_axis(im, kern_y[suby], 0) + (1 << (bd + 14 - r0))
    res = _round2(sum_, r1) - ((1 << bd) + (1 << (bd - 1)))
    return np.clip(res, 0, maxv).astype(dtype)


def convolve_compound(region: np.ndarray, subx: int, suby: int,
                      kern_x: np.ndarray, kern_y: np.ndarray,
                      bd: int = 8) -> np.ndarray:
    """Compound (CONV_BUF) convolution: round_0=3, round_1=7
    (av1_dist_wtd_convolve_2d_c; the unified 2d path is bit-exact for all
    phases including zero, same as the single-ref case).  Returns int32."""
    bh, bw = region.shape[0] - 7, region.shape[1] - 7
    r0, _ = conv_rounds(bd, is_compound=True)
    im = _round2(_conv_axis(region, kern_x[subx], 1)
                 + (1 << (bd + FILTER_BITS - 1)), r0)
    im = im.astype(np.int16).astype(np.int32)
    sum_ = _conv_axis(im, kern_y[suby], 0) + (1 << (bd + 14 - r0))
    return _round2(sum_, 7)


def compound_average(buf0: np.ndarray, buf1: np.ndarray,
                     use_dist_wtd: bool = False, fwd_offset: int = 8,
                     bck_offset: int = 8, bd: int = 8) -> np.ndarray:
    """Combine the two CONV buffers (do_average path)."""
    if use_dist_wtd:
        tmp = (buf0 * fwd_offset + buf1 * bck_offset) >> 4
    else:
        tmp = (buf0 + buf1) >> 1
    r0, r1 = conv_rounds(bd, is_compound=True)
    offset_bits = bd + 2 * FILTER_BITS - r0
    tmp = tmp - ((1 << (offset_bits - r1)) + (1 << (offset_bits - r1 - 1)))
    return np.clip(_round2(tmp, 2 * FILTER_BITS - r0 - r1), 0,
                   (1 << bd) - 1).astype(pix_dtype(bd))


def compound_conv_bufs(ref_pads, x0, y0, bw, bh, mvs, ss_x, ss_y,
                       mb_to_left, mb_to_right, mb_to_top, mb_to_bottom,
                       filt_x, filt_y, warp_specs=None, bd=8):
    """CONV-domain prediction buffers for both references.  warp_specs:
    optional per-ref (mat, shear, unpadded_plane) to produce a buffer by
    affine warp (global motion) instead of translation+convolve."""
    bufs = []
    kx = filter_kernels(filt_x, bw)
    ky = filter_kernels(filt_y, bh)
    for ref in range(2):
        if warp_specs is not None and warp_specs[ref] is not None:
            from . import warp as WP
            mat, shear, plane_ref = warp_specs[ref]
            buf = np.empty((bh, bw), np.int32)
            WP.warp_affine(mat, plane_ref, buf, x0, y0, bw, bh, ss_x,
                           ss_y, *shear, is_compound=True, bd=bd)
            bufs.append(buf)
            continue
        row_q4, col_q4 = clamp_mv_to_umv_border(
            mvs[ref][0], mvs[ref][1], bw, bh, ss_x, ss_y, mb_to_left,
            mb_to_right, mb_to_top, mb_to_bottom)
        pos_x = (x0 << SUBPEL_BITS) + col_q4
        pos_y = (y0 << SUBPEL_BITS) + row_q4
        fx = pos_x >> SUBPEL_BITS
        fy = pos_y >> SUBPEL_BITS
        region = ref_pads[ref][PAD + fy - 3:PAD + fy + bh + 4,
                              PAD + fx - 3:PAD + fx + bw + 4] \
            .astype(np.int32)
        bufs.append(convolve_compound(region, pos_x & SUBPEL_MASK,
                                      pos_y & SUBPEL_MASK, kx, ky, bd))
    return bufs


def predict_inter_compound(ref_pads, x0, y0, bw, bh, mvs, ss_x, ss_y,
                           mb_to_left, mb_to_right, mb_to_top, mb_to_bottom,
                           filt_x, filt_y, use_dist_wtd=False, fwd_offset=8,
                           bck_offset=8, bd=8) -> np.ndarray:
    """Two-reference average prediction (COMPOUND_AVERAGE / DISTWTD)."""
    bufs = []
    kx = filter_kernels(filt_x, bw)
    ky = filter_kernels(filt_y, bh)
    for ref in range(2):
        row_q4, col_q4 = clamp_mv_to_umv_border(
            mvs[ref][0], mvs[ref][1], bw, bh, ss_x, ss_y, mb_to_left,
            mb_to_right, mb_to_top, mb_to_bottom)
        pos_x = (x0 << SUBPEL_BITS) + col_q4
        pos_y = (y0 << SUBPEL_BITS) + row_q4
        fx = pos_x >> SUBPEL_BITS
        fy = pos_y >> SUBPEL_BITS
        region = ref_pads[ref][PAD + fy - 3:PAD + fy + bh + 4,
                              PAD + fx - 3:PAD + fx + bw + 4] \
            .astype(np.int32)
        bufs.append(convolve_compound(region, pos_x & SUBPEL_MASK,
                                      pos_y & SUBPEL_MASK, kx, ky, bd))
    return compound_average(bufs[0], bufs[1], use_dist_wtd, fwd_offset,
                            bck_offset, bd)


_WEDGE_MASKS = None


def wedge_mask(bsize: int, sign: int, idx: int) -> np.ndarray:
    """Normative wedge mask (luma resolution) for a block size
    (reconinter.c av1_wedge_params_lookup; loaded from
    data/wedge_masks.npz)."""
    global _WEDGE_MASKS
    if _WEDGE_MASKS is None:
        import os
        _WEDGE_MASKS = np.load(os.path.join(
            os.path.dirname(__file__), "..", "..", "data",
            "wedge_masks.npz"))
    return _WEDGE_MASKS[f"wedge_{bsize}"][sign, idx]


def diffwtd_mask_d16(buf0: np.ndarray, buf1: np.ndarray,
                     inverse: bool, bd: int = 8) -> np.ndarray:
    """av1_build_compound_diffwtd_mask_d16 (reconinter.c:296)."""
    r0, r1 = conv_rounds(bd, is_compound=True)
    diff = _round2(np.abs(buf0 - buf1),
                   2 * FILTER_BITS - r0 - r1 + (bd - 8))
    m = np.clip(38 + diff // 16, 0, 64).astype(np.uint8)
    return (64 - m).astype(np.uint8) if inverse else m


def blend_a64_d16(buf0: np.ndarray, buf1: np.ndarray, mask: np.ndarray,
                  ss_x: int, ss_y: int, bd: int = 8) -> np.ndarray:
    """aom_lowbd/highbd_blend_a64_d16_mask (blend_a64_mask.c:36); mask at
    luma resolution, bufs at plane resolution."""
    if ss_x and ss_y:
        m = _round2(mask[0::2, 0::2].astype(np.int32)
                    + mask[1::2, 0::2] + mask[0::2, 1::2]
                    + mask[1::2, 1::2], 2)
    elif ss_x:
        m = _round2(mask[:, 0::2].astype(np.int32) + mask[:, 1::2], 1)
    elif ss_y:
        m = _round2(mask[0::2, :].astype(np.int32) + mask[1::2, :], 1)
    else:
        m = mask.astype(np.int32)
    m = m[:buf0.shape[0], :buf0.shape[1]]
    res = (m * buf0 + (64 - m) * buf1) >> 6
    r0, r1 = conv_rounds(bd, is_compound=True)
    offset_bits = bd + 2 * FILTER_BITS - r0
    res = res - ((1 << (offset_bits - r1)) + (1 << (offset_bits - r1 - 1)))
    return np.clip(_round2(res, 2 * FILTER_BITS - r0 - r1), 0,
                   (1 << bd) - 1).astype(pix_dtype(bd))


def pad_ref_plane(plane: np.ndarray) -> np.ndarray:
    """Replicate-extend a reference plane by PAD on all sides
    (aom_extend_frame_borders semantics)."""
    return np.pad(plane, PAD, mode="edge")


def clamp_mv_to_umv_border(mv_row: int, mv_col: int, bw: int, bh: int,
                           ss_x: int, ss_y: int, mb_to_left: int,
                           mb_to_right: int, mb_to_top: int,
                           mb_to_bottom: int) -> tuple[int, int]:
    """reconinter.h:341; mb_to_* edges in full luma pels; returns q4 mv in
    plane units."""
    spel_left = (AOM_INTERP_EXTEND + bw) << SUBPEL_BITS
    spel_right = spel_left - (1 << SUBPEL_BITS)
    spel_top = (AOM_INTERP_EXTEND + bh) << SUBPEL_BITS
    spel_bottom = spel_top - (1 << SUBPEL_BITS)
    row = mv_row * (1 << (1 - ss_y))
    col = mv_col * (1 << (1 - ss_x))
    # edges are in luma pels; convert to q4 (1/16) plane units: luma pel
    # = 8 eighth-pels -> *8 gives 1/8 luma = q4 chroma when ss=1
    lo_c = mb_to_left * 8 * (1 << (1 - ss_x)) - spel_left
    hi_c = mb_to_right * 8 * (1 << (1 - ss_x)) + spel_right
    lo_r = mb_to_top * 8 * (1 << (1 - ss_y)) - spel_top
    hi_r = mb_to_bottom * 8 * (1 << (1 - ss_y)) + spel_bottom
    return (min(max(row, lo_r), hi_r), min(max(col, lo_c), hi_c))


def predict_inter_block(ref_pad: np.ndarray, x0: int, y0: int, bw: int,
                        bh: int, mv_row: int, mv_col: int, ss_x: int,
                        ss_y: int, mb_to_left: int, mb_to_right: int,
                        mb_to_top: int, mb_to_bottom: int,
                        filt_x: int, filt_y: int, bd: int = 8) -> np.ndarray:
    """Motion-compensate one block. ref_pad is the PAD-extended ref plane;
    (x0, y0) is the block origin in (unpadded) plane pixels; mv in 1/8 luma
    pel. Returns pixels (bh, bw)."""
    row_q4, col_q4 = clamp_mv_to_umv_border(
        mv_row, mv_col, bw, bh, ss_x, ss_y, mb_to_left, mb_to_right,
        mb_to_top, mb_to_bottom)
    pos_x = (x0 << SUBPEL_BITS) + col_q4
    pos_y = (y0 << SUBPEL_BITS) + row_q4
    fx = pos_x >> SUBPEL_BITS
    fy = pos_y >> SUBPEL_BITS
    subx = pos_x & SUBPEL_MASK
    suby = pos_y & SUBPEL_MASK
    region = ref_pad[PAD + fy - 3:PAD + fy + bh + 4,
                     PAD + fx - 3:PAD + fx + bw + 4].astype(np.int32)
    kx = filter_kernels(filt_x, bw)
    ky = filter_kernels(filt_y, bh)
    return convolve_sr(region, subx, suby, kx, ky, bd)


# ---------------------------------------------------------------------------
# Interintra (reconinter.c:516-1170; spec 7.11.3.13 II_Weights_1d)

II_WEIGHTS_1D = (
    60, 58, 56, 54, 52, 50, 48, 47, 45, 44, 42, 41, 39, 38, 37, 35, 34, 33,
    32, 31, 30, 29, 28, 27, 26, 25, 24, 23, 22, 22, 21, 20, 19, 19, 18, 18,
    17, 16, 16, 15, 15, 14, 14, 13, 13, 12, 12, 12, 11, 11, 10, 10, 10, 9,
    9, 9, 8, 8, 8, 8, 7, 7, 7, 7, 6, 6, 6, 6, 6, 5, 5, 5, 5, 5, 4, 4, 4, 4,
    4, 4, 4, 4, 3, 3, 3, 3, 3, 3, 3, 3, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
    2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1)

II_SIZE_SCALES = (32, 16, 16, 16, 8, 8, 8, 4, 4, 4, 2, 2, 2, 1, 1, 1,
                  8, 8, 4, 4, 2, 2)


def smooth_interintra_mask(plane_bsize: int, ii_mode: int) -> np.ndarray:
    """build_smooth_interintra_mask (reconinter.c:532)."""
    from . import blockd
    bw = blockd.block_wide(plane_bsize)
    bh = blockd.block_high(plane_bsize)
    scale = II_SIZE_SCALES[plane_bsize]
    w = np.asarray(II_WEIGHTS_1D, np.uint8)
    if ii_mode == 1:        # II_V_PRED
        return np.repeat(w[np.arange(bh) * scale][:, None], bw, axis=1)
    if ii_mode == 2:        # II_H_PRED
        return np.repeat(w[np.arange(bw) * scale][None, :], bh, axis=0)
    if ii_mode == 3:        # II_SMOOTH_PRED
        idx = np.minimum(np.arange(bh)[:, None], np.arange(bw)[None, :])
        return w[idx * scale]
    return np.full((bh, bw), 32, np.uint8)  # II_DC_PRED


def blend_a64_mask_pixel(intra, inter, mask, subw, subh):
    """aom_blend_a64_mask_c (pixel domain): mask may be at 2x resolution
    when subw/subh (chroma planes of a luma-resolution wedge mask)."""
    m = mask.astype(np.int32)
    if subh and subw:
        m = (m[::2, ::2] + m[::2, 1::2] + m[1::2, ::2] + m[1::2, 1::2]
             + 2) >> 2
    elif subw:
        m = (m[:, ::2] + m[:, 1::2] + 1) >> 1
    elif subh:
        m = (m[::2, :] + m[1::2, :] + 1) >> 1
    bh, bw = inter.shape
    m = m[:bh, :bw]
    out = (m * intra.astype(np.int32)
           + (64 - m) * inter.astype(np.int32) + 32) >> 6
    return out.astype(inter.dtype)


# ---------------------------------------------------------------------------
# Scaled-reference prediction (superres / resized refs)
# av1/common/convolve.c:395 av1_convolve_2d_scale_c (+ highbd variant),
# av1/common/scale.c av1_setup_scale_factors_for_frame,
# av1/decoder/decodeframe.c:546 dec_calc_subpel_params (is_scaled branch).

REF_SCALE_SHIFT = 14
REF_NO_SCALE = 1 << REF_SCALE_SHIFT
SCALE_SUBPEL_BITS = 10
SCALE_SUBPEL_MASK = (1 << SCALE_SUBPEL_BITS) - 1
SCALE_EXTRA_BITS = SCALE_SUBPEL_BITS - SUBPEL_BITS
SCALE_EXTRA_OFF = 1 << (SCALE_EXTRA_BITS - 1)


def scale_factors(ref_w, ref_h, cur_w, cur_h):
    """(x_scale_fp, y_scale_fp, x_step_qn, y_step_qn); fp is q14, step is
    the per-output-pixel q10 source advance."""
    xfp = ((ref_w << REF_SCALE_SHIFT) + cur_w // 2) // cur_w
    yfp = ((ref_h << REF_SCALE_SHIFT) + cur_h // 2) // cur_h
    rnd = 1 << (REF_SCALE_SHIFT - SCALE_SUBPEL_BITS - 1)
    return (xfp, yfp, (xfp + rnd) >> (REF_SCALE_SHIFT - SCALE_SUBPEL_BITS),
            (yfp + rnd) >> (REF_SCALE_SHIFT - SCALE_SUBPEL_BITS))


def is_scaled(sf) -> bool:
    return sf[0] != REF_NO_SCALE or sf[1] != REF_NO_SCALE


def scaled_pos(val_q4: int, scale_fp: int) -> int:
    """av1_scaled_x/_y: q4 position -> q10 source position (pre-offset).
    ROUND_POWER_OF_TWO_SIGNED_64 rounds the magnitude for negatives."""
    off = (scale_fp - REF_NO_SCALE) * (1 << (SUBPEL_BITS - 1))
    tval = val_q4 * scale_fp + off
    sh = REF_SCALE_SHIFT - SCALE_EXTRA_BITS
    add = 1 << (sh - 1)
    if tval >= 0:
        return (tval + add) >> sh
    return -((-tval + add) >> sh)


def _scale_block_pos(x0, y0, mv_row, mv_col, ss_x, ss_y, sf, ref_w, ref_h,
                     margin=PAD - 16):
    """dec_calc_subpel_params scaled branch: returns q10 (pos_x, pos_y)
    of output pixel (0,0) in the ref plane, offset+clamped.  The clamp
    margin differs from the reference's (288-px border) but all clamped
    positions land in replicate-extended border, so pixels match."""
    orig_x = (x0 << SUBPEL_BITS) + mv_col * (1 << (1 - ss_x))
    orig_y = (y0 << SUBPEL_BITS) + mv_row * (1 << (1 - ss_y))
    pos_x = scaled_pos(orig_x, sf[0]) + SCALE_EXTRA_OFF
    pos_y = scaled_pos(orig_y, sf[1]) + SCALE_EXTRA_OFF
    top = -(margin >> ss_y) << SCALE_SUBPEL_BITS
    left = -(margin >> ss_x) << SCALE_SUBPEL_BITS
    bottom = (ref_h + AOM_INTERP_EXTEND) << SCALE_SUBPEL_BITS
    right = (ref_w + AOM_INTERP_EXTEND) << SCALE_SUBPEL_BITS
    return (min(max(pos_x, left), right), min(max(pos_y, top), bottom))


def convolve_scale(ref_pad, pos_x, pos_y, xs, ys, bw, bh, kern_x, kern_y,
                   bd=8, is_compound=False):
    """av1_convolve_2d_scale_c on a PAD-extended ref plane.

    pos_x/pos_y: q10 position of output (0,0) (from _scale_block_pos);
    xs/ys: q10 steps.  Returns pixels (bh, bw), or the int32 CONV_BUF
    when is_compound."""
    r0, r1 = conv_rounds(bd, is_compound)
    subx = pos_x & SCALE_SUBPEL_MASK
    suby = pos_y & SCALE_SUBPEL_MASK
    bx = (pos_x >> SCALE_SUBPEL_BITS) + PAD
    by = (pos_y >> SCALE_SUBPEL_BITS) + PAD
    im_h = (((bh - 1) * ys + suby) >> SCALE_SUBPEL_BITS) + 8
    # horizontal pass: rows by-3 .. by-3+im_h
    x_qn = subx + xs * np.arange(bw, dtype=np.int64)
    ix = (x_qn >> SCALE_SUBPEL_BITS).astype(np.int64)
    xph = ((x_qn & SCALE_SUBPEL_MASK) >> SCALE_EXTRA_BITS).astype(np.int64)
    rows = ref_pad[by - 3:by - 3 + im_h].astype(np.int32)
    idx = bx + ix[:, None] + np.arange(8)[None, :] - 3   # (bw, 8)
    samples = rows[:, idx]                               # (im_h, bw, 8)
    coef_x = kern_x[xph]                                 # (bw, 8)
    hsum = (samples * coef_x[None]).sum(-1) \
        + (1 << (bd + FILTER_BITS - 1))
    im = _round2(hsum, r0).astype(np.int16).astype(np.int32)  # (im_h, bw)
    # vertical pass
    y_qn = suby + ys * np.arange(bh, dtype=np.int64)
    iy = (y_qn >> SCALE_SUBPEL_BITS).astype(np.int64)
    yph = ((y_qn & SCALE_SUBPEL_MASK) >> SCALE_EXTRA_BITS).astype(np.int64)
    ridx = iy[:, None] + np.arange(8)[None, :]           # (bh, 8)
    vsamp = im[ridx]                                     # (bh, 8, bw)
    coef_y = kern_y[yph]                                 # (bh, 8)
    offset_bits = bd + 2 * FILTER_BITS - r0
    vsum = (vsamp * coef_y[:, :, None]).sum(1) + (1 << offset_bits)
    res = _round2(vsum, r1)
    if is_compound:
        return res
    bits = 2 * FILTER_BITS - r0 - r1
    tmp = res - ((1 << (offset_bits - r1)) + (1 << (offset_bits - r1 - 1)))
    return np.clip(_round2(tmp, bits) if bits > 0 else tmp, 0,
                   (1 << bd) - 1).astype(pix_dtype(bd))


def predict_inter_block_scaled(ref_pad, ref_w, ref_h, x0, y0, bw, bh,
                               mv_row, mv_col, ss_x, ss_y, sf,
                               filt_x, filt_y, bd=8, is_compound=False):
    """Scaled-reference motion compensation for one block."""
    pos_x, pos_y = _scale_block_pos(x0, y0, mv_row, mv_col, ss_x, ss_y,
                                    sf, ref_w, ref_h)
    kx = filter_kernels(filt_x, bw)
    ky = filter_kernels(filt_y, bh)
    return convolve_scale(ref_pad, pos_x, pos_y, sf[2], sf[3], bw, bh,
                          kx, ky, bd, is_compound)
