"""AV1 intra prediction — bit-exact host reference (numpy, 8/10/12-bit).

Implements the normative prediction process of AV1 spec §7.11.2 (reference
behavior: av1/common/reconintra.c:1309 build_intra_predictors,
aom_dsp/intrapred.c base predictors, av1/common/cfl.c).  This is the
correctness oracle; the encoder's batched JAX/Pallas predictors are
cross-checked against it.
"""

from __future__ import annotations

import numpy as np

from ..bitstream import constants as c

MAX_UPSAMPLE_SZ = 16

# mode -> base angle (blockd.h:1145)
MODE_TO_ANGLE = {
    c.V_PRED: 90, c.H_PRED: 180, c.D45_PRED: 45, c.D135_PRED: 135,
    c.D113_PRED: 113, c.D157_PRED: 157, c.D203_PRED: 203, c.D67_PRED: 67,
}
ANGLE_STEP = 3

# dr_intra_derivative (reconintra.h:84): nonzero every 3 degrees
_DR_INTRA_DERIVATIVE = {
    3: 1023, 6: 547, 9: 372, 14: 273, 17: 215, 20: 178, 23: 151, 26: 132,
    29: 116, 32: 102, 36: 90, 39: 80, 42: 71, 45: 64, 48: 57, 51: 51,
    54: 45, 58: 40, 61: 35, 64: 31, 67: 27, 70: 23, 73: 19, 76: 15,
    81: 11, 84: 7, 87: 3,
}

# smooth_weights (aom_dsp/intrapred_common.h:25), indexed by block dim
SMOOTH_WEIGHTS = {
    4: [255, 149, 85, 64],
    8: [255, 197, 146, 105, 73, 50, 37, 32],
    16: [255, 225, 196, 170, 145, 123, 102, 84, 68, 54, 43, 33, 26, 20, 17,
         16],
    32: [255, 240, 225, 210, 196, 182, 169, 157, 145, 133, 122, 111, 101, 92,
         83, 74, 66, 59, 52, 45, 39, 34, 29, 25, 21, 17, 14, 12, 10, 9, 8, 8],
    64: [255, 248, 240, 233, 225, 218, 210, 203, 196, 189, 182, 176, 169, 163,
         156, 150, 144, 138, 133, 127, 121, 116, 111, 106, 101, 96, 91, 86,
         82, 77, 73, 69, 65, 61, 57, 54, 50, 47, 44, 41, 38, 35, 32, 29, 27,
         25, 22, 20, 18, 16, 15, 13, 12, 10, 9, 8, 7, 6, 6, 5, 5, 4, 4, 4],
}

# filter-intra taps (reconintra.c:794)
FILTER_INTRA_TAPS = np.array([
    [[-6, 10, 0, 0, 0, 12, 0, 0], [-5, 2, 10, 0, 0, 9, 0, 0],
     [-3, 1, 1, 10, 0, 7, 0, 0], [-3, 1, 1, 2, 10, 5, 0, 0],
     [-4, 6, 0, 0, 0, 2, 12, 0], [-3, 2, 6, 0, 0, 2, 9, 0],
     [-3, 2, 2, 6, 0, 2, 7, 0], [-3, 1, 2, 2, 6, 3, 5, 0]],
    [[-10, 16, 0, 0, 0, 10, 0, 0], [-6, 0, 16, 0, 0, 6, 0, 0],
     [-4, 0, 0, 16, 0, 4, 0, 0], [-2, 0, 0, 0, 16, 2, 0, 0],
     [-10, 16, 0, 0, 0, 0, 10, 0], [-6, 0, 16, 0, 0, 0, 6, 0],
     [-4, 0, 0, 16, 0, 0, 4, 0], [-2, 0, 0, 0, 16, 0, 2, 0]],
    [[-8, 8, 0, 0, 0, 16, 0, 0], [-8, 0, 8, 0, 0, 16, 0, 0],
     [-8, 0, 0, 8, 0, 16, 0, 0], [-8, 0, 0, 0, 8, 16, 0, 0],
     [-4, 4, 0, 0, 0, 0, 16, 0], [-4, 0, 4, 0, 0, 0, 16, 0],
     [-4, 0, 0, 4, 0, 0, 16, 0], [-4, 0, 0, 0, 4, 0, 16, 0]],
    [[-2, 8, 0, 0, 0, 10, 0, 0], [-1, 3, 8, 0, 0, 6, 0, 0],
     [-1, 2, 3, 8, 0, 4, 0, 0], [0, 1, 2, 3, 8, 2, 0, 0],
     [-1, 4, 0, 0, 0, 3, 10, 0], [-1, 3, 4, 0, 0, 4, 6, 0],
     [-1, 2, 3, 4, 0, 4, 4, 0], [-1, 2, 2, 3, 4, 3, 3, 0]],
    [[-12, 14, 0, 0, 0, 14, 0, 0], [-10, 0, 14, 0, 0, 12, 0, 0],
     [-9, 0, 0, 14, 0, 11, 0, 0], [-8, 0, 0, 0, 14, 10, 0, 0],
     [-10, 12, 0, 0, 0, 0, 14, 0], [-9, 1, 12, 0, 0, 0, 12, 0],
     [-8, 0, 0, 12, 0, 1, 11, 0], [-7, 0, 0, 1, 12, 1, 9, 0]],
], dtype=np.int32)


def is_directional(mode: int) -> bool:
    return c.V_PRED <= mode <= c.D67_PRED


def get_dx(angle: int) -> int:
    if 0 < angle < 90:
        return _DR_INTRA_DERIVATIVE[angle]
    if 90 < angle < 180:
        return _DR_INTRA_DERIVATIVE[180 - angle]
    return 1


def get_dy(angle: int) -> int:
    if 90 < angle < 180:
        return _DR_INTRA_DERIVATIVE[angle - 90]
    if 180 < angle < 270:
        return _DR_INTRA_DERIVATIVE[270 - angle]
    return 1


def _round2(x, bits):
    return (x + (1 << (bits - 1))) >> bits


def pix_dtype(bd: int):
    return np.uint8 if bd == 8 else np.uint16


def intra_edge_filter_strength(bs0: int, bs1: int, delta: int,
                               type_: int) -> int:
    d = abs(delta)
    blk_wh = bs0 + bs1
    s = 0
    if type_ == 0:
        if blk_wh <= 8:
            if d >= 56:
                s = 1
        elif blk_wh <= 16:
            if d >= 40:
                s = 1
        elif blk_wh <= 24:
            if d >= 8:
                s = 1
            if d >= 16:
                s = 2
            if d >= 32:
                s = 3
        elif blk_wh <= 32:
            if d >= 1:
                s = 1
            if d >= 4:
                s = 2
            if d >= 32:
                s = 3
        else:
            if d >= 1:
                s = 3
    else:
        if blk_wh <= 8:
            if d >= 40:
                s = 1
            if d >= 64:
                s = 2
        elif blk_wh <= 16:
            if d >= 20:
                s = 1
            if d >= 48:
                s = 2
        elif blk_wh <= 24:
            if d >= 4:
                s = 3
        else:
            if d >= 1:
                s = 3
    return s


def use_intra_edge_upsample(bs0: int, bs1: int, delta: int,
                            type_: int) -> bool:
    d = abs(delta)
    blk_wh = bs0 + bs1
    if d == 0 or d >= 40:
        return False
    return blk_wh <= 8 if type_ else blk_wh <= 16


def filter_intra_edge(p: np.ndarray, off: int, sz: int, strength: int):
    """5-tap edge smoothing in place on p[off:off+sz] (reconintra.c:1018)."""
    if not strength:
        return
    kernel = [[0, 4, 8, 4, 0], [0, 5, 6, 5, 0], [2, 4, 4, 4, 2]][strength - 1]
    edge = p[off:off + sz].astype(np.int32).copy()
    for i in range(1, sz):
        s = 0
        for j in range(5):
            k = min(max(i - 2 + j, 0), sz - 1)
            s += edge[k] * kernel[j]
        p[off + i] = (s + 8) >> 4
    return


def upsample_intra_edge(p: np.ndarray, off: int, sz: int, bd: int = 8):
    """2x upsample in place: p[off-2 .. off+2*sz-2] written
    (reconintra.c:1086).  p holds pixel values; off indexes sample 0."""
    assert sz <= MAX_UPSAMPLE_SZ
    maxv = (1 << bd) - 1
    inbuf = np.empty(sz + 3, dtype=np.int32)
    inbuf[0] = p[off - 1]
    inbuf[1] = p[off - 1]
    inbuf[2:2 + sz] = p[off:off + sz]
    inbuf[sz + 2] = p[off + sz - 1]
    p[off - 2] = inbuf[0]
    for i in range(sz):
        s = -inbuf[i] + 9 * inbuf[i + 1] + 9 * inbuf[i + 2] - inbuf[i + 3]
        s = min(max((s + 8) >> 4, 0), maxv)
        p[off + 2 * i - 1] = s
        p[off + 2 * i] = inbuf[i + 2]


def _dr_z1(bw, bh, above, upsample_above, dx, dtype=np.uint8):
    """Zone-1 directional predictor, vectorized over the whole block
    (dr_prediction_z1, reconintra.c)."""
    max_base_x = (bw + bh - 1) << upsample_above
    frac_bits = 6 - upsample_above
    base_inc = 1 << upsample_above
    above = above.astype(np.int32)
    x = (np.arange(1, bh + 1, dtype=np.int64) * dx)[:, None]   # (bh, 1)
    base = (x >> frac_bits) + np.arange(bw, dtype=np.int64)[None, :] \
        * base_inc
    shift = ((x << upsample_above) & 0x3F) >> 1
    idx = np.minimum(base, max_base_x)
    v = (above[idx] * (32 - shift) + above[idx + 1] * shift + 16) >> 5
    out = np.where(base < max_base_x, v, above[max_base_x])
    return out.astype(dtype)


def _dr_z2(bw, bh, above_data, left_data, off, upsample_above, upsample_left,
           dx, dy, dtype=np.uint8):
    """above_data/left_data with sample 0 at index `off` (may read -2..-1)."""
    min_base_x = -(1 << upsample_above)
    frac_bits_x = 6 - upsample_above
    frac_bits_y = 6 - upsample_left
    above = above_data.astype(np.int64)
    left = left_data.astype(np.int64)
    rr = np.arange(bh, dtype=np.int64)[:, None]
    cc = np.arange(bw, dtype=np.int64)[None, :]
    x = (cc << 6) - (rr + 1) * dx
    base_x = x >> frac_bits_x
    use_above = base_x >= min_base_x
    bx = np.clip(base_x, min_base_x, above.size - off - 2)
    sx = ((x * (1 << upsample_above)) & 0x3F) >> 1
    va = above[off + bx] * (32 - sx) + above[off + bx + 1] * sx
    y2 = (rr << 6) - (cc + 1) * dy
    base_y = y2 >> frac_bits_y
    by = np.clip(base_y, -off, left.size - off - 2)
    sy = ((y2 * (1 << upsample_left)) & 0x3F) >> 1
    vl = left[off + by] * (32 - sy) + left[off + by + 1] * sy
    v = np.where(use_above, va, vl)
    return (((v + 16) >> 5).astype(dtype))


def _dr_z3(bw, bh, left, upsample_left, dy, dtype=np.uint8):
    """Zone-3 directional predictor, vectorized (dr_prediction_z3)."""
    max_base_y = (bw + bh - 1) << upsample_left
    frac_bits = 6 - upsample_left
    base_inc = 1 << upsample_left
    left = left.astype(np.int32)
    y = (np.arange(1, bw + 1, dtype=np.int64) * dy)[None, :]   # (1, bw)
    base = (y >> frac_bits) + np.arange(bh, dtype=np.int64)[:, None] \
        * base_inc
    shift = ((y << upsample_left) & 0x3F) >> 1
    idx = np.minimum(base, max_base_y)
    v = (left[idx] * (32 - shift) + left[idx + 1] * shift + 16) >> 5
    out = np.where(base < max_base_y, v, left[max_base_y])
    return out.astype(dtype)


def _smooth(bw, bh, above, left, dtype=np.uint8):
    below = int(left[bh - 1])
    right = int(above[bw - 1])
    ww = np.array(SMOOTH_WEIGHTS[bw], dtype=np.int32)
    wh = np.array(SMOOTH_WEIGHTS[bh], dtype=np.int32)
    a = above[:bw].astype(np.int32)
    lf = left[:bh].astype(np.int32)
    pred = (wh[:, None] * a[None, :] + (256 - wh)[:, None] * below
            + ww[None, :] * lf[:, None] + (256 - ww)[None, :] * right)
    return ((pred + 256) >> 9).astype(dtype)


def _smooth_v(bw, bh, above, left, dtype=np.uint8):
    below = int(left[bh - 1])
    wh = np.array(SMOOTH_WEIGHTS[bh], dtype=np.int32)
    a = above[:bw].astype(np.int32)
    pred = wh[:, None] * a[None, :] + (256 - wh)[:, None] * below
    return ((pred + 128) >> 8).astype(dtype)


def _smooth_h(bw, bh, above, left, dtype=np.uint8):
    right = int(above[bw - 1])
    ww = np.array(SMOOTH_WEIGHTS[bw], dtype=np.int32)
    lf = left[:bh].astype(np.int32)
    pred = ww[None, :] * lf[:, None] + (256 - ww)[None, :] * right
    return ((pred + 128) >> 8).astype(dtype)


def _paeth(bw, bh, above, left, top_left, dtype=np.uint8):
    a = above[:bw].astype(np.int32)[None, :]
    lf = left[:bh].astype(np.int32)[:, None]
    tl = int(top_left)
    base = a + lf - tl
    pl = np.abs(base - lf)
    pt = np.abs(base - a)
    ptl = np.abs(base - tl)
    out = np.where((pl <= pt) & (pl <= ptl), np.broadcast_to(lf, base.shape),
                   np.where(pt <= ptl, np.broadcast_to(a, base.shape), tl))
    return out.astype(dtype)


def _filter_intra(bw, bh, above, left, top_left, mode, bd=8):
    maxv = (1 << bd) - 1
    dtype = pix_dtype(bd)
    buf = np.zeros((bh + 1, bw + 1), dtype=np.int32)
    buf[0, 0] = top_left
    buf[0, 1:] = above[:bw]
    buf[1:, 0] = left[:bh]
    taps = FILTER_INTRA_TAPS[mode]
    for r in range(1, bh + 1, 2):
        for col in range(1, bw + 1, 4):
            p = np.array([buf[r - 1, col - 1], buf[r - 1, col],
                          buf[r - 1, col + 1], buf[r - 1, col + 2],
                          buf[r - 1, col + 3], buf[r, col - 1],
                          buf[r + 1, col - 1]], dtype=np.int32)
            for k in range(8):
                ro, co = k >> 2, k & 3
                pr = int(np.dot(taps[k][:7], p))
                buf[r + ro, col + co] = min(max((pr + 8) >> 4, 0), maxv)
    return buf[1:, 1:].astype(dtype)


def build_intra_predictor(
        ref: np.ndarray, x: int, y: int, bw: int, bh: int, mode: int,
        angle_delta: int, filter_intra_mode: int,
        n_top_px: int, n_topright_px: int, n_left_px: int,
        n_bottomleft_px: int, disable_edge_filter: bool,
        intra_edge_filter_type: int, bd: int = 8) -> np.ndarray:
    """Predict one tx block at (y, x) in plane `ref` (recon so far).

    n_topright_px / n_bottomleft_px use the reference convention:
    -1 = not needed, 0 = needed but unavailable, >0 = count available.
    Returns (bh, bw) uint8 (uint16 for bd > 8).
    """
    base = 1 << (bd - 1)
    dtype = pix_dtype(bd)
    use_filter_intra = filter_intra_mode >= 0
    is_dr = is_directional(mode)
    p_angle = MODE_TO_ANGLE.get(mode, 0) + angle_delta * ANGLE_STEP \
        if is_dr else 0

    # need flags (extend_modes, reconintra.c:39)
    need_left = mode in (c.DC_PRED, c.H_PRED, c.D135_PRED, c.D113_PRED,
                         c.D157_PRED, c.D203_PRED, c.SMOOTH_PRED,
                         c.SMOOTH_V_PRED, c.SMOOTH_H_PRED, c.PAETH_PRED)
    need_above = mode in (c.DC_PRED, c.V_PRED, c.D45_PRED, c.D135_PRED,
                          c.D113_PRED, c.D157_PRED, c.D67_PRED,
                          c.SMOOTH_PRED, c.SMOOTH_V_PRED, c.SMOOTH_H_PRED,
                          c.PAETH_PRED)
    need_above_left = mode in (c.D135_PRED, c.D113_PRED, c.D157_PRED,
                               c.PAETH_PRED)
    if is_dr:
        if p_angle <= 90:
            need_above, need_left, need_above_left = True, False, True
        elif p_angle < 180:
            need_above = need_left = need_above_left = True
        else:
            need_above, need_left, need_above_left = False, True, True
    if use_filter_intra:
        need_left = need_above = need_above_left = True

    # neighbor buffers; offset 16 leaves room for upsampling writes at -2
    # plus the above-left sample at -1
    left_data = np.full(160, base + 1, dtype=np.int32)
    above_data = np.full(160, base - 1, dtype=np.int32)
    AB = 16  # index of sample 0

    if (not need_above and n_left_px == 0) or \
            (not need_left and n_top_px == 0):
        if need_left:
            val = int(ref[y - 1, x]) if n_top_px > 0 else base + 1
        else:
            val = int(ref[y, x - 1]) if n_left_px > 0 else base - 1
        return np.full((bh, bw), val, dtype=dtype)

    if need_left:
        num_left = bh + (bw if n_bottomleft_px >= 0 else 0)
        if n_left_px > 0:
            n = n_left_px + max(n_bottomleft_px, 0)
            left_data[AB:AB + n] = ref[y:y + n, x - 1]
            if n < num_left:
                left_data[AB + n:AB + num_left] = left_data[AB + n - 1]
        elif n_top_px > 0:
            left_data[AB:AB + num_left] = ref[y - 1, x]

    if need_above:
        num_top = bw + (bh if n_topright_px >= 0 else 0)
        if n_top_px > 0:
            n = n_top_px + max(n_topright_px, 0)
            above_data[AB:AB + n] = ref[y - 1, x:x + n]
            if n < num_top:
                above_data[AB + n:AB + num_top] = above_data[AB + n - 1]
        elif n_left_px > 0:
            above_data[AB:AB + num_top] = ref[y, x - 1]

    if need_above_left:
        if n_top_px > 0 and n_left_px > 0:
            above_data[AB - 1] = ref[y - 1, x - 1]
        elif n_top_px > 0:
            above_data[AB - 1] = ref[y - 1, x]
        elif n_left_px > 0:
            above_data[AB - 1] = ref[y, x - 1]
        else:
            above_data[AB - 1] = base
        left_data[AB - 1] = above_data[AB - 1]

    if use_filter_intra:
        return _filter_intra(bw, bh, above_data[AB:], left_data[AB:],
                             above_data[AB - 1], filter_intra_mode, bd)

    if is_dr:
        upsample_above = upsample_left = 0
        if not disable_edge_filter:
            need_right = p_angle < 90
            need_bottom = p_angle > 180
            if p_angle != 90 and p_angle != 180:
                ab_le = 1 if need_above_left else 0
                if need_above and need_left and bw + bh >= 24:
                    s = (left_data[AB] * 5 + above_data[AB - 1] * 6 +
                         above_data[AB] * 5 + 8) >> 4
                    above_data[AB - 1] = s
                    left_data[AB - 1] = s
                if need_above and n_top_px > 0:
                    strength = intra_edge_filter_strength(
                        bw, bh, p_angle - 90, intra_edge_filter_type)
                    n_px = n_top_px + ab_le + (bh if need_right else 0)
                    filter_intra_edge(above_data, AB - ab_le, n_px, strength)
                if need_left and n_left_px > 0:
                    strength = intra_edge_filter_strength(
                        bh, bw, p_angle - 180, intra_edge_filter_type)
                    n_px = n_left_px + ab_le + (bw if need_bottom else 0)
                    filter_intra_edge(left_data, AB - ab_le, n_px, strength)
            upsample_above = use_intra_edge_upsample(
                bw, bh, p_angle - 90, intra_edge_filter_type)
            if need_above and upsample_above:
                n_px = bw + (bh if need_right else 0)
                upsample_intra_edge(above_data, AB, n_px, bd)
            upsample_left = use_intra_edge_upsample(
                bh, bw, p_angle - 180, intra_edge_filter_type)
            if need_left and upsample_left:
                n_px = bh + (bw if need_bottom else 0)
                upsample_intra_edge(left_data, AB, n_px, bd)
        dx = get_dx(p_angle)
        dy = get_dy(p_angle)
        above = above_data[AB:]
        left = left_data[AB:]
        if 0 < p_angle < 90:
            return _dr_z1(bw, bh, above, int(upsample_above), dx, dtype)
        if 90 < p_angle < 180:
            return _dr_z2(bw, bh, above_data, left_data, AB,
                          int(upsample_above), int(upsample_left), dx, dy,
                          dtype)
        if 180 < p_angle < 270:
            return _dr_z3(bw, bh, left, int(upsample_left), dy, dtype)
        if p_angle == 90:
            return np.broadcast_to(above[:bw].astype(dtype),
                                   (bh, bw)).copy()
        if p_angle == 180:
            return np.broadcast_to(left[:bh].astype(dtype)[:, None],
                                   (bh, bw)).copy()

    above = above_data[AB:]
    left = left_data[AB:]
    if mode == c.DC_PRED:
        have_l, have_t = n_left_px > 0, n_top_px > 0
        if have_l and have_t:
            s = int(above[:bw].sum() + left[:bh].sum())
            dc = (s + ((bw + bh) >> 1)) // (bw + bh)
        elif have_l:
            dc = (int(left[:bh].sum()) + (bh >> 1)) >> bh.bit_length() - 1
        elif have_t:
            dc = (int(above[:bw].sum()) + (bw >> 1)) >> bw.bit_length() - 1
        else:
            dc = base
        return np.full((bh, bw), dc, dtype=dtype)
    if mode == c.V_PRED:
        return np.broadcast_to(above[:bw].astype(dtype), (bh, bw)).copy()
    if mode == c.H_PRED:
        return np.broadcast_to(left[:bh].astype(dtype)[:, None],
                               (bh, bw)).copy()
    if mode == c.SMOOTH_PRED:
        return _smooth(bw, bh, above, left, dtype)
    if mode == c.SMOOTH_V_PRED:
        return _smooth_v(bw, bh, above, left, dtype)
    if mode == c.SMOOTH_H_PRED:
        return _smooth_h(bw, bh, above, left, dtype)
    if mode == c.PAETH_PRED:
        return _paeth(bw, bh, above, left, above_data[AB - 1], dtype)
    raise ValueError(f"mode {mode}")


# --- CfL (av1/common/cfl.c) ------------------------------------------------


def cfl_sign_u(joint_sign: int) -> int:
    return (joint_sign + 1) // 3


def cfl_sign_v(joint_sign: int) -> int:
    return (joint_sign + 1) % 3


def cfl_context_u(joint_sign: int) -> int:
    return joint_sign - 2


def cfl_context_v(joint_sign: int) -> int:
    return cfl_sign_v(joint_sign) * 3 + cfl_sign_u(joint_sign) - 3


def cfl_idx_to_alpha(alpha_idx: int, joint_sign: int, plane: int) -> int:
    sign = cfl_sign_u(joint_sign) if plane == 0 else cfl_sign_v(joint_sign)
    if sign == 0:
        return 0
    abs_alpha = (alpha_idx >> 4) if plane == 0 else (alpha_idx & 15)
    return abs_alpha + 1 if sign == 2 else -abs_alpha - 1


def cfl_subsample_420(luma: np.ndarray) -> np.ndarray:
    """Luma (2H, 2W) -> Q3 subsampled (H, W): (sum of 2x2) << 1."""
    l32 = luma.astype(np.int32)
    return ((l32[0::2, 0::2] + l32[0::2, 1::2] + l32[1::2, 0::2]
             + l32[1::2, 1::2]) << 1)


def cfl_predict(dc_pred: np.ndarray, luma_q3: np.ndarray,
                alpha_q3: int, bd: int = 8) -> np.ndarray:
    """dc_pred (H, W) pixels, luma_q3 Q3 with average removed."""
    h, w = dc_pred.shape
    npl = (w * h).bit_length() - 1
    avg = (int(luma_q3.sum()) + (1 << npl >> 1)) >> npl
    ac = luma_q3.astype(np.int32) - avg
    scaled = alpha_q3 * ac
    scaled = np.sign(scaled) * ((np.abs(scaled) + 32) >> 6)
    return np.clip(dc_pred.astype(np.int32) + scaled, 0,
                   (1 << bd) - 1).astype(pix_dtype(bd))
