"""Global motion estimation (encoder side).

Re-designs the reference's corner-match + RANSAC pipeline
(av1/encoder/global_motion_facade.c:av1_compute_global_motion,
aom_dsp/flow_estimation/) as a dense, vectorized pipeline that fits the
batch-friendly TPU style: a block-translation field measured with
vectorized SAD sweeps, then an IRLS (iteratively-reweighted least
squares) affine fit with outlier down-weighting, quantized to the AV1
warp-model grid (av1/common/mv.h GM_*_PREC) and validated through the
same shear test the decoder applies.
"""

from __future__ import annotations

import numpy as np

from ..bitstream import constants as c

GM_ALPHA_MAX = 1 << 12
GM_TRANS_MAX = 1 << 12
_IDENTITY = (c.IDENTITY, (0, 0, 1 << 16, 0, 0, 1 << 16), 0)


def _block_motion_field(src: np.ndarray, ref: np.ndarray, blk: int = 16,
                        rad: int = 16, step: int = 2):
    """Full-search translation per sampled block; returns (pts Nx2 xy,
    mvs Nx2 dxdy, sad gain ratio per point).  Vectorized over offsets."""
    h, w = src.shape
    ys = np.arange(rad, h - blk - rad, blk)
    xs = np.arange(rad, w - blk - rad, blk)
    if len(ys) == 0 or len(xs) == 0:
        return np.zeros((0, 2)), np.zeros((0, 2)), np.zeros(0)
    s = src.astype(np.int32)
    r = ref.astype(np.int32)
    blocks = np.stack([s[y:y + blk, x:x + blk]
                       for y in ys for x in xs])           # (N,blk,blk)
    offs = [(dy, dx) for dy in range(-rad, rad + 1, step)
            for dx in range(-rad, rad + 1, step)]
    best = np.full(len(blocks), np.inf)
    best_off = np.zeros((len(blocks), 2), np.int32)
    zero_sad = None
    for (dy, dx) in offs:
        cand = np.stack([r[y + dy:y + dy + blk, x + dx:x + dx + blk]
                         for y in ys for x in xs])
        sad = np.abs(cand - blocks).sum(axis=(1, 2))
        if (dy, dx) == (0, 0):
            zero_sad = sad.astype(np.float64)
        upd = sad < best
        best = np.where(upd, sad, best)
        best_off[upd] = (dy, dx)
    # +-1 refinement around each block's winner (coarse grid is step=2)
    if step > 1:
        for _ in range(step):
            improved = False
            for (dy, dx) in ((-1, 0), (1, 0), (0, -1), (0, 1)):
                ny = np.clip(best_off[:, 0] + dy, -rad, rad)
                nx = np.clip(best_off[:, 1] + dx, -rad, rad)
                sad = np.array([
                    np.abs(r[y + oy:y + oy + blk, x + ox:x + ox + blk]
                           - blocks[i]).sum()
                    for i, ((y, x), (oy, ox)) in enumerate(zip(
                        [(y, x) for y in ys for x in xs],
                        zip(ny, nx)))])
                upd = sad < best
                if upd.any():
                    improved = True
                    best = np.where(upd, sad, best)
                    best_off[upd, 0] = ny[upd]
                    best_off[upd, 1] = nx[upd]
            if not improved:
                break
    pts = np.array([(x + blk / 2, y + blk / 2) for y in ys for x in xs],
                   np.float64)
    mvs = best_off[:, ::-1].astype(np.float64)             # (dx, dy)
    gain = 1.0 - best / np.maximum(zero_sad, 1.0)
    return pts, mvs, gain


def _irls_affine(pts, mvs, weights, iters: int = 5):
    """Weighted LS fit of [x'; y'] = A [x; y] + t with IRLS outlier
    down-weighting.  Returns (a11, a12, a21, a22, tx, ty)."""
    x, y = pts[:, 0], pts[:, 1]
    tx_obs = mvs[:, 0]
    ty_obs = mvs[:, 1]
    wgt = weights.copy()
    A = np.stack([x, y, np.ones_like(x)], axis=1)
    params = None
    for _ in range(iters):
        ww = wgt[:, None]
        lhs = A * np.sqrt(ww)
        px, *_ = np.linalg.lstsq(lhs, tx_obs * np.sqrt(wgt), rcond=None)
        py, *_ = np.linalg.lstsq(lhs, ty_obs * np.sqrt(wgt), rcond=None)
        rx = A @ px - tx_obs
        ry = A @ py - ty_obs
        resid = np.hypot(rx, ry)
        sigma = max(np.median(resid) * 1.4826, 0.25)
        wgt = weights / (1.0 + (resid / (2.0 * sigma)) ** 2)
        params = (px, py)
    px, py = params
    return (1.0 + px[0], px[1], py[0], 1.0 + py[1], px[2], py[2])


def estimate_global_motion(src_y, ref_y, allow_hp: int = 0,
                           method: str = "blocks"):
    """Estimate one ref's global motion; returns (wmtype, mat, invalid)
    in frame-header format, or the identity entry when no reliable model
    exists.  method "blocks" uses the SAD block field; "disflow" uses
    dense pyramidal flow correspondences (GLOBAL_MOTION_METHOD_DISFLOW,
    aom_dsp/flow_estimation/disflow.c)."""
    from ..common import warp as WP
    src = np.asarray(src_y)
    ref = np.asarray(ref_y)
    if method == "disflow":
        from ..dsp.flow import flow_correspondences
        pts, mvs = flow_correspondences(ref, src)
        gain = np.ones(len(pts))
        moving = np.hypot(mvs[:, 0], mvs[:, 1]) > 0.25
    else:
        pts, mvs, gain = _block_motion_field(src, ref)
        moving = np.hypot(mvs[:, 0], mvs[:, 1]) > 0.5
    if len(pts) < 8 or moving.mean() < 0.3:
        return _IDENTITY
    weights = np.maximum(gain, 1e-3)
    a11, a12, a21, a22, tx, ty = _irls_affine(pts, mvs, weights)

    # quantize to the warp-model grid (GM_ALPHA_PREC_BITS=15 with
    # DECODE_FACTOR 2 => even steps at 1/2^16; trans at 1/2^6 pel => the
    # coded grid is mat[0,1] multiples of 1<<10)
    def q_alpha(v):
        q = int(round(v * (1 << 15))) * 2
        return max(-GM_ALPHA_MAX * 2, min(GM_ALPHA_MAX * 2, q))

    m2 = q_alpha(a11 - 1.0) + (1 << 16)
    m3 = q_alpha(a12)
    m4 = q_alpha(a21)
    m5 = q_alpha(a22 - 1.0) + (1 << 16)
    tdec = 1 << 10
    m0 = int(round(ty * (1 << 16) / tdec)) * tdec
    m1 = int(round(tx * (1 << 16) / tdec)) * tdec
    tmax = GM_TRANS_MAX * tdec
    m0 = max(-tmax, min(tmax, m0))
    m1 = max(-tmax, min(tmax, m1))

    rotzoom = abs(m4 + m3) <= 2 and abs(m5 - m2) <= 2
    if rotzoom:
        m4 = -m3
        m5 = m2
        wmtype = c.ROTZOOM
    else:
        wmtype = c.AFFINE
    if m2 == (1 << 16) and m3 == 0 and m4 == 0 and m5 == (1 << 16):
        if m0 == 0 and m1 == 0:
            return _IDENTITY
        # pure translation: re-quantize at translation-only precision
        prec = 13 + (not allow_hp)
        tdec2 = 1 << prec
        lim = (1 << (9 - (not allow_hp))) * tdec2
        m0 = max(-lim, min(lim, int(round(ty * (1 << 16) / tdec2)) * tdec2))
        m1 = max(-lim, min(lim, int(round(tx * (1 << 16) / tdec2)) * tdec2))
        if m0 == 0 and m1 == 0:
            return _IDENTITY
        return (c.TRANSLATION, (m0, m1, 1 << 16, 0, 0, 1 << 16), 0)
    mat = (m0, m1, m2, m3, m4, m5)
    ok, *_ = WP.get_shear_params(list(mat))
    if not ok:
        return _IDENTITY
    return (wmtype, mat, 0)
