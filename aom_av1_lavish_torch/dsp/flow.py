"""Optical flow: pyramidal dense flow estimation.

Re-designs the reference's flow stack as vectorized array programs:

* disflow      — aom_dsp/flow_estimation/disflow.c
                 (av1_compute_flow_field: coarse-to-fine patch refinement
                 solving 2x2 normal equations per patch)
* lucaskanade  — av1/encoder/optical_flow.c (CONFIG_OPTICAL_FLOW_API,
                 LUCAS_KANADE method: same patch solve, single window)
* horn_schunck — optical_flow.c HORN_SCHUNCK: global smoothness prior,
                 Jacobi iterations

Everything is batched over the whole patch grid at once — per-patch
2x2 solves become vectorized elementwise arithmetic, and the warp is
one bilinear gather, the shape that maps onto the TPU's VPU/MXU rather
than the reference's per-corner scalar loops.
"""

from __future__ import annotations

import numpy as np

DISFLOW_PATCH_SIZE = 8
DISFLOW_STEPS = 4


def _blur121(img: np.ndarray) -> np.ndarray:
    """Separable [1,2,1]/4 blur with edge replication."""
    p = np.pad(img.astype(np.float64), 1, mode="edge")
    h = (p[:, :-2] + 2 * p[:, 1:-1] + p[:, 2:]) * 0.25
    return (h[:-2] + 2 * h[1:-1] + h[2:]) * 0.25


def gaussian_pyramid(img: np.ndarray, levels: int) -> list:
    """Level 0 = full res; each level halves both dims (aom_dsp/
    pyramid.c analog)."""
    pyr = [np.asarray(img, dtype=np.float64)]
    for _ in range(1, levels):
        cur = _blur121(pyr[-1])
        if min(cur.shape) < 2 * DISFLOW_PATCH_SIZE:
            break
        pyr.append(cur[::2, ::2])
    return pyr


def _gradients(img: np.ndarray):
    gy, gx = np.gradient(img)
    return gx, gy


def _bilinear_sample(img: np.ndarray, ys: np.ndarray, xs: np.ndarray):
    h, w = img.shape
    ys = np.clip(ys, 0.0, h - 1.001)
    xs = np.clip(xs, 0.0, w - 1.001)
    y0 = ys.astype(np.int64)
    x0 = xs.astype(np.int64)
    fy = ys - y0
    fx = xs - x0
    return (img[y0, x0] * (1 - fy) * (1 - fx)
            + img[y0, x0 + 1] * (1 - fy) * fx
            + img[y0 + 1, x0] * fy * (1 - fx)
            + img[y0 + 1, x0 + 1] * fy * fx)


def _refine_level(ref, cur, u, v, patch, steps):
    """Refine per-pixel flow (cur -> ref) at one pyramid level: one 2x2
    normal-equation solve per patch per step (disflow.c
    compute_flow_at_point), batched over the full patch grid."""
    h, w = cur.shape
    gx, gy = _gradients(cur)
    ys = np.arange(0, h - patch + 1, patch)
    xs = np.arange(0, w - patch + 1, patch)
    if len(ys) == 0 or len(xs) == 0:
        return u, v
    py, px = np.meshgrid(ys, xs, indexing="ij")       # (ny, nx)
    dy, dx = np.mgrid[0:patch, 0:patch]
    # (ny, nx, patch, patch) absolute pixel coords per patch
    ay = py[..., None, None] + dy
    ax = px[..., None, None] + dx
    cgx = gx[ay, ax]
    cgy = gy[ay, ax]
    ccur = cur[ay, ax]
    m11 = (cgx * cgx).sum((-1, -2)) + 1e-3
    m12 = (cgx * cgy).sum((-1, -2))
    m22 = (cgy * cgy).sum((-1, -2)) + 1e-3
    det = m11 * m22 - m12 * m12
    # patch-center flow samples
    pu = u[py + patch // 2, px + patch // 2].copy()
    pv = v[py + patch // 2, px + patch // 2].copy()
    for _ in range(steps):
        warped = _bilinear_sample(ref, ay + pv[..., None, None],
                                  ax + pu[..., None, None])
        it = warped - ccur
        b1 = (cgx * it).sum((-1, -2))
        b2 = (cgy * it).sum((-1, -2))
        du = -(m22 * b1 - m12 * b2) / det
        dv = -(m11 * b2 - m12 * b1) / det
        pu += np.clip(du, -patch, patch)
        pv += np.clip(dv, -patch, patch)
    # splat back: piecewise-constant per patch, then smooth
    nu = np.repeat(np.repeat(pu, patch, 0), patch, 1)
    nv = np.repeat(np.repeat(pv, patch, 0), patch, 1)
    out_u = u.copy()
    out_v = v.copy()
    out_u[:nu.shape[0], :nu.shape[1]] = nu
    out_v[:nv.shape[0], :nv.shape[1]] = nv
    return _blur121(out_u), _blur121(out_v)


def compute_flow(ref: np.ndarray, cur: np.ndarray, levels: int = 4,
                 patch: int = DISFLOW_PATCH_SIZE,
                 steps: int = DISFLOW_STEPS, method: str = "disflow"):
    """Dense flow field (u, v) such that ref(x+u, y+v) ~= cur(x, y).

    method: "disflow" (pyramidal, av1_compute_flow_field),
    "lucaskanade" (single level), "horn_schunck" (global smoothness).
    """
    ref = np.asarray(ref, dtype=np.float64)
    cur = np.asarray(cur, dtype=np.float64)
    if method == "horn_schunck":
        return _horn_schunck(ref, cur)
    if method == "lucaskanade":
        levels = 1
    pr = gaussian_pyramid(ref, levels)
    pc = gaussian_pyramid(cur, levels)
    n = min(len(pr), len(pc))
    u = np.zeros_like(pc[n - 1])
    v = np.zeros_like(pc[n - 1])
    for lvl in range(n - 1, -1, -1):
        if u.shape != pc[lvl].shape:
            # upsample flow x2 (values double with resolution)
            u = np.repeat(np.repeat(u, 2, 0), 2, 1)[:pc[lvl].shape[0],
                                                    :pc[lvl].shape[1]] * 2
            v = np.repeat(np.repeat(v, 2, 0), 2, 1)[:pc[lvl].shape[0],
                                                    :pc[lvl].shape[1]] * 2
            if u.shape != pc[lvl].shape:
                uu = np.zeros_like(pc[lvl])
                vv = np.zeros_like(pc[lvl])
                uu[:u.shape[0], :u.shape[1]] = u
                vv[:v.shape[0], :v.shape[1]] = v
                u, v = uu, vv
        u, v = _refine_level(pr[lvl], pc[lvl], u, v, patch, steps)
    return u, v


def _horn_schunck(ref, cur, alpha: float = 25.0, iters: int = 64):
    """optical_flow.c HORN_SCHUNCK: minimize |I_x u + I_y v + I_t|^2 +
    alpha^2 (|grad u|^2 + |grad v|^2) by Jacobi iteration."""
    gx, gy = _gradients(cur)
    it = ref - cur
    u = np.zeros_like(cur)
    v = np.zeros_like(cur)
    k = np.array([[1, 2, 1], [2, 0, 2], [1, 2, 1]], np.float64) / 12.0
    den = alpha * alpha + gx * gx + gy * gy
    for _ in range(iters):
        ub = _conv3(u, k)
        vb = _conv3(v, k)
        t = (gx * ub + gy * vb + it) / den
        u = ub - gx * t
        v = vb - gy * t
    return u, v


def _conv3(img, k):
    p = np.pad(img, 1, mode="edge")
    out = np.zeros_like(img)
    for i in range(3):
        for j in range(3):
            if k[i, j]:
                out += k[i, j] * p[i:i + img.shape[0], j:j + img.shape[1]]
    return out


def flow_correspondences(ref, cur, stride: int = 16, **kw):
    """(pts Nx2 xy, mvs Nx2 dxdy) sampled from the dense field — the
    input shape global_motion._irls_affine consumes (the reference feeds
    disflow correspondences to RANSAC, flow_estimation.c:60)."""
    u, v = compute_flow(ref, cur, **kw)
    h, w = u.shape
    ys = np.arange(stride, h - stride, stride)
    xs = np.arange(stride, w - stride, stride)
    gy, gx = np.meshgrid(ys, xs, indexing="ij")
    pts = np.stack([gx.ravel(), gy.ravel()], 1).astype(np.float64)
    mvs = np.stack([u[gy, gx].ravel(), v[gy, gx].ravel()], 1)
    return pts, mvs
