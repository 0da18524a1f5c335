"""Device deblocking for the fixed-16x16 KEY and the variable-partition
P frames, on torch tensors.

Port of aom_av1_lavish_tpu/ops/deblock_jnp.py: the normative AV1 loop
filter (spec 7.14) specialized to the layouts the device encoders emit —
luma TX == block size on a 16-aligned grid (14-tap), chroma on the 8
grid (6-tap), one level per plane and direction.  Each direction is one
pass over strided tap slices; vertical edges first, then horizontal.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..common.loopfilter import sharpness_limits


@lru_cache(maxsize=None)
def _lim_tables(sharpness: int):
    lim, mblim = sharpness_limits(sharpness)
    return np.asarray(lim, np.int64), np.asarray(mblim, np.int64)


@lru_cache(maxsize=None)
def _lim_tables_on(sharpness: int, device: torch.device):
    return tuple(torch.as_tensor(t, device=device)
                 for t in _lim_tables(sharpness))


def _filter4_core(p1, p0, q0, q1, mask, hev):
    """filter4 on int32 tensors centred at +-128 -> (op1, op0, oq0, oq1)."""
    def clamp(x):
        return x.clamp(-128, 127)
    ps1, ps0 = p1 - 128, p0 - 128
    qs0, qs1 = q0 - 128, q1 - 128
    f = torch.where(hev, clamp(ps1 - qs1), 0)
    f = torch.where(mask, clamp(f + 3 * (qs0 - ps0)), 0)
    f1 = clamp(f + 4) >> 3
    f2 = clamp(f + 3) >> 3
    oq0 = clamp(qs0 - f1) + 128
    op0 = clamp(ps0 + f2) + 128
    f3 = torch.where(hev, 0, (f1 + 1) >> 1)
    oq1 = clamp(qs1 - f3) + 128
    op1 = clamp(ps1 + f3) + 128
    return op1, op0, oq0, oq1


def _ad(a, b):
    return (a - b).abs()


def _filter14(P, Q, lim, mblim, thresh):
    """14-tap luma edge filter on taps P[0..6], Q[0..6] -> new
    (P[0..5], Q[0..5])."""
    mask = ~((_ad(P[3], P[2]) > lim) | (_ad(P[2], P[1]) > lim)
             | (_ad(P[1], P[0]) > lim) | (_ad(Q[1], Q[0]) > lim)
             | (_ad(Q[2], Q[1]) > lim) | (_ad(Q[3], Q[2]) > lim)
             | (_ad(P[0], Q[0]) * 2 + (_ad(P[1], Q[1]) >> 1) > mblim))
    flat = ~((_ad(P[1], P[0]) > 1) | (_ad(Q[1], Q[0]) > 1)
             | (_ad(P[2], P[0]) > 1) | (_ad(Q[2], Q[0]) > 1)
             | (_ad(P[3], P[0]) > 1) | (_ad(Q[3], Q[0]) > 1))
    flat2 = ~((_ad(P[6], P[0]) > 1) | (_ad(P[5], P[0]) > 1)
              | (_ad(P[4], P[0]) > 1) | (_ad(Q[4], Q[0]) > 1)
              | (_ad(Q[5], Q[0]) > 1) | (_ad(Q[6], Q[0]) > 1))
    hev = (_ad(P[1], P[0]) > thresh) | (_ad(Q[1], Q[0]) > thresh)
    o1, o0, oq0, oq1 = _filter4_core(P[1], P[0], Q[0], Q[1],
                                     mask & ~flat, hev)
    fm = flat & mask

    def r2(x):
        return (x + 4) >> 3

    p6, p5, p4, p3, p2, p1, p0 = P[6], P[5], P[4], P[3], P[2], P[1], P[0]
    q0, q1, q2, q3, q4, q5, q6 = Q[0], Q[1], Q[2], Q[3], Q[4], Q[5], Q[6]
    np_ = [torch.where(fm, r2(p3 + p2 + p1 + 2 * p0 + q0 + q1 + q2), o0),
           torch.where(fm, r2(p3 * 2 + p2 + 2 * p1 + p0 + q0 + q1), o1),
           torch.where(fm, r2(p3 * 3 + 2 * p2 + p1 + p0 + q0), p2),
           p3, p4, p5]
    nq = [torch.where(fm, r2(p2 + p1 + p0 + 2 * q0 + q1 + q2 + q3), oq0),
          torch.where(fm, r2(p1 + p0 + q0 + 2 * q1 + q2 + 2 * q3), oq1),
          torch.where(fm, r2(p0 + q0 + q1 + 2 * q2 + 3 * q3), q2),
          q3, q4, q5]
    fm2 = flat2 & fm

    def r4(x):
        return (x + 8) >> 4

    wp = [r4(p6 + p5 + p4 + p3 + p2 + p1 * 2 + p0 * 2 + q0 * 2
             + q1 + q2 + q3 + q4 + q5),
          r4(p6 * 2 + p5 + p4 + p3 + p2 * 2 + p1 * 2 + p0 * 2
             + q0 + q1 + q2 + q3 + q4),
          r4(p6 * 3 + p5 + p4 + p3 * 2 + p2 * 2 + p1 * 2 + p0
             + q0 + q1 + q2 + q3),
          r4(p6 * 4 + p5 + p4 * 2 + p3 * 2 + p2 * 2 + p1 + p0
             + q0 + q1 + q2),
          r4(p6 * 5 + p5 * 2 + p4 * 2 + p3 * 2 + p2 + p1 + p0 + q0 + q1),
          r4(p6 * 7 + p5 * 2 + p4 * 2 + p3 + p2 + p1 + p0 + q0)]
    wq = [r4(p5 + p4 + p3 + p2 + p1 + p0 * 2 + q0 * 2 + q1 * 2
             + q2 + q3 + q4 + q5 + q6),
          r4(p4 + p3 + p2 + p1 + p0 + q0 * 2 + q1 * 2 + q2 * 2
             + q3 + q4 + q5 + q6 * 2),
          r4(p3 + p2 + p1 + p0 + q0 + q1 * 2 + q2 * 2 + q3 * 2
             + q4 + q5 + q6 * 3),
          r4(p2 + p1 + p0 + q0 + q1 + q2 * 2 + q3 * 2 + q4 * 2
             + q5 + q6 * 4),
          r4(p1 + p0 + q0 + q1 + q2 + q3 * 2 + q4 * 2 + q5 * 2 + q6 * 5),
          r4(p0 + q0 + q1 + q2 + q3 + q4 * 2 + q5 * 2 + q6 * 7)]
    return ([torch.where(fm2, wp[i], np_[i]) for i in range(6)],
            [torch.where(fm2, wq[i], nq[i]) for i in range(6)])


def _filter6(P, Q, lim, mblim, thresh):
    """6-tap chroma edge filter on taps P[0..2], Q[0..2] -> new
    (P[0..1], Q[0..1])."""
    mask = ~((_ad(P[2], P[1]) > lim) | (_ad(P[1], P[0]) > lim)
             | (_ad(Q[1], Q[0]) > lim) | (_ad(Q[2], Q[1]) > lim)
             | (_ad(P[0], Q[0]) * 2 + (_ad(P[1], Q[1]) >> 1) > mblim))
    flat = ~((_ad(P[1], P[0]) > 1) | (_ad(Q[1], Q[0]) > 1)
             | (_ad(P[2], P[0]) > 1) | (_ad(Q[2], Q[0]) > 1))
    hev = (_ad(P[1], P[0]) > thresh) | (_ad(Q[1], Q[0]) > thresh)
    o1, o0, oq0, oq1 = _filter4_core(P[1], P[0], Q[0], Q[1],
                                     mask & ~flat, hev)
    fm = flat & mask

    def r2(x):
        return (x + 4) >> 3

    n_p1 = r2(P[2] * 3 + P[1] * 2 + P[0] * 2 + Q[0])
    n_p0 = r2(P[2] + P[1] * 2 + P[0] * 2 + Q[0] * 2 + Q[1])
    n_q0 = r2(P[1] + P[0] * 2 + Q[0] * 2 + Q[1] * 2 + Q[2])
    n_q1 = r2(P[0] + Q[0] * 2 + Q[1] * 2 + Q[2] * 3)
    return ([torch.where(fm, n_p0, o0), torch.where(fm, n_p1, o1)],
            [torch.where(fm, n_q0, oq0), torch.where(fm, n_q1, oq1)])


def _edge_pass(plane, step, ntaps, nmod, filt, lim, mblim, thresh,
               horizontal, edge_mask=None):
    """One direction's edge pass over an int32 plane, or a (F, h, w) stack
    of planes (interior edges every `step` pixels; ntaps read and nmod
    written on each side).  Edges where edge_mask ([F,] rows, K) is False
    are left untouched.  lim, mblim and thresh are ints, or (F, 1, 1)
    tensors of each frame's."""
    if horizontal:
        plane = plane.transpose(-1, -2)
    plane = plane.clone()
    W = plane.shape[-1]
    K = W // step - 1
    if K > 0:
        span = step * K
        # taps: p_i at column e*step - 1 - i, q_i at e*step + i (e = 1..K)
        P = [plane[..., step - 1 - i:step - 1 - i + span:step]
             for i in range(ntaps)]
        Q = [plane[..., step + i:step + i + span:step] for i in range(ntaps)]
        new_p, new_q = filt(P, Q, lim, mblim, thresh)
        for i in range(nmod):
            np_i, nq_i = new_p[i], new_q[i]
            if edge_mask is not None:
                np_i = torch.where(edge_mask, np_i, P[i])
                nq_i = torch.where(edge_mask, nq_i, Q[i])
            plane[..., step - 1 - i:step - 1 - i + span:step] = np_i
            plane[..., step + i:step + i + span:step] = nq_i
    return plane.transpose(-1, -2) if horizontal else plane


def _plane_pass(plane_u8, lvl, sharpness, step, ntaps, nmod, filt):
    """One plane at one level (0 leaves it unfiltered), every edge."""
    p32 = plane_u8.to(torch.int32)
    lvl = int(lvl)
    if lvl <= 0:
        return plane_u8.clone()
    lim_tab, mblim_tab = _lim_tables(sharpness)
    lim, mblim, thresh = int(lim_tab[lvl]), int(mblim_tab[lvl]), lvl >> 4
    out = _edge_pass(p32, step, ntaps, nmod, filt, lim, mblim, thresh,
                     horizontal=False)
    out = _edge_pass(out, step, ntaps, nmod, filt, lim, mblim, thresh,
                     horizontal=True)
    return out.clamp(0, 255).to(torch.uint8)


def _frames_pass(planes_u8, lvl, sharpness, step, ntaps, nmod, filt, von,
                 hon):
    """(F, h, w) planes, frame f at level lvl[f] ((F,) int tensor) with its
    edges on where von/hon (F, ...) say; a frame at level 0 keeps its plane
    (a mask: the filter runs for every frame)."""
    lim_tab, mblim_tab = _lim_tables_on(sharpness, planes_u8.device)
    lvl = lvl.to(device=planes_u8.device, dtype=torch.int64).clamp_min(0)
    lim = lim_tab[lvl].view(-1, 1, 1)
    mblim = mblim_tab[lvl].view(-1, 1, 1)
    thresh = (lvl >> 4).view(-1, 1, 1)
    vmask = von.repeat_interleave(step, -2)                # (F, rows, K)
    hmask = hon.transpose(-1, -2).repeat_interleave(step, -2)  # (F, cols, K)
    out = _edge_pass(planes_u8.to(torch.int32), step, ntaps, nmod, filt, lim,
                     mblim, thresh, horizontal=False, edge_mask=vmask)
    out = _edge_pass(out, step, ntaps, nmod, filt, lim, mblim, thresh,
                     horizontal=True, edge_mask=hmask)
    return torch.where((lvl > 0).view(-1, 1, 1),
                       out.clamp(0, 255).to(torch.uint8), planes_u8)


def deblock_fixed16(rec_y, rec_u, rec_v, lvl_y, lvl_uv_u, lvl_uv_v,
                    sharpness: int = 0):
    """Deblock uint8 4:2:0 planes of a fixed-16x16 / TX16 / TX8 frame at
    per-plane levels (0 leaves a plane unfiltered)."""
    y = _plane_pass(rec_y, lvl_y, sharpness, 16, 7, 6, _filter14)
    u = _plane_pass(rec_u, lvl_uv_u, sharpness, 8, 3, 2, _filter6)
    v = _plane_pass(rec_v, lvl_uv_v, sharpness, 8, 3, 2, _filter6)
    return y, u, v


def deblock_leafmask(rec_y, rec_u, rec_v, lvl_y, lvl_uv_u, lvl_uv_v,
                     leaf_id, sharpness: int = 0):
    """Deblock planes of a variable-partition frame (leaves in {16, 32,
    64} squares, tx == block size).  leaf_id (nby, nbx): a 16-grid edge
    is filtered iff the leaf ids on its two sides differ; chroma edges on
    the 8 grid map 1:1 onto them.

    A batch of frames (the reference's vmap over a GF group): (F, h, w)
    planes, levels as (F,) int tensors (or sequences) and leaf_id
    (F, nby, nbx), each frame at its own levels, a frame at level 0 left
    unfiltered.  One frame's 2-D planes take int levels."""
    if rec_y.dim() == 2:
        dev = rec_y.device
        out = deblock_leafmask(
            rec_y[None], rec_u[None], rec_v[None],
            *(torch.full((1,), int(lv), device=dev)
              for lv in (lvl_y, lvl_uv_u, lvl_uv_v)),
            leaf_id[None], sharpness)
        return tuple(p[0] for p in out)
    von = leaf_id[..., :, 1:] != leaf_id[..., :, :-1]    # (F, nby, nbx-1)
    hon = leaf_id[..., 1:, :] != leaf_id[..., :-1, :]    # (F, nby-1, nbx)
    lv = [torch.as_tensor(v) for v in (lvl_y, lvl_uv_u, lvl_uv_v)]
    y = _frames_pass(rec_y, lv[0], sharpness, 16, 7, 6, _filter14, von, hon)
    u = _frames_pass(rec_u, lv[1], sharpness, 8, 3, 2, _filter6, von, hon)
    v = _frames_pass(rec_v, lv[2], sharpness, 8, 3, 2, _filter6, von, hon)
    return y, u, v
