"""ALTREF temporal filtering — MC-weighted multi-frame denoise.

Counterpart of aom_av1_lavish_tpu/encoder/temporal_filter.py on torch: the
per-neighbour cost volumes go through ops.inter.block_cost_volume (kernel
K2's plane form), the motion-aligned neighbours are cut by kernel K1
(ops.kernels.gather_windows), and the blend is float32 tensor math in the
reference's operation order.

Re-design of av1_temporal_filter (reference behavior:
av1/encoder/temporal_filter.c:1284): before coding an ARF (or key frame),
replace its source with a motion-compensated weighted average over a
window of neighbor frames, so the boosted-q anchor spends its bits on
signal instead of noise.

Design inversion vs the reference: libaom walks 32x32 blocks serially
(mb loop, tf_do_filtering_row) with per-block subpel search and a
scalar per-pixel weight loop; here every (neighbor, block) pair is
scored in one batched SSD cost volume, and the per-pixel weights for all
neighbors are one elementwise expression over (n, H, W) tensors.

Weight model (tf_compute_weight analog): w = exp(-D / (2 sigma_q^2))
where D is the 3x3-windowed mean squared alignment error and sigma_q
scales with the quantizer (noise at the target quality), matching the
reference's q-adaptive strength (temporal_filter.c:1040
tf_estimate_noise + adjust_filter_strength behavior).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..ops.inter import (_edge_pad, _untile, block_cost_volume, to_device,
                         to_host)
from ..ops.kernels import gather_windows

BLOCK = 16
RADIUS = 8          # full-pel search radius per neighbor


def _block_mvs(center, neighbors):
    """center (H, W) and neighbors, a list of (H, W) planes (H and W
    multiples of BLOCK) -> (n, Hb*Wb, 2) full-pel MVs: per block the first
    minimum of its (2*RADIUS+1)^2 SSD surface against each neighbor."""
    side = 2 * RADIUS + 1
    mvs = []
    for nb in neighbors:
        ssd = block_cost_volume(center, nb, BLOCK, RADIUS)
        idx = ssd.reshape(ssd.shape[0], side * side).argmin(1)
        mvs.append(torch.stack([idx // side - RADIUS, idx % side - RADIUS],
                               -1))
    return torch.stack(mvs)


def _align(planes, mvs, blk):
    """Per-block motion-aligned pixels: planes, a list of n (H, W) planes,
    mvs (n, Hb*Wb, 2) in plane-pel units -> (n, H, W).  Each plane is
    edge-padded by RADIUS and block (by, bx) takes the (blk, blk) window at
    RADIUS + its origin + its MV; K1 clamps a window to the padded plane,
    which is the reference's index clip."""
    H, W = planes[0].shape
    Hb, Wb = H // blk, W // blk
    dev = planes[0].device
    by, bx = torch.meshgrid(torch.arange(Hb, device=dev),
                            torch.arange(Wb, device=dev), indexing="ij")
    y0 = RADIUS + by.reshape(-1) * blk
    x0 = RADIUS + bx.reshape(-1) * blk
    out = []
    for p, mv in zip(planes, mvs):
        pad = _edge_pad(p, RADIUS)
        if pad.dtype != torch.uint8:
            pad = pad.to(torch.int32)
        win = gather_windows(pad, (y0 + mv[:, 0]).to(torch.int32),
                             (x0 + mv[:, 1]).to(torch.int32), blk, blk)
        out.append(_untile(win, Hb, Wb))
    return torch.cat(out)


def _blend(center, aligned, sigma2):
    """center (H, W) and aligned (n, H, W) float32, sigma2 a float32
    scalar -> the weighted average (H, W) float32."""
    d2 = (aligned - center[None]) ** 2
    # 3x3 windowed mean of the alignment error (tf per-pixel window): the
    # zero-padded sum of nine taps, each multiplied by float32(1)/9 as the
    # reference's convolution multiplies them
    k = np.float32(1.0) / np.float32(9.0)
    pad = F.pad(d2, (1, 1, 1, 1))
    H, W = center.shape
    win = None
    for dy in range(3):
        for dx in range(3):
            tap = pad[:, dy:dy + H, dx:dx + W] * k
            win = tap if win is None else win + tap
    w = torch.exp(-win / (np.float32(2.0) * sigma2))
    num = center + (w * aligned).sum(dim=0)
    den = 1.0 + w.sum(dim=0)
    return num / den


def _tf_full(cy, cu, cv, ny, nu, nv, sigma2):
    """The whole 4:2:0 temporal filter on the device: luma cost volumes,
    chroma reusing the halved luma MVs — the reference's per-plane MV
    sharing (temporal_filter.c tf_build_predictor applies the block MV to
    all planes).  Planes as stored; returns float32 (y, u, v)."""
    f32 = torch.float32
    mvs = _block_mvs(cy, ny)
    out_y = _blend(cy.to(f32), _align(ny, mvs, BLOCK).to(f32), sigma2)
    mv_c = torch.sign(mvs) * (mvs.abs() // 2)
    out_u = _blend(cu.to(f32), _align(nu, mv_c, BLOCK // 2).to(f32), sigma2)
    out_v = _blend(cv.to(f32), _align(nv, mv_c, BLOCK // 2).to(f32), sigma2)
    return out_y, out_u, out_v


def _filter_plane(center, neighbors, sigma2, device):
    """center (H, W) uint8, neighbors list of (H, W) uint8: one plane
    filtered with its own motion search."""
    H, W = center.shape
    Hc, Wc = (H // BLOCK) * BLOCK, (W // BLOCK) * BLOCK
    host = to_host(center, "tf/src") if isinstance(center, torch.Tensor) \
        else np.asarray(center)
    if not (Hc and Wc):
        return host.astype(np.uint8)
    c = to_device(center[:Hc, :Wc], device)
    nb = [to_device(x[:Hc, :Wc], device) for x in neighbors]
    aligned = _align(nb, _block_mvs(c, nb), BLOCK)
    out = _blend(c.to(torch.float32), aligned.to(torch.float32), sigma2)
    res = host.astype(np.float32).copy()
    res[:Hc, :Wc] = to_host(out, "tf")
    return np.clip(np.round(res), 0, 255).astype(np.uint8)


def tf_sigma2(qindex: int) -> float:
    """Filter strength from target quality (adjust_filter_strength
    analog): more aggressive at higher q where coding noise dominates."""
    from ..common.quant import ac_quant_qtx
    qstep = ac_quant_qtx(qindex, 0) / 8.0
    return max(1.0, 0.5 * qstep) ** 2


def temporal_filter(frames, center_idx: int, qindex: int,
                    window: int = 2, device=None):
    """Filter frames[center_idx] against +/-window neighbors on `device`
    (the card when None).

    frames: list of (y, u, v) planes, numpy or tensors already on the
    device; returns a filtered (y, u, v) of numpy planes.
    av1_temporal_filter entry analog."""
    lo = max(0, center_idx - window)
    hi = min(len(frames), center_idx + window + 1)
    neigh = [i for i in range(lo, hi) if i != center_idx]
    if not neigh:
        return frames[center_idx]
    device = resolve_device(device)
    s2 = np.float32(tf_sigma2(qindex))
    y, u, v = frames[center_idx]
    H, W = y.shape
    Hc, Wc = (H // BLOCK) * BLOCK, (W // BLOCK) * BLOCK
    is420 = (tuple(u.shape) == ((H + 1) >> 1, (W + 1) >> 1)
             and v.shape == u.shape and Hc and Wc)
    if not is420:
        # generic per-plane path (non-420 subsampling)
        return tuple(_filter_plane(frames[center_idx][p],
                                   [frames[i][p] for i in neigh], s2, device)
                     for p in range(3))
    H2, W2 = Hc >> 1, Wc >> 1

    def up(p, h, w):
        return to_device(p[:h, :w], device)

    filt = _tf_full(
        up(y, Hc, Wc), up(u, H2, W2), up(v, H2, W2),
        [up(frames[i][0], Hc, Wc) for i in neigh],
        [up(frames[i][1], H2, W2) for i in neigh],
        [up(frames[i][2], H2, W2) for i in neigh], s2)
    out = []
    for src, f in zip((y, u, v), filt):
        f = to_host(f, "tf")
        if isinstance(src, torch.Tensor):
            src = to_host(src, "tf/src")
        if f.shape == src.shape:
            res = f
        else:
            res = np.asarray(src, np.float32).copy()
            res[:f.shape[0], :f.shape[1]] = f
        peak = 255 if src.dtype == np.uint8 else 65535
        out.append(np.clip(np.round(res), 0, peak).astype(src.dtype))
    return tuple(out)
