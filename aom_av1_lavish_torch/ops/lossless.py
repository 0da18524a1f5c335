"""Batched analyze path for the lossless all-intra encoder, on torch.

Port of aom_av1_lavish_tpu/ops/lossless.py.  In lossless coding recon ==
source for every coded block, so the per-4x4 DC prediction, residual,
Walsh-Hadamard transform and quantization have NO sequential dependency —
the whole frame is one batched integer tensor program (adds and shifts on
int32, nothing float).  Only per-tile entropy coding remains sequential and
runs on the host.  The reference computes all of this scalar, block-by-block
inside the RDO loop (av1/encoder/encodeframe.c).

Bit-exactness: cross-checked against common/txfm.py + common/intra.py and
against the JAX package in tests/test_torch_lossless.py.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device


def _wht_fwd_stage(a1, b1, c1, d1):
    a1 = a1 + b1
    d1 = d1 - c1
    e1 = (a1 - d1) >> 1
    b1 = e1 - b1
    c1 = e1 - c1
    a1 = a1 - c1
    d1 = d1 + b1
    return a1, b1, c1, d1


def fwht4x4_batched(resid):
    """Forward WHT over (..., 4, 4) int32 residuals; returns flat-layout
    coefficients (..., 4, 4) where out[..., k, i] matches the reference's
    output[4k + i] (see common/txfm.py for the layout contract)."""
    x = resid.to(torch.int32)
    # pass 1: butterfly down each input column i; interm[i, j] holds the
    # j-th of (a, c, d, b) for column i
    a1, b1, c1, d1 = _wht_fwd_stage(x[..., 0, :], x[..., 1, :],
                                    x[..., 2, :], x[..., 3, :])
    t = torch.stack([a1, c1, d1, b1], dim=-1)  # (..., i, j)
    # pass 2: per i, stage inputs (a,b,c,d) = interm[0..3, i] = t[..,k,i];
    # flat output[4k + i] = k-th of (a, c, d, b) for that i
    a1, b1, c1, d1 = _wht_fwd_stage(t[..., 0, :], t[..., 1, :],
                                    t[..., 2, :], t[..., 3, :])
    out = torch.stack([a1, c1, d1, b1], dim=-2)  # out[..., k, i]
    return out << 2


def lossless_plane_analyze(src):
    """Batched per-4x4 DC-predict + WHT + quantize for one plane, or for a
    stack of planes.

    src: (..., H, W) uint8 tensor (H, W multiples of 4).  Returns
    (qcoeff (..., H/4, W/4, 16) int32, zero (..., H/4, W/4) bool).

    Availability rule (lossless, single tile): have_top <=> py > 0,
    have_left <=> px > 0, since recon == source makes every previously-coded
    neighbor equal to the source.
    """
    H, W = src.shape[-2:]
    lead = src.shape[:-2]
    h4, w4 = H // 4, W // 4
    s = src.to(torch.int32)
    blocks = s.reshape(*lead, h4, 4, w4, 4).transpose(-2, -3)

    # above row sums: sum of src[py-1, px:px+4] for each block
    above = F.pad(s, (0, 0, 1, 0))[..., :-1, :]   # row py-1 (row 0 unused)
    sum_above = above.reshape(*lead, h4, 4, w4, 4)[..., 0, :, :].sum(-1)
    left = F.pad(s, (1, 0, 0, 0))[..., :, :-1]
    sum_left = left.reshape(*lead, h4, 4, w4, 4)[..., 0].sum(-2)

    dev = src.device
    have_top = (torch.arange(h4, device=dev) > 0)[:, None].expand(h4, w4)
    have_left = (torch.arange(w4, device=dev) > 0)[None, :].expand(h4, w4)

    dc_both = (sum_above + sum_left + 4) >> 3
    dc_top = (sum_above + 2) >> 2
    dc_left = (sum_left + 2) >> 2
    dc = torch.where(have_top & have_left, dc_both,
                     torch.where(have_top, dc_top,
                                 torch.where(have_left, dc_left, 128)))

    resid = blocks - dc[..., None, None]
    coeff = fwht4x4_batched(resid)
    q = coeff >> 2  # lossless quantization: exact /4 (coeff is a multiple)
    qflat = q.reshape(*lead, h4, w4, 16)
    return qflat, (qflat == 0).all(-1)


def lossless_frame_analyze(y, u, v):
    """Analyze all three planes; returns per-plane (qcoeff, zero)."""
    return (lossless_plane_analyze(y), lossless_plane_analyze(u),
            lossless_plane_analyze(v))


def _up(plane, device):
    return torch.as_tensor(np.ascontiguousarray(plane), device=device)


def analyze_for_encoder(planes, device=None):
    """Host-friendly wrapper: numpy in/out for the encoder integration,
    the analyze on `device` (the card when None)."""
    device = resolve_device(device)
    rs = lossless_frame_analyze(*(_up(p, device) for p in planes))
    return [(q.cpu().numpy(), z.cpu().numpy()) for (q, z) in rs]


def analyze_frames_for_encoder(frame_planes, device=None):
    """Batched multi-frame analyze: each plane of the whole sequence is one
    stacked tensor program and one copy back.

    frame_planes: list of (y, u, v) same-shape numpy planes (mi-aligned).
    Returns a list (per frame) of per-plane (qcoeff, zero) entries; zero
    flags are not materialized (the tile walkers test qcoeff directly).
    Coefficients come back as int16 (the lossless 4x4 WHT/4 of 8-bit
    residuals fits 13 bits), half the bytes of the copy.
    """
    device = resolve_device(device)
    qs = []
    for pi in range(3):
        stack = _up(np.stack([f[pi] for f in frame_planes]), device)
        q, _ = lossless_plane_analyze(stack)
        qs.append(q.to(torch.int16).cpu().numpy())
    return [[(qs[0][i], None), (qs[1][i], None), (qs[2][i], None)]
            for i in range(len(frame_planes))]


def analyze_tiled_for_encoder(planes, row_ranges, col_ranges, device=None):
    """Per-tile analyze: DC prediction availability resets at tile edges
    (AV1 tiles are fully independent).  Each tile slice goes through the
    SAME per-plane analyze — a tile's local (0, 0) origin gives exactly
    the in-tile availability rule.

    row_ranges/col_ranges: luma pixel [start, end) per tile row/col.
    Returns per-plane (qcoeff (h4, w4, 16) int32, None) for the whole
    frame, assembled from the per-tile results.
    """
    device = resolve_device(device)
    out = []
    for pi, p in enumerate(planes[:3]):
        ss = 1 if pi else 0
        pt = _up(p, device)
        h4, w4 = p.shape[0] // 4, p.shape[1] // 4
        q = torch.zeros((h4, w4, 16), dtype=torch.int32, device=device)
        for (r0, r1) in row_ranges:
            for (c0, c1) in col_ranges:
                pr0, pr1 = r0 >> ss, r1 >> ss
                pc0, pc1 = c0 >> ss, c1 >> ss
                qt, _ = lossless_plane_analyze(pt[pr0:pr1, pc0:pc1])
                q[pr0 >> 2:pr1 >> 2, pc0 >> 2:pc1 >> 2] = qt
        out.append((q.cpu().numpy(), None))
    return out
