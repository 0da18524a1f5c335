"""Wavefront-batched all-intra KEY encode on torch tensors.

Port of aom_av1_lavish_tpu/ops/wavefront.py.  Blocks on one anti-
diagonal have no prediction dependency for the non-directional mode set,
so each wave encodes as one batch: gather edges -> 7 intra predictions ->
batched integer DCT -> quantize (kernel K4) -> RD mode pick -> exact
inverse -> scatter recon.  The reference's lax.fori_loop over waves is a
Python loop here; the recon stays on the device between waves.  Several
frames of one geometry ride the same waves as a batch axis (the
reference's vmap): the multi-frame all-intra entry.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import resolve_device
from ..bitstream import constants as c
from ..bitstream import tables
from ..common import quant as Q
from ..common.intra import SMOOTH_WEIGHTS

from . import txfm as TX
from .kernels import quantize_b_vec

WAVE_MODES = (c.DC_PRED, c.V_PRED, c.H_PRED, c.SMOOTH_PRED,
              c.SMOOTH_V_PRED, c.SMOOTH_H_PRED, c.PAETH_PRED)

#: log2(x) as the reference evaluates it: its jaxpr is log(x) / log(2),
#: which XLA computes as a multiply by the float32 reciprocal of log(2)
_INV_LN2 = float(np.float32(1.0) / np.float32(math.log(2.0)))


def log2_f32(x):
    return torch.log(x) * _INV_LN2


def pq_array(pq) -> np.ndarray:
    """PlaneQuant -> (5, 2) int32 [zbin, round, quant, quant_shift,
    dequant] x [dc, ac] (the reference's _pq_array; the tensor form of
    this array stands in for its _PQ)."""
    return np.array([pq.zbin, pq.round, pq.quant, pq.quant_shift,
                     pq.dequant], np.int32)


def quantize(coeff, pq, log_scale: int, dc_mask):
    """Vectorized aom_quantize_b (the reference's _quantize_jnp) through
    kernel K4.  coeff (..., n) int32; pq (5, 2) int32 tensor; dc_mask (n,)
    bool tensor.  Returns (qcoeff, dqcoeff) int32."""
    par = torch.where(dc_mask[None, :], pq[:, 0:1], pq[:, 1:2])   # (5, n)
    zbin, rnd, quant, qshift, deq = par.unbind(0)
    if log_scale:
        zbin = (zbin + (1 << log_scale >> 1)) >> log_scale
        rnd = (rnd + (1 << log_scale >> 1)) >> log_scale
    return quantize_b_vec(coeff.to(torch.int32), zbin, rnd, quant, qshift,
                          deq, log_scale)


def est_bits(qcoeff, scan):
    """Crude token-bit estimate (the reference's _est_bits): float32
    bits and the int eob, in scan order `scan` (int64 tensor)."""
    aq = qcoeff.abs().to(torch.float32)
    aq_scan = aq.index_select(-1, scan)
    nz = aq_scan > 0
    n = aq_scan.shape[-1]
    idx = torch.arange(n, device=qcoeff.device)
    eob = torch.where(nz, idx + 1, 0).amax(-1)
    nnz = nz.sum(-1)
    level_bits = torch.where(nz, 1.7 + 2.0 * log2_f32(aq_scan + 1.0),
                             0.0).sum(-1)
    bits = 2.0 + 0.9 * log2_f32(eob + 1.0) + 0.55 * (eob - nnz) \
        + level_bits
    return torch.where(eob == 0, 0.6, bits), eob


def predict_modes(above, left, al, have_top, have_left, B: int):
    """above/left (N, B) int, al (N,), flags (N,) bool -> (N, 7, B, B)
    int32 predictions in WAVE_MODES order."""
    N = above.shape[0]
    a = above.to(torch.int32)
    lf = left.to(torch.int32)
    s_a = a.sum(-1)
    s_l = lf.sum(-1)
    log2b = B.bit_length() - 1
    dc_both = (s_a + s_l + B) >> (log2b + 1)
    dc_top = (s_a + (B >> 1)) >> log2b
    dc_left = (s_l + (B >> 1)) >> log2b
    dc = torch.where(have_top & have_left, dc_both,
                     torch.where(have_top, dc_top,
                                 torch.where(have_left, dc_left, 128)))
    dc_pred = dc[:, None, None].expand(N, B, B)
    v_pred = a[:, None, :].expand(N, B, B)
    h_pred = lf[:, :, None].expand(N, B, B)
    w = torch.as_tensor(SMOOTH_WEIGHTS[B], dtype=torch.int32,
                        device=above.device)
    below = lf[:, B - 1]
    right = a[:, B - 1]
    sm = (w[None, :, None] * a[:, None, :]
          + (256 - w)[None, :, None] * below[:, None, None]
          + w[None, None, :] * lf[:, :, None]
          + (256 - w)[None, None, :] * right[:, None, None])
    sm_pred = (sm + 256) >> 9
    smv = (w[None, :, None] * a[:, None, :]
           + (256 - w)[None, :, None] * below[:, None, None])
    smv_pred = (smv + 128) >> 8
    smh = (w[None, None, :] * lf[:, :, None]
           + (256 - w)[None, None, :] * right[:, None, None])
    smh_pred = (smh + 128) >> 8
    tl = al.to(torch.int32)[:, None, None]
    base = a[:, None, :] + lf[:, :, None] - tl
    p_l = (base - lf[:, :, None]).abs()
    p_t = (base - a[:, None, :]).abs()
    p_tl = (base - tl).abs()
    paeth = torch.where((p_l <= p_t) & (p_l <= p_tl),
                        lf[:, :, None].expand(base.shape),
                        torch.where(p_t <= p_tl,
                                    a[:, None, :].expand(base.shape),
                                    tl.expand(base.shape)))
    return torch.stack([dc_pred, v_pred, h_pred, sm_pred, smv_pred,
                        smh_pred, paeth], 1).to(torch.int32)


def _plane_encode(recon, src, ys, xs, B_, scan, dc_mask, pq, tx_size,
                  n_modes, lam):
    """One plane of one wave for a batch of N frames of one geometry:
    recon and src are (N, H, W), and every frame codes the wave's blocks
    (ys, xs) in the same pass (the reference's vmap over frames), so the
    quantizer (K4) is launched once for all N.  Returns (recon, best mode
    (N, n), qcoeff of the best mode (N, n, B_*B_), its eob (N, n)); recon
    is updated in place.  Waves are not padded to a common width (the wave
    loop is in Python), so every lane is a real block and there is nothing
    for the reference's mode="drop" to drop."""
    dev = recon.device
    N, n = recon.shape[0], ys.shape[0]
    rp = torch.nn.functional.pad(recon, (1, 0, 1, 0))     # index k+1 == k
    ar = torch.arange(B_, device=dev)
    above = rp[:, ys[:, None], xs[:, None] + 1 + ar[None, :]]
    leftc = rp[:, ys[:, None] + 1 + ar[None, :], xs[:, None]]
    al = rp[:, ys, xs]
    first_l = rp[:, ys + 1, xs]
    first_a = rp[:, ys, xs + 1]
    rows = ys[:, None, None] + ar[None, :, None]
    cols = xs[:, None, None] + ar[None, None, :]
    blk = src[:, rows, cols].reshape(N * n, B_, B_)
    have_top = (ys > 0).repeat(N)
    have_left = (xs > 0).repeat(N)
    above = above.reshape(N * n, B_).to(torch.int32)
    leftc = leftc.reshape(N * n, B_).to(torch.int32)
    al = al.reshape(N * n).to(torch.int32)
    first_l = first_l.reshape(N * n).to(torch.int32)
    first_a = first_a.reshape(N * n).to(torch.int32)
    # edge fill rules (reconintra.c:1309 defaults)
    above_f = torch.where(have_top[:, None], above,
                          torch.where(have_left[:, None],
                                      first_l[:, None].expand_as(above),
                                      127))
    left_f = torch.where(have_left[:, None], leftc,
                         torch.where(have_top[:, None],
                                     first_a[:, None].expand_as(leftc),
                                     129))
    al_f = torch.where(have_top & have_left, al,
                       torch.where(have_top, first_a,
                                   torch.where(have_left, first_l, 128)))
    preds = predict_modes(above_f, left_f, al_f, have_top, have_left,
                          B_)[:, :n_modes]
    M = preds.shape[1]
    resid = blk[:, None].to(torch.int32) - preds
    coeff = TX.fwd_txfm2d_batched(resid.reshape(-1, B_, B_), tx_size,
                                  c.DCT_DCT)
    log_scale = 1 if B_ * B_ > 256 else 0
    qcoeff, dqcoeff = quantize(coeff, pq, log_scale, dc_mask)
    bits, eob = est_bits(qcoeff, scan)
    pred_u8 = preds.reshape(-1, B_, B_).to(torch.uint8)
    recon_all = TX.inv_txfm2d_add_batched(dqcoeff, pred_u8, tx_size,
                                          c.DCT_DCT)
    recon_all = torch.where((eob > 0)[:, None, None], recon_all, pred_u8)
    d = blk[:, None].to(torch.int32) - \
        recon_all.reshape(-1, M, B_, B_).to(torch.int32)
    sse = (d * d).sum((-1, -2))
    cost = sse.to(torch.float32) + \
        torch.tensor(lam, dtype=torch.float32) * bits.reshape(-1, M)
    best = cost.argmin(1)
    sel = best + torch.arange(best.shape[0], device=dev) * M
    q_best = qcoeff.reshape(-1, B_ * B_)[sel]
    eob_best = eob[sel]
    recon[:, rows, cols] = recon_all[sel].reshape(N, n, B_, B_)
    return (recon, best.reshape(N, n), q_best.reshape(N, n, B_ * B_),
            eob_best.reshape(N, n))


class WavefrontEncoder:
    """Whole-frame batched all-intra encode at fixed block size B=16."""

    B = 16

    def __init__(self, qindex: int, lam: float, device=None):
        self.qindex = qindex
        self.lam = lam
        self.device = resolve_device(device)
        self.pq = [Q.build_plane_quant(qindex, 0, 0) for _ in range(3)]

    def _wave_geometry(self, H, W):
        B = self.B
        nbr, nbc = H // B, W // B
        waves = []
        for d in range(nbr + nbc - 1):
            waves.append([(r, d - r) for r in range(max(0, d - nbc + 1),
                                                    min(nbr, d + 1))])
        return waves, nbr, nbc

    def encode_frames_raw(self, frame_list):
        """Batched multi-frame encode: the N same-geometry (y, u, v) frames
        of frame_list ride the same waves as a batch axis, one quantizer
        launch per wave and plane for all of them.  Returns per frame
        (results dict, res390, recon planes)."""
        dev = self.device
        B = self.B
        Bc = B // 2
        src_y, src_u, src_v = [
            torch.as_tensor(np.stack([np.asarray(f[pi]) for f in frame_list]),
                            device=dev) for pi in range(3)]
        N, H, W = src_y.shape
        assert H % B == 0 and W % B == 0
        waves, nbr, nbc = self._wave_geometry(H, W)
        scan_y = torch.tensor(tables.scan(c.TX_16X16, c.DCT_DCT),
                              dtype=torch.int64, device=dev)
        scan_c = torch.tensor(tables.scan(c.TX_8X8, c.DCT_DCT),
                              dtype=torch.int64, device=dev)
        dc_y = torch.arange(B * B, device=dev) == 0
        dc_c = torch.arange(Bc * Bc, device=dev) == 0
        pq = [torch.as_tensor(pq_array(p), device=dev) for p in self.pq]
        ry = torch.zeros((N, H, W), dtype=torch.uint8, device=dev)
        ru = torch.zeros((N, H // 2, W // 2), dtype=torch.uint8, device=dev)
        rv = torch.zeros((N, H // 2, W // 2), dtype=torch.uint8, device=dev)
        nblk = nbr * nbc
        out_mode = torch.zeros((N, nblk), dtype=torch.int64, device=dev)
        out_q = torch.zeros((N, nblk, B * B + 2 * Bc * Bc),
                            dtype=torch.int32, device=dev)
        out_eob = torch.zeros((N, nblk, 3), dtype=torch.int64, device=dev)
        for blocks in waves:
            rr = torch.as_tensor([r for r, _ in blocks], device=dev)
            cc = torch.as_tensor([x for _, x in blocks], device=dev)
            ys, xs = rr * B, cc * B
            ry, best, qy, eoby = _plane_encode(
                ry, src_y, ys, xs, B, scan_y, dc_y, pq[0], c.TX_16X16,
                len(WAVE_MODES), self.lam)
            ru, _, qu, eobu = _plane_encode(
                ru, src_u, ys // 2, xs // 2, Bc, scan_c, dc_c, pq[1],
                c.TX_8X8, 1, self.lam)
            rv, _, qv, eobv = _plane_encode(
                rv, src_v, ys // 2, xs // 2, Bc, scan_c, dc_c, pq[2],
                c.TX_8X8, 1, self.lam)
            bid = rr * nbc + cc
            out_mode[:, bid] = best
            out_q[:, bid] = torch.cat([qy, qu, qv], 2)
            out_eob[:, bid] = torch.stack([eoby, eobu, eobv], 2)
        modes_all = np.asarray(WAVE_MODES, np.int16)[out_mode.cpu().numpy()]
        q_all = out_q.to(torch.int16).cpu().numpy()
        eobs_all = out_eob.to(torch.int16).cpu().numpy()
        recons = [p.cpu().numpy() for p in (ry, ru, rv)]
        Bq, Bcq = B * B, Bc * Bc
        out = []
        for i in range(N):
            modes, q, eobs = modes_all[i], q_all[i], eobs_all[i]
            r390 = np.zeros((nblk, 390), np.int16)
            r390[:, 0] = modes
            r390[:, 1:4] = eobs
            r390[:, 6:390] = q
            results = {}
            for b in range(nblk):
                r, x = divmod(b, nbc)
                results[(r, x)] = dict(
                    y_mode=int(modes[b]), qy=q[b, :Bq],
                    qu=q[b, Bq:Bq + Bcq], qv=q[b, Bq + Bcq:],
                    eoby=int(eobs[b, 0]), eobu=int(eobs[b, 1]),
                    eobv=int(eobs[b, 2]))
            out.append((results, r390, tuple(p[i] for p in recons)))
        return out

    def encode_frame_raw(self, planes):
        """One frame's (y, u, v) -> (results dict, res390, recon planes):
        a batch of one."""
        return self.encode_frames_raw([planes])[0]

    def encode_frame(self, src_planes):
        """src_planes: (y, u, v) padded to B multiples.  Returns per-block
        results keyed by (block_row, block_col); sets res390 and recon."""
        results, self.res390, self.recon = self.encode_frame_raw(src_planes)
        return results
