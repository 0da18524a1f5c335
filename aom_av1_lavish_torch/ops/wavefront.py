"""Wavefront-batched all-intra KEY encode on torch tensors.

Port of aom_av1_lavish_tpu/ops/wavefront.py.  Blocks on one anti-
diagonal have no prediction dependency for the non-directional mode set,
so each wave encodes as one batch: gather edges -> 7 intra predictions ->
batched integer DCT -> quantize -> RD mode pick -> exact inverse ->
scatter recon.  The reference's lax.fori_loop over waves is a Python loop
here, one call of kernels.wave_encode a wave (kernel K4's fused entry: on
the card one launch codes the wave's blocks of all three planes); the
recon and the result rows stay on the device between waves and are fetched
once.  Several frames of one geometry ride the same waves as a batch axis
(the reference's vmap): the multi-frame all-intra entry.

wave_step is the same wave as a composition of torch ops (the plain
version of wave_encode, and what the CPU runs).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import resolve_device
from ..bitstream import constants as c
from ..bitstream import tables
from ..common import quant as Q
from ..common.intra import SMOOTH_WEIGHTS
from ..utils.profiler import profile

from . import txfm as TX
from .kernels import (INV_LN2 as _INV_LN2, WAVE_MODES, WAVE_ROW,
                      quantize_b_vec, wave_encode)


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
    kernel K4.  coeff (..., n) int32; pq (5, 2) int32 tensor, or (F, 5, 2)
    for coeff (F, ..., n): a quantizer per frame; dc_mask (n,) bool tensor.
    Returns (qcoeff, dqcoeff) int32."""
    par = torch.where(dc_mask, pq[..., 0:1], pq[..., 1:2])  # ([F,] 5, n)
    zbin, rnd, quant, qshift, deq = par.unbind(-2)
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


@lru_cache(maxsize=None)
def _smooth_weights_on(B: int, device: torch.device):
    return torch.as_tensor(SMOOTH_WEIGHTS[B], dtype=torch.int32,
                           device=device)


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
    w = _smooth_weights_on(B, above.device)
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
    (N, n), qcoeff of the best mode (N, n, B_*B_), its eob (N, n), the
    float32 costs (N, n, n_modes)); recon is updated in place.  Waves are
    not padded to a common width (the wave loop is in Python), so every
    lane is a real block and there is nothing for the reference's
    mode="drop" to drop."""
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
            eob_best.reshape(N, n), cost.reshape(N, n, M))


def wave_table(nbr: int, nbc: int):
    """The blocks of an nbr x nbc grid sorted by wave (anti-diagonal r + c,
    rows ascending inside a wave) as indices r * nbc + c, int32 (nblk,),
    and the waves' offsets into it (nbr + nbc entries): wave d is
    order[offsets[d]:offsets[d + 1]].  A block's top, left and top-left
    neighbours lie in earlier waves."""
    r, x = np.divmod(np.arange(nbr * nbc), nbc)
    order = np.lexsort((r, r + x)).astype(np.int32)
    counts = np.bincount(r + x, minlength=nbr + nbc - 1)
    return order, np.concatenate([[0], np.cumsum(counts)]).tolist()


@lru_cache(maxsize=8)
def _wave_table_on(nbr: int, nbc: int, device: torch.device):
    order, offsets = wave_table(nbr, nbc)
    return torch.as_tensor(order, device=device), offsets


@lru_cache(maxsize=None)
def _wave_consts(device: torch.device):
    """(scan, dc mask) of the luma and of the chroma transform, and the
    mode numbers, as tensors on `device`."""
    out = []
    for tx, n in ((c.TX_16X16, 256), (c.TX_8X8, 64)):
        out.append((torch.tensor(tables.scan(tx, c.DCT_DCT),
                                 dtype=torch.int64, device=device),
                    torch.arange(n, device=device) == 0))
    return out[0], out[1], torch.tensor(WAVE_MODES, dtype=torch.int16,
                                        device=device)


def wave_step(rows, ry, ru, rv, src_y, src_u, src_v, order, start: int,
              count: int, pq, lam: float):
    """One wave in torch ops, the signature and results of
    kernels.wave_encode: the blocks order[start:start + count] of every
    frame through _plane_encode plane by plane, recon planes and rows
    written in place, the luma costs (N, count, 7) returned."""
    (scan_y, dc_y), (scan_c, dc_c), modes = _wave_consts(rows.device)
    B, Bc = 16, 8
    nbc = src_y.shape[2] // B
    bid = order[start:start + count].long()
    ys, xs = bid // nbc * B, bid % nbc * B
    _, best, qy, eoby, cost = _plane_encode(
        ry, src_y, ys, xs, B, scan_y, dc_y, pq[0], c.TX_16X16,
        len(WAVE_MODES), lam)
    _, _, qu, eobu, _ = _plane_encode(
        ru, src_u, ys // 2, xs // 2, Bc, scan_c, dc_c, pq[1], c.TX_8X8, 1,
        lam)
    _, _, qv, eobv, _ = _plane_encode(
        rv, src_v, ys // 2, xs // 2, Bc, scan_c, dc_c, pq[2], c.TX_8X8, 1,
        lam)
    row = torch.zeros((rows.shape[0], count, WAVE_ROW), dtype=torch.int16,
                      device=rows.device)
    row[:, :, 0] = modes[best]
    row[:, :, 1:4] = torch.stack([eoby, eobu, eobv], 2).to(torch.int16)
    row[:, :, 6:] = torch.cat([qy, qu, qv], 2).to(torch.int16)
    rows[:, bid] = row
    return cost


class WavefrontEncoder:
    """Whole-frame batched all-intra encode at fixed block size B=16."""

    B = 16

    def __init__(self, qindex: int, lam: float, device=None):
        self.qindex = qindex
        self.lam = lam
        self.device = resolve_device(device)
        self.pq = [Q.build_plane_quant(qindex, 0, 0) for _ in range(3)]

    def encode_frames_raw(self, frame_list):
        """Batched multi-frame encode: the N same-geometry (y, u, v) frames
        of frame_list ride the same waves as a batch axis, one wave_encode
        call per wave for all of them and all three planes.  Returns per
        frame (results dict, res390, recon planes)."""
        dev = self.device
        B = self.B
        with profile("key/waves"):
            src = [torch.as_tensor(
                np.stack([np.asarray(f[pi]) for f in frame_list]),
                device=dev) for pi in range(3)]
            N, H, W = src[0].shape
            assert H % B == 0 and W % B == 0
            nbr, nbc = H // B, W // B
            order, offsets = _wave_table_on(nbr, nbc, dev)
            pq = torch.as_tensor(np.stack([pq_array(p) for p in self.pq]),
                                 device=dev)
            recon = [torch.zeros_like(p) for p in src]
            rows = torch.zeros((N, nbr * nbc, WAVE_ROW), dtype=torch.int16,
                               device=dev)
            for d in range(nbr + nbc - 1):
                wave_encode(rows, *recon, *src, order, offsets[d],
                            offsets[d + 1] - offsets[d], pq, self.lam)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        with profile("key/fetch"):
            from .inter import to_host
            rows = to_host(rows, "key/rows")
            recons = [to_host(p, "key/recon") for p in recon]
        with profile("key/unpack"):
            Bq, Bcq = B * B, B * B // 4
            out = []
            for i in range(N):
                r390 = rows[i]
                modes, eobs, q = r390[:, 0], r390[:, 1:4], r390[:, 6:]
                results = {}
                for b in range(nbr * nbc):
                    results[divmod(b, nbc)] = dict(
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
