"""Whole-frame batched P-frame encode and the GF-group chain on torch
tensors.

Port of aom_av1_lavish_tpu/ops/inter_tpu.py: _p_frame_core and
_eval_merge_level (p_frame), _p_chain_fn and DeviceChainEncoder (the GF
group's chain), DeviceInterEncoder (a single P frame outside a chain),
_p_step_fn, prep_ref_state and DeviceRtEncoder (the realtime stream).  Every 16x16 block of a P frame is searched, motion
compensated, transform coded and reconstructed in one batched pass: a
two-scale exhaustive full-pel search (kernel K2, which cuts its windows
from the padded reference plane itself, and K1's fused form for the 3x3
refine of the long-range candidate), half/quarter/eighth-pel refinement
through the 8-tap interpolator (K3, which reads its regions from the
plane), an MV consensus snap, a frame-level interp-filter
pick, residual coding with RD tail dropout (K4), an RD skip decision and
a bottom-up partition merge over {16, 32, 64}.  The program takes a
leading frame axis, as the reference vmaps _p_frame_core: the P frames of
a frame-parallel GF group, each with its own quantizer, lambda and
high-precision-MV flag, ride one pass against shared references, and each
kernel launch covers all of them.  The chain runs the reference's lax.scan
as a loop, one frame a step; each frame's deblocked recon stays on the
device as the next frame's LAST.

Each P-frame entry runs as one device program, as the reference jits it
(_p_chain_fn, _p_frame_fn, _p_step_fn; ops/graphs.DeviceProgram): on the
card a CUDA graph captured once per key and replayed, one enqueue for a
whole GF group; on the CPU the program's plain version (p_chain_plain,
p_frame_plain, p_step_plain), which is the eager function the graph
captures.  Every input a step reads (quantizers, lambdas, high-precision-MV
flags, deblock levels) is a device tensor uploaded once a group, and no
step reads a device value on the host.

Float decisions (RD costs, the rate estimate, the frame filter pick)
keep the reference's float32 dtype and operation order, and candidates
are stacked in its order so that argmin's first-minimum rule picks the
same winner.
"""

from __future__ import annotations

import os
from functools import lru_cache, partial

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..bitstream import constants as c
from ..bitstream import tables
from ..common import coeffs as CF
from ..common import interpred as IP
from ..common import quant as Q

from .deblock import deblock_leafmask
from .graphs import program
from .kernels import (block_ssd_at, convolve_8tap_plane, ssd_surface_plane,
                      stride_windows)
from .txfm import fwd_txfm2d_batched, inv_txfm2d_add_batched
from .wavefront import est_bits, log2_f32, pq_array, quantize

PADR = 64          # device ref padding (>= clamp overshoot + taps)
FULLPEL_RADIUS = 16
MV_COST_W = 16.0   # SSD units per full-pel step of |mv| (rate proxy)
#: frame-filter banks indexed by the header enum (EIGHTTAP_REGULAR=0,
#: EIGHTTAP_SMOOTH=1, MULTITAP_SHARP=2)
FILT_BANKS = np.stack([np.asarray(IP.SUBPEL_FILTERS_8),
                       np.asarray(IP.SUBPEL_FILTERS_8SMOOTH),
                       np.asarray(IP.SUBPEL_FILTERS_8SHARP)]).astype(np.int32)
#: per-leaf mode/MV overhead (bits) for the merge DP, and the split rate
OH16, OH32, OH64 = 8.0, 9.0, 10.0
R_SPLIT = 1.0
#: pixel-SSE per dq^2 of one coefficient, per tx size (TX_8X8..TX_64X64)
_TX_SSE_K = {1: 0.0163, 2: 0.0182, 3: 0.0734, 4: 0.2914}
_INT32_MAX = 2 ** 31 - 1


def rd_lambda(qindex: int) -> np.float32:
    """Frame RD lambda (SSE per bit), matching the host RD paths."""
    qstep = Q.ac_quant_qtx(qindex, 0, 8) / 8.0
    return np.float32(0.12 * qstep * qstep)


def split_recon(rec, H, W):
    """Packed uint8 recon buffer (H + H//2, W), or a (F, H + H//2, W)
    stack of them -> (y, u, v) planes."""
    return rec[..., :H, :], rec[..., H:, :W // 2], rec[..., H:, W // 2:]


class _Tables:
    """Per-device constant tables: scan orders, their inverses, DC masks,
    the filter banks and the full-pel refine's 3x3 offsets (row, column of
    each of its nine candidates), so that no step of a P frame copies from
    the host."""

    def __init__(self, device):
        def t(a, dtype=torch.int64):
            return torch.tensor(np.asarray(a), dtype=dtype, device=device)
        self.scan = {tx: t(tables.scan(tx, c.DCT_DCT))
                     for tx in (c.TX_8X8, c.TX_16X16, c.TX_32X32,
                                c.TX_64X64)}
        self.iscan = {tx: torch.argsort(s) for tx, s in self.scan.items()}
        self.dc = {n: torch.arange(n, device=device) == 0
                   for n in (64, 256, 1024)}
        self.banks = t(FILT_BANKS, torch.int32)
        off = t([-1, 0, 1])
        self.off9_r = off.repeat_interleave(3)
        self.off9_c = off.repeat(3)


@lru_cache(maxsize=None)
def _tables(device: torch.device) -> _Tables:
    return _Tables(device)


def _tx_n(tx):
    """Coefficients per transform block (64x64 keeps its 32x32 corner)."""
    return min(c.TX_WIDTH[tx], 32) * min(c.TX_HEIGHT[tx], 32)


def _mc_block(refp, x0, y0, bw, bh, mv_r_q4, mv_c_q4, fsel=0):
    """Batched single-ref convolve for (bh, bw) blocks at plane coords
    (x0, y0), clamped q4 MVs; refp is PADR-padded -> (B, bh, bw) uint8.
    fsel: the interp filter (FILT_BANKS index) of every block, or a (F,)
    tensor of each frame's, whose blocks are consecutive in B."""
    pos_r = (y0 << 4) + mv_r_q4
    pos_c = (x0 << 4) + mv_c_q4
    banks = _tables(refp.device).banks
    if isinstance(fsel, int):
        kx, ky = banks[fsel][pos_c & 15], banks[fsel][pos_r & 15]
    else:
        sel = _per_block(fsel, pos_r.shape[0] // fsel.shape[0])
        kx, ky = banks[sel, pos_c & 15], banks[sel, pos_r & 15]
    return convolve_8tap_plane(
        refp, (PADR + (pos_r >> 4) - 3).to(torch.int32),
        (PADR + (pos_c >> 4) - 3).to(torch.int32), kx, ky, bh, bw)


def _mc_refs(refs, x0, y0, n, cr, cc, ref, fsel=0):
    """(n, n) predictions from each of 1 or 2 refs; block b takes
    ref[b]'s."""
    preds = [_mc_block(rp, x0, y0, n, n, cr, cc, fsel) for rp in refs]
    if len(preds) == 1:
        return preds[0]
    return torch.where(ref[:, None, None] == 0, preds[0], preds[1])


def _per_block(t, n: int):
    """(F,) per-frame values -> (F*n,): each frame's value for each of its
    n consecutive blocks."""
    return t[:, None].expand(t.shape[0], n).reshape(-1)


def _frame_sums(x, n_frames: int):
    """Each frame's sum of x (its blocks consecutive on the first axis) ->
    (n_frames,), each summed on its own as one frame's x would be, so a
    frame's float32 sum does not depend on the batch around it."""
    x = x.reshape(n_frames, -1)
    return torch.stack([x[f].sum() for f in range(n_frames)])


def _clamp_mv(mv_r, mv_c, bw, bh, ss_x, ss_y, x0l, y0l, fw, fh_, bw4l,
              bh4l):
    """clamp_mv_to_umv_border_sb in q4 plane units (batched)."""
    spel_left_c = (4 + bw) << 4
    spel_right_c = spel_left_c - 16
    spel_left_r = (4 + bh) << 4
    spel_right_r = spel_left_r - 16
    sx = 1 << (1 - ss_x)
    sy = 1 << (1 - ss_y)
    lo_c = (-x0l) * 8 * sx - spel_left_c
    hi_c = (fw - bw4l - x0l) * 8 * sx + spel_right_c
    lo_r = (-y0l) * 8 * sy - spel_left_r
    hi_r = (fh_ - bh4l - y0l) * 8 * sy + spel_right_r
    return ((mv_r * sy).clamp(lo_r, hi_r), (mv_c * sx).clamp(lo_c, hi_c))


def _tiles(p, n, n1, n2):
    """(>= n1*n, >= n2*n) plane, or a (F, h, w) stack -> (F*n1*n2, n, n)
    int32 tiles, frame by frame."""
    return p[..., :n1 * n, :n2 * n].reshape(-1, n1, n, n2, n) \
        .permute(0, 1, 3, 2, 4).reshape(-1, n, n).to(torch.int32)


def _untile(blocks, n1, n2, Hf=None, Wf=None):
    """(F*n1*n2, n, n) blocks -> (F, n1*n, n2*n) planes, zero-padded to
    (Hf, Wf) when given."""
    n = blocks.shape[-1]
    pl = blocks.reshape(-1, n1, n2, n, n).permute(0, 1, 3, 2, 4) \
        .reshape(-1, n1 * n, n2 * n)
    if Hf is None:
        return pl
    return F.pad(pl, (0, Wf - n2 * n, 0, Hf - n1 * n))


def _ssd_sum(a, b):
    d = a.to(torch.float32) - b.to(torch.float32)
    return (d * d).sum((1, 2))


def _argmin2d(cost):
    """(B, H, W) -> (dy_idx, dx_idx, val) of the row-major first minimum."""
    B, _, W = cost.shape
    flat = cost.reshape(B, -1)
    idx = flat.argmin(1)
    return idx // W, idx % W, flat.gather(1, idx[:, None])[:, 0]


def _mv_bias(dy, dx):
    return MV_COST_W * (dy.abs() + dx.abs()).to(torch.float32)


def _pick(cands):
    """cands: [(cost, *values)] -> values of the first-minimum cost."""
    costs = torch.stack([t[0] for t in cands], 1)
    bi = costs.argmin(1)
    ar = torch.arange(costs.shape[0], device=costs.device)
    return [torch.stack([t[k] for t in cands], 1)[ar, bi]
            for k in range(len(cands[0]))]


def _half_res(plane):
    """2x2 sums of a plane (or of each of a stack) -> int32 plane of half
    the size."""
    h2, w2 = plane.shape[-2] // 2, plane.shape[-1] // 2
    return plane[..., :h2 * 2, :w2 * 2].to(torch.int32) \
        .reshape(*plane.shape[:-2], h2, 2, w2, 2).sum((-3, -1)) \
        .to(torch.int32)


def _fullpel_search(src_y, refp_y, refp_y2, y0, x0, nby, nbx, bsz=16):
    """Two-scale exhaustive full-pel search for one reference ->
    (best_dy, best_dx, cost) in full-pel units, range +-32.  src_y is the
    uint8 source plane, or a (F, H, W) stack of them, whose (nby, nbx)
    grid of bsz blocks (origins y0, x0 (nby*nbx,)) is searched; the
    results run over every frame's blocks in turn (F*nby*nbx,)."""
    r = FULLPEL_RADIUS
    S = 2 * r + 1
    dev = src_y.device
    lead = tuple(src_y.shape[:-2])
    # full-res surface: +-16
    ssd0 = ssd_surface_plane(src_y, refp_y, nby, nbx, bsz, r, PADR - r,
                             PADR - r).reshape(-1, S, S)
    ar = torch.arange(S, device=dev) - r
    iy0, ix0, c0 = _argmin2d(ssd0 + _mv_bias(ar[None, :, None],
                                             ar[None, None, :]))
    dy0, dx0 = iy0 - r, ix0 - r
    # half-res surface: +-16 at half res == +-32 full-res (the half-res
    # plane carries PADR//2 of padding)
    iy1, ix1, _ = _argmin2d(ssd_surface_plane(
        _half_res(src_y), refp_y2, nby, nbx, bsz // 2, r, PADR // 2 - r,
        PADR // 2 - r).reshape(-1, S, S))
    dy1, dx1 = (iy1 - r) * 2, (ix1 - r) * 2
    # refine the half-res candidate at full res (3x3): the nine SSDs come
    # from one fused K1 launch; the sums are exact integers below 2^24, so
    # their float32 values are the reference's float sums bit for bit
    tabs = _tables(dev)
    ny = (dy1[:, None] + tabs.off9_r).clamp(-2 * r, 2 * r)
    nx = (dx1[:, None] + tabs.off9_c).clamp(-2 * r, 2 * r)
    grid = lead + (nby * nbx, 9)
    ssd = block_ssd_at(src_y, refp_y,
                       (PADR + y0[:, None] + ny.reshape(grid))
                       .to(torch.int32),
                       (PADR + x0[:, None] + nx.reshape(grid))
                       .to(torch.int32), nby, nbx, bsz).reshape(-1, 9)
    # candidate order decides ties: the full-res winner first, then the
    # neighbourhood row by row
    cost = torch.cat([c0[:, None],
                      ssd.to(torch.float32) + _mv_bias(ny, nx)], 1)
    bi = cost.argmin(1, keepdim=True)
    return (torch.cat([dy0[:, None], ny], 1).gather(1, bi)[:, 0],
            torch.cat([dx0[:, None], nx], 1).gather(1, bi)[:, 0],
            cost.gather(1, bi)[:, 0])


def _subpel_refine(sy_blk, refp_y, y0, x0, bsz, best_dy, best_dx, W, H,
                   take8):
    """Half-pel 3x3, quarter-pel 3x3 and an eighth-pel diamond around the
    full-pel winner through the normative interpolator (regular filter)
    -> (mv_r, mv_c, pred, cost) with 1/8-pel MVs.  The diamond always runs
    and each block takes its pick where take8 ((B,) bool tensor) says so:
    high-precision MVs are legal only in frames that signal
    allow_high_precision_mv, and the reference selects by each frame's
    traced flag."""
    syf = sy_blk.to(torch.float32)

    def eval_mv(mv_r, mv_c):
        cr, cc = _clamp_mv(mv_r, mv_c, bsz, bsz, 0, 0, x0, y0, W, H, bsz,
                           bsz)
        pred = _mc_block(refp_y, x0, y0, bsz, bsz, cr, cc)
        d = pred.to(torch.float32) - syf
        cost = (d * d).sum((1, 2)) + MV_COST_W / 8.0 * (
            mv_r.abs() + mv_c.abs()).to(torch.float32)
        return cost, pred

    mv_r = best_dy * 8
    mv_c = best_dx * 8
    for step in (4, 2):
        cands = []
        for oy in (-step, 0, step):
            for ox in (-step, 0, step):
                cost, pred = eval_mv(mv_r + oy, mv_c + ox)
                cands.append((cost, mv_r + oy, mv_c + ox, pred))
        best_cost, mv_r, mv_c, best_pred = _pick(cands)
    cands = [(best_cost, mv_r, mv_c, best_pred)]
    for (oy, ox) in ((-1, 0), (1, 0), (0, -1), (0, 1)):
        cost, pred = eval_mv(mv_r + oy, mv_c + ox)
        cands.append((cost, mv_r + oy, mv_c + ox, pred))
    picked = _pick(cands)
    best_cost, mv_r, mv_c = (torch.where(take8, a, b) for a, b in
                             zip(picked[:3], (best_cost, mv_r, mv_c)))
    best_pred = torch.where(take8[:, None, None], picked[3], best_pred)
    return mv_r, mv_c, best_pred, best_cost


def _rd_dropout(qc, dqc, scan, inv_scan, lam, tx_size, rbits=1.0):
    """Trellis-lite tail dropout: cut the scan tail where the suffix sum
    of (K*dq^2 - lam*bits) over dropped nonzeros is most negative (lam: a
    scalar, or each block's (B,)).  With AVL_NO_DROPOUT set in the
    environment (read at each call) nothing is dropped."""
    if os.environ.get("AVL_NO_DROPOUT"):
        return qc, dqc
    K = _TX_SSE_K.get(int(tx_size), 0.02)
    qs = qc.index_select(-1, scan)
    ds = dqc.index_select(-1, scan).to(torch.float32)
    n = qs.shape[-1]
    idx = torch.arange(n, device=qc.device)
    nz = qs != 0
    marked = torch.where(nz, idx, -1)
    prev_incl = torch.cummax(marked, dim=-1).values
    prev_excl = torch.cat([torch.full_like(prev_incl[..., :1], -1),
                           prev_incl[..., :-1]], -1)
    gap = (idx - prev_excl - 1).to(torch.float32)
    lvl_bits = 1.7 + 2.0 * log2_f32(qs.abs().to(torch.float32) + 1.0)
    save = torch.where(nz, rbits + lvl_bits + 0.55 * gap, 0.0)
    cost = torch.where(nz, K * ds * ds, 0.0)
    if isinstance(lam, torch.Tensor) and lam.dim():
        lam = lam[:, None]
    net = cost - lam * save
    suffix = net.flip(-1).cumsum(-1).flip(-1)
    best, at = suffix.min(-1, keepdim=True)
    cut = torch.where(best < 0, at, n)
    mask = (idx < cut).index_select(-1, inv_scan)
    return qc * mask, dqc * mask


def _code_residual(src, pred, tx, pq, lam, tabs):
    """Transform, quantize (K4), drop the tail and reconstruct one plane's
    blocks, every frame's in turn, at each frame's quantizer pq (F, 5, 2)
    and each block's lam (B,) -> (qcoeff, eob, recon, bits)."""
    resid = src - pred.to(torch.int32)
    coeff = fwd_txfm2d_batched(resid, tx, c.DCT_DCT)
    q, dq = (t.reshape(coeff.shape) for t in quantize(
        coeff.reshape(pq.shape[0], -1, coeff.shape[-1]), pq,
        CF._tx_scale(tx), tabs.dc[_tx_n(tx)]))
    q, dq = _rd_dropout(q, dq, tabs.scan[tx], tabs.iscan[tx], lam, tx)
    bits, eob = est_bits(q, tabs.scan[tx])
    rec = inv_txfm2d_add_batched(dq, pred, tx, c.DCT_DCT)
    rec = torch.where((eob > 0)[:, None, None], rec, pred)
    return q, eob, rec, bits


def _rd_skip(src_y, pred_y, coded, lam):
    """RD skip trial over one luma + two chroma residual codings: code
    only when the distortion removed beats the estimated bits.
    coded: [(q, eob, rec, bits, src, pred)] for y, u, v; lam (B,) each
    block's.  Returns the kept (q, eob, rec) per plane, the leaf
    distortion and rate."""
    (_, _, rec_y, _, _, _), (_, _, rec_u, _, src_u, pred_u), \
        (_, _, rec_v, _, src_v, pred_v) = coded
    d_code = _ssd_sum(rec_y, src_y) + _ssd_sum(rec_u, src_u) \
        + _ssd_sum(rec_v, src_v)
    d_skip = _ssd_sum(pred_y, src_y) + _ssd_sum(pred_u, src_u) \
        + _ssd_sum(pred_v, src_v)
    r_code = coded[0][3] + coded[1][3] + coded[2][3] + 2.0
    skip = d_skip + lam * 1.0 <= d_code + lam * r_code
    out = [(torch.where(skip[:, None], 0, q), torch.where(skip, 0, eob),
            torch.where(skip[:, None, None], pred, rec))
           for (q, eob, rec, _, _, pred) in coded]
    return (out, torch.where(skip, d_skip, d_code),
            torch.where(skip, 1.0, r_code))


def _eval_merge_level(src_y, src_u, src_v, y0m, x0m, cand_r, cand_c,
                      cand_ref, bsz, refs_y, refs_u, refs_v, W, H, pq_y,
                      pq_u, pq_v, lam, tx_y, tx_uv, fsel, tabs):
    """RD-code one merged partition level (bsz in {32, 64}) for all its
    blocks, every frame's in turn: pick the best MV among the children's
    candidates, motion compensate at bsz under each frame's filter fsel,
    transform-code luma at tx_y and chroma at tx_uv, and apply the RD skip
    trial.  Returns (hdr (Bm, 6), qy, qu, qv (raster), rec_y, rec_u, rec_v,
    d_total, r_total)."""
    csz = bsz >> 1
    syf = src_y.to(torch.float32)
    best = None
    for k in range(cand_r.shape[1]):
        cr, cc = _clamp_mv(cand_r[:, k], cand_c[:, k], bsz, bsz, 0, 0, x0m,
                           y0m, W, H, bsz, bsz)
        pk = _mc_refs(refs_y, x0m, y0m, bsz, cr, cc, cand_ref[:, k], fsel)
        d = pk.to(torch.float32) - syf
        ck = (d * d).sum((1, 2)) + (MV_COST_W / 8.0) * (
            cand_r[:, k].abs() + cand_c[:, k].abs()).to(torch.float32)
        if best is None:
            best = (ck, cand_r[:, k], cand_c[:, k], cand_ref[:, k], pk)
        else:
            lt = ck < best[0]
            best = (torch.where(lt, ck, best[0]),
                    torch.where(lt, cand_r[:, k], best[1]),
                    torch.where(lt, cand_c[:, k], best[2]),
                    torch.where(lt, cand_ref[:, k], best[3]),
                    torch.where(lt[:, None, None], pk, best[4]))
    _, mv_r, mv_c, ref, pred_y = best

    coded = [_code_residual(src_y, pred_y, tx_y, pq_y, lam, tabs)
             + (src_y, pred_y)]
    crc, ccc = _clamp_mv(mv_r, mv_c, csz, csz, 1, 1, x0m, y0m, W, H, bsz,
                         bsz)
    for src_p, refs_p, pq_p in ((src_u, refs_u, pq_u),
                                (src_v, refs_v, pq_v)):
        pred = _mc_refs(refs_p, x0m >> 1, y0m >> 1, csz, crc, ccc, ref,
                        fsel)
        coded.append(_code_residual(src_p, pred, tx_uv, pq_p, lam, tabs)
                     + (src_p, pred))
    out, d_tot, r_tot = _rd_skip(src_y, pred_y, coded, lam)
    (qy, eob_y, rec_y), (qu, eob_u, rec_u), (qv, eob_v, rec_v) = out
    hdr = torch.stack([mv_r, mv_c, ref, eob_y, eob_u, eob_v], 1)
    return hdr, qy, qu, qv, rec_y, rec_u, rec_v, d_tot, r_tot


def _rows(hdr, qy, qu, qv):
    """Result rows in the emitters' layout: [mv_r, mv_c, ref, eob_y,
    eob_u, eob_v] then the y, u, v coefficients in raster order, int16.
    (The reference ships scan-order coefficients and scatters them back
    to raster on the host; the raster rows are what it rebuilds.)"""
    return torch.cat([t.to(torch.int16) for t in (hdr, qy, qu, qv)], 1)


def _qgrid(a, n1, n2):
    """(F, >= 2*n1, >= 2*n2) grids -> (F*n1*n2, 4) 2x2 child groups."""
    return a[..., :2 * n1, :2 * n2].reshape(-1, n1, 2, n2, 2) \
        .permute(0, 1, 3, 2, 4).reshape(-1, 4)


def _merge_candidates(mvr, mvc, ref, n1, n2, n_refs):
    """Children's (MV, ref) candidates plus their lower-median MV and the
    majority ref -> (Bm, 5) each."""
    mr4, mc4, rf4 = (_qgrid(a, n1, n2) for a in (mvr, mvc, ref))
    med_r = mr4.sort(1).values[:, 1]
    med_c = mc4.sort(1).values[:, 1]
    if n_refs == 2:
        maj = (rf4.sum(1) >= 2).to(rf4.dtype)
    else:
        maj = torch.zeros_like(rf4[:, 0])
    return (torch.cat([mr4, med_r[:, None]], 1),
            torch.cat([mc4, med_c[:, None]], 1),
            torch.cat([rf4, maj[:, None]], 1))


def p_frame(src_y, src_u, src_v, refs_y, refs_u, refs_v, refs_y2, pq_y,
            pq_u, pq_v, lam, hp, interp=True, merge=True):
    """Whole-frame P encode of a batch of F frames against shared
    references (the reference's vmap of _p_frame_core over a frame axis:
    every kernel launch covers all F frames), with the {16, 32, 64} merge
    DP (merge=False: fixed 16x16 blocks, r32 and r64 stay empty and lvl
    zero).

    src_*: (F, H, W) uint8 planes (H, W multiples of 16); refs_*: lists of
    1 or 2 PADR-padded reference planes (refs_y2 the half-res luma sums);
    pq_*: (F, 5, 2) int32 quantizer tensors; lam: (F,) float32 tensor; hp:
    (F,) int tensor (or F ints), each frame's allow_high_precision_mv;
    interp: pick each frame's interp filter.  Returns a dict of device
    tensors, each with the frame axis first: r16 (F, B, 390), r32 (F, B32, 1542), r64 (F, B64, 3078)
    int16 rows in the emitters' raster layout, lvl (F, nby, nbx) uint8,
    rec (F, H + H//2, W) uint8, fsel (F,) int64.

    One frame's 2-D planes with (5, 2) pq, a 0-d lam and a 0-d (or int)
    hp give the same results without the frame axis.

    Every decision a frame makes reads only that frame's blocks and
    parameters, and each float sum over a frame is taken on its own, so a
    frame's results do not depend on the batch it rides in."""
    if src_y.dim() == 2:
        out = p_frame(src_y[None], src_u[None], src_v[None], refs_y, refs_u,
                      refs_v, refs_y2, pq_y[None], pq_u[None], pq_v[None],
                      lam.reshape(1),
                      torch.as_tensor(hp, device=src_y.device).reshape(1),
                      interp, merge)
        return {k: v[0] for k, v in out.items()}
    dev = src_y.device
    tabs = _tables(dev)
    nf, H, W = src_y.shape
    n_refs = len(refs_y)
    nby, nbx = H // 16, W // 16
    B = nby * nbx
    N = nf * B                       # every frame's blocks, frame by frame
    by, bx = torch.meshgrid(torch.arange(nby, device=dev),
                            torch.arange(nbx, device=dev), indexing="ij")
    y0f = by.reshape(-1) * 16        # one frame's block origins
    x0f = bx.reshape(-1) * 16
    y0, x0 = y0f.repeat(nf), x0f.repeat(nf)
    lam_b = _per_block(lam, B)
    # each frame's blocks take the eighth-pel diamond's pick by that
    # frame's flag
    take8 = _per_block(torch.as_tensor(hp, device=dev) != 0, B)
    sy_blk = _tiles(src_y, 16, nby, nbx)
    syf32 = sy_blk.to(torch.float32)

    # --- per-ref search ---
    per_ref = []
    for ri in range(n_refs):
        fdy, fdx, _ = _fullpel_search(src_y, refs_y[ri], refs_y2[ri], y0f,
                                      x0f, nby, nbx)
        mv_r, mv_c, pred, _ = _subpel_refine(sy_blk, refs_y[ri], y0, x0,
                                             16, fdy, fdx, W, H, take8)
        per_ref.append((_ssd_sum(pred, sy_blk), mv_r, mv_c, pred))
    # the reference's snap threshold below reads the cost of the LAST
    # searched ref (its loop variable), not the chosen one
    cost = per_ref[-1][0]
    if n_refs == 1:
        best_ref = torch.zeros(N, dtype=torch.int64, device=dev)
        _, mv_r, mv_c, pred_y = per_ref[0]
    else:
        best_ref = torch.stack([t[0] for t in per_ref], 1).argmin(1)
        arN = torch.arange(N, device=dev)
        mv_r = torch.stack([t[1] for t in per_ref], 1)[arN, best_ref]
        mv_c = torch.stack([t[2] for t in per_ref], 1)[arN, best_ref]
        pred_y = torch.where(best_ref[:, None, None] == 0, per_ref[0][3],
                             per_ref[1][3])

    def mc16(cand_r, cand_c, cand_ref, fsel=0):
        cr, cc = _clamp_mv(cand_r, cand_c, 16, 16, 0, 0, x0, y0, W, H, 16,
                           16)
        return _mc_refs(refs_y, x0, y0, 16, cr, cc, cand_ref, fsel)

    # --- (MV, ref) consensus snap: left/top neighbours, each ref's
    # median MV, and zero MV on LAST ---
    snap = []
    for shift in ("left", "top"):
        cand = []
        for g in (mv_r.reshape(nf, nby, nbx), mv_c.reshape(nf, nby, nbx),
                  best_ref.reshape(nf, nby, nbx)):
            if shift == "left":
                g = torch.cat([g[..., :1], g[..., :-1]], -1)
            else:
                g = torch.cat([g[:, :1], g[:, :-1]], 1)
            cand.append(g.reshape(N))
        pc = mc16(*cand)
        snap.append((_ssd_sum(pc, syf32), *cand, pc))

    def masked_median(vals, mask):
        """Each frame's lower median of vals where mask, for its blocks."""
        srt = torch.where(mask, vals, _INT32_MAX).reshape(nf, B) \
            .sort(-1).values
        cnt = mask.reshape(nf, B).sum(-1)
        v = srt.gather(1, (cnt // 2).clamp(0, B - 1)[:, None])[:, 0]
        return _per_block(torch.where(cnt > 0, v, 0), B)

    for ri in range(n_refs):
        msk = best_ref == ri
        mr = masked_median(mv_r, msk)
        mc = masked_median(mv_c, msk)
        rr = torch.full((N,), ri, dtype=best_ref.dtype, device=dev)
        pm = mc16(mr, mc, rr)
        snap.append((_ssd_sum(pm, syf32), mr, mc, rr, pm))
    pz = stride_windows(refs_y[0], PADR, PADR, nby, nbx, 16, 16) \
        .expand(nf, B, 16, 16).reshape(N, 16, 16)
    zero = torch.zeros(N, dtype=torch.int64, device=dev)
    snap.append((_ssd_sum(pz, syf32), zero, zero, zero, pz))
    best_c, snap_r, snap_c, snap_f, snap_p = _pick(snap)
    # ~rate premium of NEWMV over NEAREST/GLOBAL at working q
    adopt = best_c <= cost + lam_b * 14.0
    mv_r = torch.where(adopt, snap_r, mv_r)
    mv_c = torch.where(adopt, snap_c, mv_c)
    best_ref = torch.where(adopt, snap_f, best_ref)
    pred_y = torch.where(adopt[:, None, None], snap_p, pred_y)

    # --- frame-level switchable-filter decision: the final MVs
    # re-predict under each bank and each frame takes its min-SSD one ---
    fsel = 0
    fsel_out = torch.zeros(nf, dtype=torch.int64, device=dev)
    if interp:
        preds_f = [mc16(mv_r, mv_c, best_ref, i) for i in range(3)]
        ssd_f = torch.stack([_frame_sums(
            (pf.to(torch.float32) - syf32) ** 2, nf) for pf in preds_f], 1)
        fsel = fsel_out = ssd_f.argmin(1)                         # (F,)
        pred_y = torch.stack(preds_f)[_per_block(fsel, B),
                                      torch.arange(N, device=dev)]

    # --- final residual coding + RD skip ---
    coded = [_code_residual(sy_blk, pred_y, c.TX_16X16, pq_y, lam_b, tabs)
             + (sy_blk, pred_y)]
    crc, ccc = _clamp_mv(mv_r, mv_c, 8, 8, 1, 1, x0, y0, W, H, 16, 16)
    for src_p, refs_p, pq_p in ((src_u, refs_u, pq_u),
                                (src_v, refs_v, pq_v)):
        sc_blk = _tiles(src_p, 8, nby, nbx)
        pred = _mc_refs(refs_p, x0 >> 1, y0 >> 1, 8, crc, ccc, best_ref,
                        fsel)
        coded.append(_code_residual(sc_blk, pred, c.TX_8X8, pq_p, lam_b,
                                    tabs) + (sc_blk, pred))
    out16, d16f, r16f = _rd_skip(sy_blk, pred_y, coded, lam_b)
    (qy, eob_y, rec_y), (qu, eob_u, rec_u), (qv, eob_v, rec_v) = out16
    r16 = _rows(torch.stack([mv_r, mv_c, best_ref, eob_y, eob_u, eob_v],
                            1), qy, qu, qv)

    # --- bottom-up partition merge DP over {16, 32, 64} squares ---
    nby2, nbx2 = nby // 2, nbx // 2
    nby4, nbx4 = nby2 // 2, nbx2 // 2
    lvl16 = torch.zeros((nf, nby, nbx), dtype=torch.uint8, device=dev)
    rec_y_full = _untile(rec_y, nby, nbx)
    rec_u_full = _untile(rec_u, nby, nbx)
    rec_v_full = _untile(rec_v, nby, nbx)
    r32 = torch.zeros((nf, 0, 1542), dtype=torch.int16, device=dev)
    r64 = torch.zeros((nf, 0, 3078), dtype=torch.int16, device=dev)
    levels = []
    if merge and nby2 > 0 and nbx2 > 0:
        levels.append((32, 1, nby2, nbx2, c.TX_32X32, c.TX_16X16, OH32))
        if nby4 > 0 and nbx4 > 0:
            levels.append((64, 2, nby4, nbx4, c.TX_64X64, c.TX_32X32,
                           OH64))
    child = (mv_r.reshape(nf, nby, nbx), mv_c.reshape(nf, nby, nbx),
             best_ref.reshape(nf, nby, nbx),
             (d16f + lam_b * (r16f + OH16)).reshape(nf, nby, nbx))
    for (bsz, lv, n1, n2, tx_y, tx_uv, oh) in levels:
        cand = _merge_candidates(*child[:3], n1, n2, n_refs)
        g1, g2 = torch.meshgrid(torch.arange(n1, device=dev),
                                torch.arange(n2, device=dev),
                                indexing="ij")
        y0m = (g1.reshape(-1) * bsz).repeat(nf)
        x0m = (g2.reshape(-1) * bsz).repeat(nf)
        lam_m = _per_block(lam, n1 * n2)
        (hdr, qly, qlu, qlv, rly, rlu, rlv, dm, rm) = _eval_merge_level(
            _tiles(src_y, bsz, n1, n2), _tiles(src_u, bsz // 2, n1, n2),
            _tiles(src_v, bsz // 2, n1, n2), y0m, x0m, *cand, bsz,
            refs_y, refs_u, refs_v, W, H, pq_y, pq_u, pq_v, lam_m, tx_y,
            tx_uv, fsel, tabs)
        split = _qgrid(child[3], n1, n2).sum(1) + lam_m * R_SPLIT
        cost_n = dm + lam_m * (rm + oh)
        part = cost_n < split
        rows = _rows(hdr, qly, qlu, qlv).reshape(nf, n1 * n2, -1)
        if bsz == 32:
            r32 = rows
        else:
            r64 = rows
        f = bsz // 16
        m = part.reshape(nf, n1, n2).repeat_interleave(f, 1) \
            .repeat_interleave(f, 2)
        lvl16[:, :n1 * f, :n2 * f] = torch.where(
            m, lv, lvl16[:, :n1 * f, :n2 * f])
        ml = (lvl16 == lv).repeat_interleave(16, 1).repeat_interleave(16, 2)
        mc2 = (lvl16 == lv).repeat_interleave(8, 1).repeat_interleave(8, 2)
        rec_y_full = torch.where(ml, _untile(rly, n1, n2, H, W), rec_y_full)
        rec_u_full = torch.where(mc2, _untile(rlu, n1, n2, H // 2, W // 2),
                                 rec_u_full)
        rec_v_full = torch.where(mc2, _untile(rlv, n1, n2, H // 2, W // 2),
                                 rec_v_full)
        child = (hdr[:, 0].reshape(nf, n1, n2), hdr[:, 1].reshape(nf, n1, n2),
                 hdr[:, 2].reshape(nf, n1, n2),
                 torch.minimum(cost_n, split).reshape(nf, n1, n2))
    rec = torch.cat([rec_y_full, torch.cat([rec_u_full, rec_v_full], -1)],
                    -2).to(torch.uint8)
    return dict(r16=r16.reshape(nf, B, -1), r32=r32, r64=r64, lvl=lvl16,
                rec=rec, fsel=fsel_out)


def _edge_pad(p, n):
    """Edge padding of a 2-D plane by n pixels (clamped indices)."""
    H, W = p.shape
    rows = torch.arange(-n, H + n, device=p.device).clamp(0, H - 1)
    cols = torch.arange(-n, W + n, device=p.device).clamp(0, W - 1)
    return p[rows[:, None], cols[None, :]]


def block_cost_volume(cur, ref, block: int, radius: int):
    """Full-pel SSD surfaces of every (block, block) tile of `cur` against
    `ref` at offsets within +-radius (the reference edge-padded by radius):
    (Hb*Wb, 2r+1, 2r+1) float32.  cur and ref are integer planes of one
    shape whose sides are multiples of block: uint8 as they are, deeper
    samples as int32 (K2's sums wrap past 2^31, i.e. above 10 bits at
    block 16); each entry rounded as the reference's surface rounds
    (kernels.ssd_value_plain).  The motion pass of TPL and of the temporal
    filter; K2's plane form."""
    if cur.dtype != torch.uint8 or ref.dtype != torch.uint8:
        cur, ref = cur.to(torch.int32), ref.to(torch.int32)
    H, W = cur.shape
    return ssd_surface_plane(cur, _edge_pad(ref, radius), H // block,
                             W // block, block, radius, 0, 0)


def pad_ref(y, u, v):
    """Reference prep: PADR edge padding + the half-res luma sums (the
    two-scale search pyramid)."""
    py, pu, pv = (_edge_pad(p, PADR) for p in (y, u, v))
    return py, pu, pv, _half_res(py)


def _leaf_ids(lvl16):
    """Per-16-block coding-leaf id from the partition level map (or from
    each of a (F, nby, nbx) stack of them)."""
    nby, nbx = lvl16.shape[-2:]
    dev = lvl16.device
    rr = torch.arange(nby, device=dev)[:, None]
    cc = torch.arange(nbx, device=dev)[None, :]
    bi = rr * nbx + cc
    id32 = (rr & ~1) * nbx + (cc & ~1)
    id64 = (rr & ~3) * nbx + (cc & ~3)
    return torch.where(lvl16 == 2, id64, torch.where(lvl16 == 1, id32, bi))


def to_device(plane, device):
    """A numpy plane, or a tensor that may already lie on `device`, as a
    contiguous tensor there."""
    if isinstance(plane, torch.Tensor):
        return plane.to(device).contiguous()
    return torch.as_tensor(np.ascontiguousarray(plane), device=device)


def quant_state(qindexes, device):
    """A group's quantizer state on `device`, a frame of it per qindex:
    its quantizer arrays (three (F, 5, 2) int32 tensors, one per plane),
    RD lambdas ((F,) float32) and high-precision-MV flags ((F,) int32),
    each uploaded once."""
    pq = torch.as_tensor(np.stack(
        [pq_array(Q.build_plane_quant(q, 0, 0)) for q in qindexes]),
        device=device)
    return dict(pq=(pq, pq, pq),
                lam=torch.as_tensor(np.asarray(
                    [rd_lambda(q) for q in qindexes], np.float32),
                    device=device),
                hp=torch.as_tensor(np.asarray(
                    [1 if q < 128 else 0 for q in qindexes], np.int32),
                    device=device))


def upload_group(src_frames, ref_frames, qindexes, device):
    """A group's sources and reference frames cropped to the sources'
    16-aligned size and uploaded once (numpy planes, or tensors already on
    `device`), with the group's quantizer state -> (sources as three
    (L, h, w) uint8 stacks, references as (y, u, v) tensors each,
    quant_state of qindexes)."""
    H, W = src_frames[0][0].shape[:2]
    assert H % 16 == 0 and W % 16 == 0
    planes = [tuple(to_device(p, device) for p in _crop(f, H, W))
              for f in (*src_frames, *ref_frames)]
    L = len(src_frames)
    srcs = tuple(torch.stack(p) for p in zip(*planes[:L]))
    return srcs, planes[L:], quant_state(qindexes, device)


def deblock_levels(lf_levels, L, device):
    """Per-frame (y, u, v) deblock levels from an int or a triple per
    frame (None = all 0, unfiltered) -> (L, 3) int64 tensor on device."""
    if lf_levels is None:
        lf_levels = [0] * L
    return torch.as_tensor(np.asarray(
        [tuple(lv) if isinstance(lv, (tuple, list)) else (lv,) * 3
         for lv in lf_levels], np.int64).reshape(L, 3), device=device)


def p_frame_deblocked(src, refs, q, lf, sharpness, interp):
    """A batch of P frames ((F, h, w) planes) over `refs` (pad_ref states
    shared by every frame), each with its leaf-mask deblock at its levels
    lf ((F, 3)) -> (raw dict of device tensors with a leading frame axis:
    r16 r32 r64 lvl filt; deblocked (F, h, w) planes)."""
    H, W = src[0].shape[-2:]
    ry, ru, rv, ry2 = (list(t) for t in zip(*refs))
    out = p_frame(*src, ry, ru, rv, ry2, *q["pq"], q["lam"], q["hp"],
                  interp=interp)
    rec = deblock_leafmask(*split_recon(out["rec"], H, W), *lf.unbind(1),
                           _leaf_ids(out["lvl"]), sharpness=sharpness)
    raw = dict(r16=out["r16"], r32=out["r32"], r64=out["r64"],
               lvl=out["lvl"], filt=out["fsel"])
    return raw, rec


def fetch_group(raws, recs):
    """A group's device results on the host, one entry a frame: each raw
    of raws (p_frame_deblocked's, with a leading frame axis) as one numpy
    dict a frame with `filt` an int, and each of recs (its frames'
    deblocked (F, h, w) planes, or None) as (y, u, v) numpy planes a frame
    (or None)."""
    host, recons = [], []
    for raw, rec in zip(raws, recs):
        arrs = {k: v.cpu().numpy() for k, v in raw.items()}
        planes = None if rec is None else [p.cpu().numpy() for p in rec]
        for f, filt in enumerate(arrs.pop("filt")):
            host.append({k: v[f] for k, v in arrs.items()})
            host[-1]["filt"] = int(filt)
            recons.append(None if planes is None
                          else tuple(p[f] for p in planes))
    return host, recons


#: the results of a P-frame group program, in its output order: the raw
#: rows and level maps, the filter picks, then the deblocked planes
GROUP_RAW = ("r16", "r32", "r64", "lvl", "filt")


def group_outputs(raw, rec):
    """p_frame_deblocked's (raw, rec) as a group program's output tuple."""
    return tuple(raw[k] for k in GROUP_RAW) + tuple(rec)


def group_results(out):
    """A group program's output tuple -> (raw dict, deblocked planes)."""
    return dict(zip(GROUP_RAW, out[:5])), tuple(out[5:])


def p_chain_plain(srcs_y, srcs_u, srcs_v, pq_y, pq_u, pq_v, lam, hp, lf,
                  *refs, sharpness: int = 0, interp: bool = True):
    """The GF group's chain of L P frames, one frame a step as the
    reference's lax.scan runs its body: each frame's deblocked recon,
    padded, is the next frame's LAST.  srcs_*: (L, h, w) uint8; pq_*
    (L, 5, 2), lam (L,), hp (L,), lf (L, 3) each frame's quantizer,
    lambda, high-precision-MV flag and deblock levels; refs: the unpadded
    (y, u, v) planes of LAST and, with two references, of the fixed ARF.
    Returns (r16, r32, r64, lvl, filt, rec_y, rec_u, rec_v), each with the
    frame axis first.  The plain version of _p_chain_fn's program."""
    L = srcs_y.shape[0]
    arf = [pad_ref(*refs[3:6])] if len(refs) == 6 else []
    state = pad_ref(*refs[:3])
    outs = []
    for j in range(L):
        sl = slice(j, j + 1)
        raw, rec = p_frame_deblocked(
            (srcs_y[sl], srcs_u[sl], srcs_v[sl]), [state] + arf,
            dict(pq=(pq_y[sl], pq_u[sl], pq_v[sl]), lam=lam[sl],
                 hp=hp[sl]), lf[sl], sharpness, interp)
        if j + 1 < L:
            state = pad_ref(*(p[0] for p in rec))
        outs.append(group_outputs(raw, rec))
    return tuple(torch.cat(t) for t in zip(*outs))


def _p_chain_fn(key):
    """The GF group's chain as one device program (the reference's
    _p_chain_fn, a jit of lax.scan: ONE device program encodes L
    consecutive P frames, the whole group enqueued once).  key = (H, W,
    n_refs, sharpness, interp, L), the reference's key and the group's
    length, which its jit retraces on.  On CUDA tensors a CUDA graph with
    the L frames unrolled, LAST handed from frame to frame inside it; on
    CPU tensors p_chain_plain.  AVL_NO_DROPOUT is read when the graph is
    captured (the reference reads it when it traces)."""
    _, _, _, sharpness, interp, _ = key
    return program("_p_chain_fn", key, partial(
        p_chain_plain, sharpness=sharpness, interp=interp))


class DeviceChainEncoder:
    """Whole-GF-group batched P-frame encode: L frames chained on the
    device (LAST = the previous frame's deblocked recon, plus an
    optional fixed ARF) as one program (_p_chain_fn), enqueued once, and
    one host copy of each result for the group."""

    def __init__(self, device=None):
        self.device = resolve_device(device)

    def encode_chain(self, src_frames, qindexes, last_planes,
                     arf_planes=None, recon: str = "last",
                     lf_levels=None, sharpness: int = 0,
                     interp_search: bool = True):
        """src_frames: list of L (y, u, v) numpy planes; returns (raws,
        recons) like the reference: raws[j] = dict(r16, r32, r64, lvl,
        filt) host arrays, recons[j] = (y, u, v) uint8 (None except the
        last frame unless recon == "all").

        lf_levels: per-frame (y, u, v) deblock levels applied on the
        device before a recon becomes the next LAST (None = unfiltered);
        the frame headers must signal the same levels."""
        L = len(src_frames)
        refs = [last_planes] + ([arf_planes] if arf_planes is not None
                                else [])
        srcs, refs, q = upload_group(src_frames, refs, qindexes,
                                     self.device)
        H, W = srcs[0].shape[-2:]
        prog = _p_chain_fn((H, W, len(refs), sharpness,
                            bool(interp_search), L))
        raw, rec = group_results(prog(
            *srcs, *q["pq"], q["lam"], q["hp"],
            deblock_levels(lf_levels, L, self.device),
            *(p for r in refs for p in r)))
        if recon == "all":
            return fetch_group([raw], [rec])
        raws, recons = fetch_group([raw], [None])
        recons[-1] = tuple(p[-1].cpu().numpy() for p in rec)
        return raws, recons


def pack_frame_results(res_buf, W):
    """Packed device result buffer (B, 390) int16 -> the per-block dict
    the host emitter (encoder/tpu_inter.py) walks.  Layout per block:
    [mv_r, mv_c, ref, eob_y, eob_u, eob_v, qy*256, qu*64, qv*64]."""
    nbx = W // 16
    res = {}
    for b in range(res_buf.shape[0]):
        r, cc = divmod(b, nbx)
        row = res_buf[b]
        res[(r, cc)] = dict(
            mv=(int(row[0]), int(row[1])), ref_idx=int(row[2]),
            qy=row[6:262], eoby=int(row[3]), qu=row[262:326],
            eobu=int(row[4]), qv=row[326:390], eobv=int(row[5]))
    return res


def _crop(planes, H, W):
    return (planes[0][:H, :W], planes[1][:H >> 1, :W >> 1],
            planes[2][:H >> 1, :W >> 1])


def _frame_quant(qindex: int, device):
    """One frame's quantizer tensors ((5, 2) each), RD lambda (0-d) and
    high-precision-MV flag on `device`."""
    q = quant_state([qindex], device)
    return dict(pq=tuple(p[0] for p in q["pq"]), lam=q["lam"][0],
                hp=q["hp"][0])


def p_frame_plain(src_y, src_u, src_v, pq_y, pq_u, pq_v, lam, hp, *refs,
                  merge: bool = True, interp: bool = False):
    """One P frame outside a chain: (h, w) source planes, (5, 2)
    quantizers, a 0-d lambda and hp, and the unpadded (y, u, v) planes of
    each of 1 or 2 references -> (r16, r32, r64, lvl, rec).  The plain
    version of _p_frame_fn's program."""
    ry, ru, rv, ry2 = (list(t) for t in zip(*(
        pad_ref(*refs[i:i + 3]) for i in range(0, len(refs), 3))))
    out = p_frame(src_y, src_u, src_v, ry, ru, rv, ry2, pq_y, pq_u, pq_v,
                  lam, hp, interp=interp, merge=merge)
    return tuple(out[k] for k in ("r16", "r32", "r64", "lvl", "rec"))


def _p_frame_fn(key):
    """A single P frame as one device program (the reference's
    _p_frame_fn, a jit of _p_frame_core): key = (H, W, n_refs, merge,
    interp).  On CUDA tensors a CUDA graph, on CPU tensors p_frame_plain
    (AVL_NO_DROPOUT read at the capture, as in _p_chain_fn)."""
    _, _, _, merge, interp = key
    return program("_p_frame_fn", key, partial(p_frame_plain, merge=merge,
                                               interp=interp))


class DeviceInterEncoder:
    """Whole-frame batched P-frame encode of one frame outside a chain,
    over one or two reference frames, with the {16, 32, 64} merge DP and
    the regular interp filter, as one program (_p_frame_fn); the caller
    deblocks."""

    def __init__(self, qindex: int, device=None):
        self.qindex = qindex
        self.device = resolve_device(device)
        self._q = _frame_quant(qindex, self.device)

    def encode_frame(self, src_planes, ref_planes_list):
        """src_planes: mi-aligned (y, u, v); ref_planes_list: list of
        visible (y, u, v) reference frames (1 or 2).  Returns dict of
        per-block results + recon (16x16-leaf view; merged levels are
        in self.res_raw)."""
        raw = self.encode_frame_raw(src_planes, ref_planes_list)
        return pack_frame_results(raw["r16"], src_planes[0].shape[1])

    def encode_frame_raw(self, src_planes, ref_planes_list):
        """Like encode_frame but returns the raw result dict (r16 / r32 /
        r64 raster buffers + the lvl partition map) that the emitters
        consume directly."""
        H, W = src_planes[0].shape[:2]
        assert H % 16 == 0 and W % 16 == 0
        dev = self.device
        src = [to_device(p, dev) for p in _crop(src_planes, H, W)]
        refs = [to_device(p, dev) for rp in ref_planes_list for p in rp[:3]]
        q = self._q
        out = _p_frame_fn((H, W, len(ref_planes_list), True, False))(
            *src, *q["pq"], q["lam"], q["hp"], *refs)
        self.recon = split_recon(out[4].cpu().numpy(), H, W)
        self.res_raw = {k: v.cpu().numpy() for k, v in
                        zip(("r16", "r32", "r64", "lvl"), out)}
        return self.res_raw


def prep_ref_state(planes, device):
    """Upload + pad a host reconstruction into the device-resident
    (ly, lu, lv, ly2) reference state (keyframe bootstrap)."""
    H, W = planes[0].shape[:2]
    return pad_ref(*(to_device(p, device) for p in _crop(planes, H, W)))


def p_step_plain(sy, su, sv, ly, lu, lv, ly2, pq_y, pq_u, pq_v, lam, hp):
    """Streaming single-ref P step: encode one frame on fixed 16x16
    blocks (no merge DP, regular filter, no deblock) against the padded
    reference state and produce the next one -> (r16 (B, 390) int16, rec
    (H + H//2, W) uint8, and the next state's ly, lu, lv, ly2).  The plain
    version of _p_step_fn's program."""
    H, W = sy.shape
    out = p_frame(sy, su, sv, [ly], [lu], [lv], [ly2], pq_y, pq_u, pq_v,
                  lam, hp, interp=False, merge=False)
    rec = out["rec"]
    return (out["r16"], rec, *pad_ref(*split_recon(rec, H, W)))


def _p_step_fn(key):
    """The realtime step as one device program (the reference's
    _p_step_fn): key = (H, W).  On CUDA tensors a CUDA graph, on CPU
    tensors p_step_plain."""
    return program("_p_step_fn", key, p_step_plain)


def p_step(src, state, q):
    """p_step_plain through _p_step_fn: the reference never leaves the
    device between frames -> (r16, rec, next state).  On the card these
    are the program's output tensors, which its next step of the same
    geometry overwrites."""
    H, W = src[0].shape
    out = _p_step_fn((H, W))(*src, *state, *q["pq"], q["lam"], q["hp"])
    return out[0], out[1], tuple(out[2:])


class DeviceRtEncoder:
    """Streaming P-frame encoder with device-resident reference state:
    per frame, upload the source, run one device step and copy only the
    result rows back.  Reconstruction stays on the device (deblocking
    off); fetch it explicitly via `fetch_recon` if needed."""

    def __init__(self, qindex: int, device=None):
        self.qindex = qindex
        self.device = resolve_device(device)
        self._q = _frame_quant(qindex, self.device)
        self.state = None      # (ly, lu, lv, ly2) device tensors
        self._rec_d = None

    def reset_ref(self, planes):
        self.state = prep_ref_state(planes, self.device)
        self._rec_d = None

    def encode_frame_async(self, src_planes):
        """Enqueue one frame's device step and the copy of its result
        rows; returns a handle for `realize()`.  The next frame may be
        enqueued at once (its reference is the device-resident state),
        overlapping this frame's copy with that compute: on the card the
        rows go to pinned host memory without blocking and an event marks
        the copy's end."""
        H, W = src_planes[0].shape[:2]
        src = [to_device(p, self.device) for p in _crop(src_planes, H, W)]
        r16, rec, state = p_step(src, self.state, self._q)
        # the next step overwrites the program's outputs: keep copies
        self._rec_d = rec.clone()
        self.state = tuple(t.clone() for t in state)
        if r16.device.type != "cuda":
            return r16, None
        host = torch.empty(r16.shape, dtype=r16.dtype, pin_memory=True)
        host.copy_(r16, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    @staticmethod
    def realize(handle):
        """The (B, 390) int16 rows of a frame, once its copy is done."""
        rows, done = handle
        if done is not None:
            done.synchronize()
        return rows.numpy()

    def encode_frame(self, src_planes):
        return self.realize(self.encode_frame_async(src_planes))

    def fetch_recon(self, H, W):
        return split_recon(self._rec_d.cpu().numpy(), H, W)
