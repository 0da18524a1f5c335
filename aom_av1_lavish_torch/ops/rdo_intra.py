"""Device-batched intra RD trials: the encoder hot loop as tensor ops.

Port of aom_av1_lavish_tpu/ops/rdo_intra.py.  Recast of the quality
all-intra mode/partition search (reference hot loop av1_rd_pick_partition,
av1/encoder/partition_search.c:5310 + av1_rd_pick_intra_mode_sb,
av1/encoder/rdopt.c:3296).  Instead of the reference's recursive
recon-in-the-loop recursion, every candidate block of every size runs its
full mode trial sweep as one batched device computation:

    edges (from SOURCE pixels) -> 61-mode prediction as an edge-matrix
    product -> batched integer fwd txfm -> quantize (kernel K4) ->
    token-rate estimate -> exact inverse + SSE -> RD cost

The per-(block,mode) cost tensors feed a bottom-up partition DP on the
host (encoder/tpu_rdo.py).  The one deliberate approximation vs the host
search: trial predictions use *source* neighbours rather than recon
neighbours (recon edges would serialize the search, which is the whole
point of the reference's recursion).  The final encode of each chosen
leaf recomputes prediction/transform/quant exactly against real recon, so
conformance is unaffected; only the *decisions* differ slightly.

Everything except PAETH is linear in the edge pixels, so prediction for
60 of the 61 modes is a single (N, L) x (L, M*h*w) matmul with integer
weights over a common denominator of 512 — exact after one floor-divide.
The product runs in float32 with TF32 off (the package turns it off): its
sums are integers below 255 * 512, so the result is exact in any order.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..bitstream import constants as c
from ..bitstream import tables
from ..common import blockd
from ..common import coeffs as CF
from ..common import intra as I
from ..common import quant as Q
from ..utils.profiler import profile
from . import txfm as TX
from .wavefront import est_bits, pq_array, quantize

MAX_ANGLE_DELTA = 3
DEN = 512  # common weight denominator

#: directional base modes in trial order
DIR_MODES = (c.V_PRED, c.H_PRED, c.D45_PRED, c.D135_PRED, c.D113_PRED,
             c.D157_PRED, c.D203_PRED, c.D67_PRED)


def trial_mode_list(min_bsize_px: int = 8):
    """(mode, angle_delta) trial list: DC/SMOOTH family + every
    directional mode at every angle delta.  PAETH is appended by the
    engine (nonlinear, computed separately)."""
    out = [(c.DC_PRED, 0), (c.SMOOTH_PRED, 0), (c.SMOOTH_V_PRED, 0),
           (c.SMOOTH_H_PRED, 0)]
    for m in DIR_MODES:
        for d in range(-MAX_ANGLE_DELTA, MAX_ANGLE_DELTA + 1):
            out.append((m, d))
    return out


# --------------------------------------------------------------------------
# edge-weight matrix construction (host, per block geometry)
#
# Edge vector layout for a (bw, bh) block, length L = 2*(bw+bh) + 3:
#   E[0]                    top-left sample
#   E[1 : bw+bh+2]          above row, samples 0 .. bw+bh   (z1 reach)
#   E[bw+bh+2 : 2*bw+2*bh+3] left col, samples 0 .. bw+bh   (z3 reach)
# --------------------------------------------------------------------------

def _edge_len(bw, bh):
    return 2 * (bw + bh) + 3


def _above_idx(bw, bh, k):
    return 1 + k


def _left_idx(bw, bh, k):
    return bw + bh + 2 + k


def _dir_weights(bw, bh, angle):
    """Integer weight matrix (L, bh*bw) * DEN for one directional angle
    (dr_prediction z1/z2/z3, reconintra.c; no edge filter / upsample in
    the trial pass)."""
    L = _edge_len(bw, bh)
    G = np.zeros((L, bh * bw), np.int32)
    scale = DEN // 32  # dir predictors are (.. + 16) >> 5

    def put(eidx, r, cc, w):
        G[eidx, r * bw + cc] += w * scale

    if angle == 90:                                  # exact V_PRED
        for r in range(bh):
            for cc in range(bw):
                G[_above_idx(bw, bh, cc), r * bw + cc] = DEN
        return G
    if angle == 180:                                 # exact H_PRED
        for r in range(bh):
            for cc in range(bw):
                G[_left_idx(bw, bh, r), r * bw + cc] = DEN
        return G
    if angle < 90:                                   # zone 1: above only
        dx = I.get_dx(angle)
        max_base_x = bw + bh - 1
        for r in range(bh):
            x = (r + 1) * dx
            base0 = x >> 6
            shift = (x & 0x3F) >> 1
            for cc in range(bw):
                base = base0 + cc
                if base < max_base_x:
                    put(_above_idx(bw, bh, base), r, cc, 32 - shift)
                    put(_above_idx(bw, bh, base + 1), r, cc, shift)
                else:
                    put(_above_idx(bw, bh, max_base_x), r, cc, 32)
    elif angle > 180:                                # zone 3: left only
        dy = I.get_dy(angle)
        max_base_y = bw + bh - 1
        for cc in range(bw):
            y = (cc + 1) * dy
            base0 = y >> 6
            shift = (y & 0x3F) >> 1
            for r in range(bh):
                base = base0 + r
                if base < max_base_y:
                    put(_left_idx(bw, bh, base), r, cc, 32 - shift)
                    put(_left_idx(bw, bh, base + 1), r, cc, shift)
                else:
                    put(_left_idx(bw, bh, max_base_y), r, cc, 32)
    else:                                            # zone 2: both
        dx = I.get_dx(angle)
        dy = I.get_dy(angle)
        for r in range(bh):
            for cc in range(bw):
                x = (cc << 6) - (r + 1) * dx
                base_x = x >> 6
                if base_x >= -1:
                    sx = (x & 0x3F) >> 1
                    # above_data index -1 == top-left
                    i0 = 0 if base_x == -1 else _above_idx(bw, bh, base_x)
                    i1 = _above_idx(bw, bh, base_x + 1)
                    put(i0, r, cc, 32 - sx)
                    put(i1, r, cc, sx)
                else:
                    y = (r << 6) - (cc + 1) * dy
                    base_y = y >> 6
                    sy = (y & 0x3F) >> 1
                    i0 = 0 if base_y == -1 else _left_idx(bw, bh, base_y)
                    i1 = _left_idx(bw, bh, base_y + 1)
                    put(i0, r, cc, 32 - sy)
                    put(i1, r, cc, sy)
    return G


def _smooth_weights(bw, bh, kind):
    L = _edge_len(bw, bh)
    G = np.zeros((L, bh * bw), np.int32)
    ww = np.array(I.SMOOTH_WEIGHTS[bw], np.int32)
    wh = np.array(I.SMOOTH_WEIGHTS[bh], np.int32)
    for r in range(bh):
        for cc in range(bw):
            p = r * bw + cc
            if kind == "smooth":                     # (.. + 256) >> 9
                G[_above_idx(bw, bh, cc), p] += wh[r]
                G[_left_idx(bw, bh, bh - 1), p] += 256 - wh[r]
                G[_left_idx(bw, bh, r), p] += ww[cc]
                G[_above_idx(bw, bh, bw - 1), p] += 256 - ww[cc]
            elif kind == "smooth_v":                 # (.. + 128) >> 8
                G[_above_idx(bw, bh, cc), p] += wh[r] * 2
                G[_left_idx(bw, bh, bh - 1), p] += (256 - wh[r]) * 2
            else:                                    # smooth_h
                G[_left_idx(bw, bh, r), p] += ww[cc] * 2
                G[_above_idx(bw, bh, bw - 1), p] += (256 - ww[cc]) * 2
    return G


def mode_matrix(bw: int, bh: int):
    """Stacked weight tensor (M_lin, L, bh*bw) float32 for the linear
    trial modes (trial_mode_list order, DC excluded -> index 0 is
    SMOOTH).  DC is exact-divided on the device from edge sums.  Not cached
    here: the engine keeps the one copy it needs, on its device."""
    mats = []
    for (m, d) in trial_mode_list():
        if m == c.DC_PRED:
            continue
        if m == c.SMOOTH_PRED:
            mats.append(_smooth_weights(bw, bh, "smooth"))
        elif m == c.SMOOTH_V_PRED:
            mats.append(_smooth_weights(bw, bh, "smooth_v"))
        elif m == c.SMOOTH_H_PRED:
            mats.append(_smooth_weights(bw, bh, "smooth_h"))
        else:
            angle = I.MODE_TO_ANGLE[m] + d * I.ANGLE_STEP
            mats.append(_dir_weights(bw, bh, angle))
    return np.stack(mats).astype(np.float32)


def _dc(E, bw, bh, have_top, have_left):
    """Exact DC predictor values (N,) int32 (reconintra.c dc variants:
    both-edge true divide, single-edge shifts, 128 base)."""
    reach = bw + bh + 1
    s_a = E[:, 1:1 + bw].to(torch.int32).sum(-1, dtype=torch.int32)
    s_l = E[:, 1 + reach:1 + reach + bh].to(torch.int32) \
        .sum(-1, dtype=torch.int32)
    dc_both = torch.div(s_a + s_l + ((bw + bh) >> 1), bw + bh,
                        rounding_mode="floor")
    dc_top = (s_a + (bw >> 1)) >> (bw.bit_length() - 1)
    dc_left = (s_l + (bh >> 1)) >> (bh.bit_length() - 1)
    return torch.where(have_top & have_left, dc_both,
                       torch.where(have_top, dc_top,
                                   torch.where(have_left, dc_left, 128)))


# --------------------------------------------------------------------------
# device trial engine
# --------------------------------------------------------------------------

def _gather_edges(srcp, bw, bh, nbr, nbc):
    """Edge vectors for the regular (nbr, nbc) grid of (bw, bh) blocks
    over padded plane srcp (H+1+reach rows, W+1+reach cols with the
    block grid starting at (1, 1)).  Returns (N, L) int32."""
    reach = bw + bh + 1
    rows = np.arange(nbr) * bh + 1
    cols = np.arange(nbc) * bw + 1
    # top-left
    tl = srcp[rows - 1][:, cols - 1]                        # (nbr, nbc)
    # above run: srcp[r-1, c : c+reach]
    above = np.stack([srcp[r - 1, :] for r in rows])        # (nbr, W')
    above = np.stack([above[:, cc:cc + reach] for cc in cols], 1)
    # left run: srcp[r : r+reach, c-1]
    leftc = np.stack([srcp[:, cc - 1] for cc in cols], 1)   # (H', nbc)
    left = np.stack([leftc[r:r + reach, :] for r in rows], 0)
    left = np.moveaxis(left, -1, 1)                         # (nbr,nbc,reach)
    E = np.concatenate([tl[..., None], above, left], axis=-1)
    return E.reshape(nbr * nbc, -1).astype(np.int32)


def _fill_edges_np(E, bw, bh, have_top, have_left):
    """Spec fill rules for unavailable edges (reconintra.c:1309
    defaults: 127/129/128), applied on host before device upload."""
    reach = bw + bh + 1
    tl = E[:, 0]
    above = E[:, 1:1 + reach]
    left = E[:, 1 + reach:]
    first_l = left[:, 0]
    first_a = above[:, 0]
    above = np.where(have_top[:, None], above,
                     np.where(have_left[:, None], first_l[:, None], 127))
    left = np.where(have_left[:, None], left,
                    np.where(have_top[:, None], first_a[:, None], 129))
    tl = np.where(have_top & have_left, tl,
                  np.where(have_top, first_a,
                           np.where(have_left, first_l, 128)))
    return np.concatenate([tl[:, None], above, left], axis=-1)


class _Geometry:
    """Per-(device, bw, bh) constants of the trial sweep: transform size,
    scan order, DC mask and, for the full sweep, the linear modes' weight
    matrix laid out (L, M_lin * bh*bw) for one matmul."""

    def __init__(self, device, bw, bh):
        self.bw, self.bh = bw, bh
        self.tx_size = blockd.tx_size_of(min(bw, 64), min(bh, 64))
        aw, ah = min(bw, 32), min(bh, 32)
        self.scan = torch.tensor(
            np.asarray(tables.scan(CF.adjusted_tx_size(self.tx_size),
                                   c.DCT_DCT)),
            dtype=torch.int64, device=device)
        self.dc_mask = torch.arange(aw * ah, device=device) == 0
        self.log_scale = CF._tx_scale(self.tx_size)
        self.device = device
        self._G = None

    @property
    def G(self):
        if self._G is None:
            g = mode_matrix(self.bw, self.bh)                # (M, L, P)
            M, L, P = g.shape
            self._G = torch.as_tensor(
                np.ascontiguousarray(g.transpose(1, 0, 2)).reshape(L, M * P),
                device=self.device)
        return self._G


#: (device, bw, bh) -> _Geometry.  The 64x64 weight matrix is 59 * 259 *
#: 4096 floats (about 250 MB) and the eleven geometries of a frame about
#: 0.6 GB, so each is built and uploaded once per device and process.
_GEOMETRY_CACHE: dict = {}


def _geometry(device, bw, bh) -> _Geometry:
    key = (device, bw, bh)
    geom = _GEOMETRY_CACHE.get(key)
    if geom is None:
        geom = _GEOMETRY_CACHE[key] = _Geometry(device, bw, bh)
    return geom


def predict_trial_modes(E, have_top, have_left, geom: _Geometry):
    """Predictions of every trial mode from filled edge vectors: E (N, L)
    int32 -> (N, 61, bh*bw) int32 in trial_modes_full order (DC, the 59
    linear modes, PAETH)."""
    bw, bh = geom.bw, geom.bh
    reach = bw + bh + 1
    N = E.shape[0]
    # linear modes: one big matmul
    acc = (E.to(torch.float32) @ geom.G).reshape(N, -1, bh * bw)
    pred_lin = torch.floor((acc + (DEN // 2)) * (1.0 / DEN)).to(torch.int32)
    # DC: exact divide (rect blocks need a true divide)
    dc = _dc(E, bw, bh, have_top, have_left)[:, None].expand(N, bh * bw)
    # PAETH (nonlinear)
    a = E[:, 1:1 + bw].to(torch.int32)                       # (N, bw)
    lf = E[:, 1 + reach:1 + reach + bh].to(torch.int32)
    tl = E[:, 0].to(torch.int32)[:, None, None]
    base = a[:, None, :] + lf[:, :, None] - tl
    pl = (base - lf[:, :, None]).abs()
    pt = (base - a[:, None, :]).abs()
    ptl = (base - tl).abs()
    paeth = torch.where(
        (pl <= pt) & (pl <= ptl), lf[:, :, None].expand(base.shape),
        torch.where(pt <= ptl, a[:, None, :].expand(base.shape),
                    tl.expand(base.shape)))
    return torch.cat([dc[:, None], pred_lin,
                      paeth.reshape(N, 1, bh * bw)], 1)


def _trial_costs(preds, blks, lam, pq, geom: _Geometry):
    """RD cost of coding each block under each prediction: preds (N, M,
    bh*bw) int32, blks (N, bh, bw) uint8, lam (N,) float32 -> (N, M)
    float32 sse + lam * bits."""
    bw, bh = geom.bw, geom.bh
    N, M = preds.shape[:2]
    src = blks.reshape(N, 1, bh * bw).to(torch.int32)
    resid = src - preds
    coeff = TX.fwd_txfm2d_batched(resid.reshape(-1, bh, bw), geom.tx_size,
                                  c.DCT_DCT)
    qcoeff, dqcoeff = quantize(coeff, pq, geom.log_scale, geom.dc_mask)
    bits, eob = est_bits(qcoeff, geom.scan)
    pred_u8 = preds.reshape(-1, bh, bw).clamp(0, 255).to(torch.uint8)
    recon = TX.inv_txfm2d_add_batched(dqcoeff, pred_u8, geom.tx_size,
                                      c.DCT_DCT)
    recon = torch.where((eob > 0)[:, None, None], recon, pred_u8)
    d = src - recon.reshape(N, M, bh * bw).to(torch.int32)
    sse = (d * d).sum(-1).to(torch.float32)
    return sse + lam[:, None] * bits.reshape(N, M)


def trial_sweep(E, blks, have_top, have_left, lam, pq, geom: _Geometry):
    """The full trial sweep for one block geometry (the reference's
    _trial_fn): (N, 61) float32 costs."""
    return _trial_costs(predict_trial_modes(E, have_top, have_left, geom),
                        blks, lam, pq, geom)


def trial_sweep_dc(E, blks, have_top, have_left, lam, pq, geom: _Geometry):
    """DC-only trial (chroma cost grids for the partition DP; the
    reference's _trial_fn_dc): (N, 1) float32 costs."""
    N = E.shape[0]
    dc = _dc(E, geom.bw, geom.bh, have_top, have_left)
    preds = dc[:, None, None].expand(N, 1, geom.bh * geom.bw)
    return _trial_costs(preds, blks, lam, pq, geom)


class IntraTrialEngine:
    """Per-frame device trial sweep over a set of block geometries, on
    `device`: the card when None, and an error when there is none.

    trial_plane() returns, for each geometry, float32 (nbr, nbc, M)
    cost tensors where cost = sse + lam * bits (no mode-signalling
    terms — the host DP adds those)."""

    CHUNK = 4096  # blocks per device dispatch (memory bound at 32x32+)

    def __init__(self, qindex: int, bd: int = 8, device=None):
        self.qindex = qindex
        self.bd = bd
        self.device = resolve_device(device)
        self.pq = Q.build_plane_quant(qindex, 0, 0, bd=bd)
        self._pq_t = torch.as_tensor(pq_array(self.pq), device=self.device)

    def trial_plane(self, srcp: np.ndarray, sizes, lam_of,
                    dc_only: bool = False):
        """srcp: padded (H, W) uint8 plane, H/W multiples of the block
        dims.  sizes: iterable of (bw, bh).  lam_of(py, px, bh, bw) ->
        float.  Returns {(bw, bh): (sse+lam*bits) float32 (nbr, nbc, M)}
        (M == 1 when dc_only)."""
        with profile("rdo/prepare"):
            prepared = self.prepare(srcp, sizes, lam_of)
        with profile("rdo/sweep"):
            return self.sweep(prepared, dc_only)

    def prepare(self, srcp: np.ndarray, sizes, lam_of) -> list:
        """Host side of trial_plane: per geometry the filled edge vectors,
        source blocks, availability flags and lambdas of the block grid,
        uploaded -> [((bw, bh), nbr, nbc, device tensors)]."""
        dev = self.device
        H, W = srcp.shape
        out = []
        for (bw, bh) in sizes:
            nbr, nbc = H // bh, W // bw
            reach = bw + bh + 1
            sp = np.pad(srcp, ((1, 0), (1, 0)), mode="edge")
            sp = np.pad(sp, ((0, reach), (0, reach)), mode="edge")
            E = _gather_edges(sp, bw, bh, nbr, nbc)
            ys = np.repeat(np.arange(nbr) * bh, nbc)
            xs = np.tile(np.arange(nbc) * bw, nbr)
            have_top = ys > 0
            have_left = xs > 0
            E = _fill_edges_np(E, bw, bh, have_top, have_left)
            blks = srcp.reshape(nbr, bh, nbc, bw).swapaxes(1, 2) \
                .reshape(-1, bh, bw).astype(np.uint8)
            lam = np.array([lam_of(y, x, bh, bw) for y, x in zip(ys, xs)],
                           np.float32)
            out.append(((bw, bh), nbr, nbc, tuple(
                torch.as_tensor(np.ascontiguousarray(a), device=dev)
                for a in (E.astype(np.int32), blks, have_top, have_left,
                          lam))))
        return out

    def sweep(self, prepared: list, dc_only: bool = False) -> dict:
        """Device side of trial_plane: every geometry's chunks are
        enqueued before the first result is read back."""
        fn = trial_sweep_dc if dc_only else trial_sweep
        pend = []
        for (bw, bh), nbr, nbc, tensors in prepared:
            geom = _geometry(self.device, bw, bh)
            N = tensors[0].shape[0]
            # memory-bound chunking: ~1M block-pixels x 61 modes per
            # dispatch ((chunk*M*bh*bw) integer intermediates)
            chunk = min(N, max(32, self.CHUNK * 256 // (bw * bh)))
            rows = [fn(*(t[s:s + chunk] for t in tensors), self._pq_t, geom)
                    for s in range(0, N, chunk)]
            pend.append(((bw, bh), nbr, nbc, torch.cat(rows)))
        return {key: cost.cpu().numpy().reshape(nbr, nbc, -1)
                for key, nbr, nbc, cost in pend}


def trial_modes_full():
    """Full trial mode axis: DC + linear modes + PAETH (engine order)."""
    lst = trial_mode_list()
    dc = [(c.DC_PRED, 0)]
    lin = [x for x in lst if x[0] != c.DC_PRED]
    return dc + lin + [(c.PAETH_PRED, 0)]
