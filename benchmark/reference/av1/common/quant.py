"""Quantization (encoder side) + dequant values.

Behavioral port of the reference quantizer pipeline
(av1/encoder/av1_quantize.c:602 av1_build_quantizer,
aom_dsp/quantize.c:108 aom_quantize_b_helper_c).  Only the dequant side is
normative; the quantize side is matched for rate/quality parity.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from ..bitstream import tables



def dc_quant_qtx(qindex: int, delta: int, bd: int = 8) -> int:
    q = max(0, min(255, qindex + delta))
    row = {8: 0, 10: 1, 12: 2}[bd]
    return int(tables.get("dc_quant_qtx")[row][q])


def ac_quant_qtx(qindex: int, delta: int, bd: int = 8) -> int:
    q = max(0, min(255, qindex + delta))
    row = {8: 0, 10: 1, 12: 2}[bd]
    return int(tables.get("ac_quant_qtx")[row][q])


def _invert_quant(d: int):
    t = d
    length = 0
    while t > 1:
        t >>= 1
        length += 1
    m = 1 + (1 << (16 + length)) // d
    quant = m - (1 << 16)
    shift = 1 << (16 - length)
    return quant, shift


@dataclass(frozen=True)
class PlaneQuant:
    zbin: tuple      # (dc, ac)
    round: tuple
    quant: tuple
    quant_shift: tuple
    dequant: tuple


@lru_cache(maxsize=None)
def build_plane_quant(qindex: int, dc_delta: int, ac_delta: int,
                      bd: int = 8, sharpness: int = 0) -> PlaneQuant:
    dcq = dc_quant_qtx(0, 0, bd)  # for qzbin factor rule, q=qindex's table
    base_dc = dc_quant_qtx(qindex, 0, bd)
    thresholds = {8: 148, 10: 592, 12: 2368}[bd]
    qzbin_factor = 64 if qindex == 0 else (84 if base_dc < thresholds else 80)
    qrounding_factor = 64 if qindex == 0 else 48
    if sharpness > 0 and qindex > 0:
        adj = 16 * (7 - sharpness) // 7
        qzbin_factor = 64 + adj
        qrounding_factor = 64 - adj
    elif sharpness < 0 and qindex > 0:
        adj = 16 * (7 + sharpness) // 7
        qzbin_factor = 64 - adj
        qrounding_factor = 64 + adj
    zbin = []
    rnd = []
    quant = []
    qshift = []
    deq = []
    for i in range(2):
        if i == 0:
            qtx = dc_quant_qtx(qindex, dc_delta, bd)
        else:
            qtx = ac_quant_qtx(qindex, ac_delta, bd)
        q_, s_ = _invert_quant(qtx)
        quant.append(q_)
        qshift.append(s_)
        zbin.append((qzbin_factor * qtx + 64) >> 7)
        rnd.append((qrounding_factor * qtx) >> 7)
        deq.append(qtx)
    return PlaneQuant(tuple(zbin), tuple(rnd), tuple(quant), tuple(qshift),
                      tuple(deq))


@lru_cache(maxsize=None)
def tx_gain(tx_size: int, tx_type: int) -> float:
    """Empirical energy gain ||fwd(r)||^2 / ||r||^2 of the integer
    transform — converts coefficient-domain SSE to pixel-domain SSE for
    RD decisions (the reference's block-error shift discipline,
    av1/encoder/rdopt_utils.h get_tx_scale usage, measured rather than
    derived so rect/identity scalings stay exact)."""
    from . import txfm2d as T2
    rng = np.random.default_rng(1234)
    from ..bitstream import constants as c
    h, w = c.TX_HEIGHT[tx_size], c.TX_WIDTH[tx_size]
    num = 0.0
    den = 0.0
    for _ in range(4):
        r = rng.integers(-96, 96, (h, w)).astype(np.int32)
        coeff = T2.fwd_txfm2d(r, tx_size, tx_type)
        num += float((coeff.astype(np.int64) ** 2).sum())
        den += float((r.astype(np.int64) ** 2).sum())
    return num / den


def optimize_txb(qcoeff: np.ndarray, dqcoeff: np.ndarray,
                 coeff_flat: np.ndarray, scan: np.ndarray,
                 pq: PlaneQuant, log_scale: int, eob: int,
                 lam_pix: float, gain: float):
    """Trellis-style coefficient optimization (av1_optimize_txb analog,
    av1/encoder/txb_rdopt.c:296).

    Two passes, both against the same level-rate model the block RD
    search uses (_est_txb_bits), so decisions compose:
      1. vectorized per-coefficient level drop: for every scan position
         before the last, keep q or lower |q| by one (including 1 -> 0,
         which turns a coded level into a run zero) by coefficient-domain
         RD;
      2. eob trim: repeatedly zero the final nonzero coefficient when
         the eob move + level bits saved beat the added distortion.
    Returns (qcoeff, dqcoeff, eob) mutated in place."""
    if eob <= 0:
        return qcoeff, dqcoeff, eob
    lam = lam_pix * gain          # SSE-per-bit in coefficient domain
    sc = scan[:eob].astype(np.int64)
    aq = np.abs(qcoeff[sc]).astype(np.int64)
    av = np.abs(coeff_flat[sc]).astype(np.int64)
    deq = np.where(sc == 0, pq.dequant[0], pq.dequant[1]).astype(np.int64)

    def dq_of(levels):
        return (levels * deq) >> log_scale

    def level_bits(levels):
        return np.where(levels > 0,
                        1.7 + 2.0 * np.log2(levels + 1.0), 0.55)

    err_cur = (av - dq_of(aq)).astype(np.float64) ** 2
    low = np.maximum(aq - 1, 0)
    err_low = (av - dq_of(low)).astype(np.float64) ** 2
    better = (err_low + lam * level_bits(low)
              < err_cur + lam * level_bits(aq))
    # last coded position can only shrink via the eob-trim pass (a 1 -> 0
    # there moves the eob, which pass 1's independent model can't price)
    better &= aq > 0
    if aq[eob - 1] <= 1:
        better[eob - 1] = False
    aq = np.where(better, low, aq)

    # pass 2: trim trailing levels while RD favors the shorter eob
    eob_bits = lambda e: 2.0 + 0.9 * np.log2(e + 1.0) if e else 0.6
    nz = np.flatnonzero(aq)
    while nz.size:
        si = int(nz[-1])
        prev = int(nz[-2]) if nz.size > 1 else -1
        new_eob = prev + 1
        # dropping level at si: its error becomes |c|^2; saved bits =
        # its level bits + run zeros between prev nonzero and si + the
        # eob length change
        d_dist = float(av[si] ** 2) - float((av[si] - dq_of(aq)[si]) ** 2)
        d_bits = (float(level_bits(aq[[si]])[0]) + 0.55 * (si - new_eob)
                  + eob_bits(si + 1) - eob_bits(new_eob))
        if d_dist < lam * d_bits:
            aq[si] = 0
            nz = nz[:-1]
        else:
            break
    new_eob = int(nz[-1]) + 1 if nz.size else 0

    sign = np.where(qcoeff[sc] < 0, -1, 1).astype(np.int64)
    qcoeff[sc] = (aq * sign).astype(qcoeff.dtype)
    dqcoeff[sc] = (dq_of(aq) * sign).astype(dqcoeff.dtype)
    if new_eob < eob:
        tail = scan[new_eob:eob].astype(np.int64)
        qcoeff[tail] = 0
        dqcoeff[tail] = 0
    return qcoeff, dqcoeff, new_eob


def quantize_b(coeff_flat: np.ndarray, scan: np.ndarray, pq: PlaneQuant,
               log_scale: int, qm=None, iqm=None):
    """Returns (qcoeff, dqcoeff, eob).  coeff_flat is col-major flat.
    qm/iqm: optional flat weight / inverse-weight matrices (AOM_QM_BITS
    fixed point, quantize_b_helper_c qm_ptr/iqm_ptr semantics)."""
    n = len(scan)
    qcoeff = np.zeros_like(coeff_flat)
    dqcoeff = np.zeros_like(coeff_flat)
    zbins = [(pq.zbin[0] + (1 << log_scale >> 1)) >> log_scale,
             (pq.zbin[1] + (1 << log_scale >> 1)) >> log_scale] \
        if log_scale else list(pq.zbin)
    QMB = 5  # AOM_QM_BITS
    # pre-scan: trailing sub-zbin coeffs are skippable
    non_zero_count = n
    for si in range(n - 1, -1, -1):
        rc = int(scan[si])
        wt = int(qm[rc]) if qm is not None else (1 << QMB)
        v = int(coeff_flat[rc]) * wt
        if -(zbins[rc != 0] << QMB) < v < (zbins[rc != 0] << QMB):
            non_zero_count -= 1
        else:
            break
    eob = -1
    for si in range(non_zero_count):
        rc = int(scan[si])
        v = int(coeff_flat[rc])
        abs_v = abs(v)
        wt = int(qm[rc]) if qm is not None else (1 << QMB)
        if abs_v * wt >= (zbins[rc != 0] << QMB):
            rnd = (pq.round[rc != 0] + (1 << log_scale >> 1)) >> log_scale \
                if log_scale else pq.round[rc != 0]
            tmp = min(max(abs_v + rnd, -32768), 32767) * wt
            tmp32 = ((((tmp * pq.quant[rc != 0]) >> 16) + tmp)
                     * pq.quant_shift[rc != 0]) >> (16 - log_scale + QMB)
            q = tmp32 if v >= 0 else -tmp32
            qcoeff[rc] = q
            iwt = int(iqm[rc]) if iqm is not None else (1 << QMB)
            deq = (pq.dequant[rc != 0] * iwt + (1 << (QMB - 1))) >> QMB
            dq = (tmp32 * deq) >> log_scale
            dqcoeff[rc] = dq if v >= 0 else -dq
            if tmp32:
                eob = si
    return qcoeff, dqcoeff, eob + 1


# --- quantizer matrices (av1/common/quant_common.c wt/iwt_matrix_ref) -----

_QM_DATA = None


def _qm_data():
    global _QM_DATA
    if _QM_DATA is None:
        import os
        _QM_DATA = np.load(os.path.join(
            os.path.dirname(__file__), "..", "..", "data",
            "qm_tables.npz"))
    return _QM_DATA


@lru_cache(maxsize=None)
def _qm_adjusted(tx_size: int) -> int:
    from . import coeffs as CF
    return CF.adjusted_tx_size(tx_size)


@lru_cache(maxsize=None)
def iqm_table(level: int, plane_class: int, tx_size: int) -> np.ndarray:
    """Inverse (dequant-side) weight matrix, flat over the adjusted tx
    block (av1_iqmatrix).  level 0..14; 15 means flat (caller skips)."""
    t = _qm_adjusted(tx_size)
    return _qm_data()[f"iqm_{level}_{plane_class}_{t}"]


@lru_cache(maxsize=None)
def qm_table(level: int, plane_class: int, tx_size: int) -> np.ndarray:
    """Forward (quant-side) weight matrix (av1_qmatrix)."""
    t = _qm_adjusted(tx_size)
    return _qm_data()[f"qm_{level}_{plane_class}_{t}"]
