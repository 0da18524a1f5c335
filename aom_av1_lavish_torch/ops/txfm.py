"""Batched integer 2-D transforms on torch tensors, bit-exact with the
host engine (common/txfm2d.py) and with aom_av1_lavish_tpu/ops/txfm_jax.py.

Port of txfm_jax: the stage tables of common/txfm1d.py run as batched
gather + arithmetic, each stage out[i] = f(in[src0[i]], in[src1[i]]) with
per-element weights.  The reference splits the butterfly products into
16-bit halves because int64 is emulated on a TPU; here the products are
taken in native int64, which gives the same floor-shifted result.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..bitstream import constants as c
from ..common import txfm1d as T1
from ..common import txfm2d as T2

K_COPY, K_ADDSUB, K_BTF = T1.K_COPY, T1.K_ADDSUB, T1.K_BTF


def _mul2_shift(a, w0, b, w1, shift: int):
    """floor((a*w0 + b*w1 + 2^(shift-1)) >> shift), exact in int64."""
    v = a.to(torch.int64) * w0 + b.to(torch.int64) * w1 + (1 << (shift - 1))
    return (v >> shift).to(torch.int32)


def _mul_shift(a, w: int, shift: int):
    """floor((a*w + 2^(shift-1)) >> shift), exact in int64."""
    v = a.to(torch.int64) * w + (1 << (shift - 1))
    return (v >> shift).to(torch.int32)


_STAGE_FNS = {("dct", False): T1.fdct_stages, ("adst", False):
              T1.fadst_stages, ("dct", True): T1.idct_stages,
              ("adst", True): T1.iadst_stages}


@lru_cache(maxsize=None)
def _stages(kind: str, n: int, cos_bit: int, inverse: bool,
            device: torch.device):
    """One 1-D transform's stage tables as tensors on `device`:
    [(src0, src1, w0, w1, is_btf, is_addsub)] per stage."""
    out = []
    for stage in _STAGE_FNS[(kind, inverse)](n, cos_bit):
        a = np.asarray(stage, np.int64).reshape(-1, 5)
        t = lambda x, dt: torch.as_tensor(x, dtype=dt,  # noqa: E731
                                          device=device)
        out.append((t(a[:, 1], torch.int64), t(a[:, 2], torch.int64),
                    t(a[:, 3], torch.int32), t(a[:, 4], torch.int32),
                    t(a[:, 0] == K_BTF, torch.bool),
                    t(a[:, 0] == K_ADDSUB, torch.bool)))
    return out


def _run_stages(x, stages, cos_bit: int, clamp_bits: int):
    """x: (..., N) int -> (..., N) int32 through the stage tables."""
    buf = x.to(torch.int32)
    for (s0, s1, w0, w1, is_btf, is_addsub) in stages:
        a = buf.index_select(-1, s0)
        b = buf.index_select(-1, s1)
        btf = _mul2_shift(a, w0, b, w1, cos_bit)
        # addsub/copy weights are +-1: plain int32 arithmetic
        lin = a * w0 + b * w1
        if clamp_bits < 32:
            lo = -(1 << (clamp_bits - 1))
            addsub = lin.clamp(lo, -lo - 1)
        else:  # forward path: no stage clamping
            addsub = lin
        buf = torch.where(is_btf, btf, torch.where(is_addsub, addsub,
                                                   a * w0))
    return buf


def _adst4(x, cos_bit: int, inverse: bool):
    """av1_fadst4_c / av1_iadst4_c (their products are int32 in C too)."""
    sp = [int(v) for v in T1.sinpi_arr(cos_bit)]
    x = x.to(torch.int32)
    x0, x1, x2, x3 = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
    if inverse:
        s0, s1, s2 = sp[1] * x0, sp[2] * x0, sp[3] * x1
        s3, s4 = sp[4] * x2, sp[1] * x2
        s5, s6 = sp[2] * x3, sp[4] * x3
        s7 = (x0 - x2) + x3
        s0 = s0 + s3
        s1 = s1 - s4
        s3 = s2
        s2 = sp[3] * s7
        s0 = s0 + s5
        s1 = s1 - s6
        o = (s0 + s3, s1 + s3, s2, (s0 + s1) - s3)
    else:
        s0, s1, s2, s3 = sp[1] * x0, sp[4] * x0, sp[2] * x1, sp[1] * x1
        s4, s5, s6 = sp[3] * x2, sp[4] * x3, sp[2] * x3
        s7 = (x0 + x1) - x3
        t0 = s0 + s2 + s5
        t1 = sp[3] * s7
        t2 = s1 - s3 + s6
        o = (t0 + s4, t1, t2 - s4, (t2 - t0) + s4)
    half = 1 << (cos_bit - 1)
    return torch.stack([(v + half) >> cos_bit for v in o], -1)


def _identity(x, n: int):
    x = x.to(torch.int32)
    if n == 4:
        return _mul_shift(x, T1.NEW_SQRT2, T1.NEW_SQRT2_BITS)
    if n == 8:
        return x * 2
    if n == 16:
        return _mul_shift(x, T1.NEW_SQRT2 * 2, T1.NEW_SQRT2_BITS)
    return x * 4


def _tx1d(x, kind: str, n: int, cos_bit: int, inverse: bool,
          clamp_bits: int):
    if kind == "identity":
        return _identity(x, n)
    if kind == "adst" and n == 4:
        return _adst4(x, cos_bit, inverse)
    return _run_stages(x, _stages(kind, n, cos_bit, inverse, x.device),
                       cos_bit, clamp_bits)


def _round_shift(x, bit: int):
    if bit == 0:
        return x
    if bit > 0:
        return (x + (1 << (bit - 1))) >> bit
    return x << -bit


def fwd_txfm2d_batched(resid, tx_size: int, tx_type: int):
    """resid: (B, h, w) int -> (B, aw*ah) int32 flat coefficients,
    bit-exact with common/txfm2d.fwd_txfm2d."""
    h, w = c.TX_HEIGHT[tx_size], c.TX_WIDTH[tx_size]
    txw_idx = w.bit_length() - 3
    txh_idx = h.bit_length() - 3
    cb_col = T2._FWD_COS_BIT_COL[txw_idx][txh_idx]
    cb_row = T2._FWD_COS_BIT_ROW[txw_idx][txh_idx]
    s0, s1, s2 = T2.FWD_SHIFT[tx_size]
    vk, hk = T2.VTX[tx_type], T2.HTX[tx_type]
    x = resid.to(torch.int32)
    if T2._flip(vk):
        x = x.flip(1)
    colsin = _round_shift(x.transpose(-1, -2), -s0)          # (B, w, h)
    cols = _tx1d(colsin, T2._kind(vk), h, cb_col, False, 64)
    cols = _round_shift(cols, -s1)
    buf = cols.transpose(-1, -2)                              # (B, h, w)
    if T2._flip(hk):
        buf = buf.flip(2)
    rows = _tx1d(buf, T2._kind(hk), w, cb_row, False, 64)
    rows = _round_shift(rows, -s2)
    if abs(T2._rect_log_ratio(w, h)) == 1:
        rows = _mul_shift(rows, T1.NEW_SQRT2, T1.NEW_SQRT2_BITS)
    full = rows.transpose(-1, -2)                             # (B, w, h)
    aw, ah = min(w, 32), min(h, 32)
    return full[:, :aw, :ah].reshape(full.shape[0], aw * ah).to(torch.int32)


def inv_txfm2d_add_batched(coeff_flat, pred, tx_size: int, tx_type: int,
                           bd: int = 8):
    """coeff_flat: (B, aw*ah) dequantized; pred (B, h, w) uint8 -> recon
    (B, h, w) uint8, bit-exact with common/txfm2d.inv_txfm2d_add."""
    h, w = c.TX_HEIGHT[tx_size], c.TX_WIDTH[tx_size]
    s0, s1 = T2.INV_SHIFT[tx_size]
    vk, hk = T2.VTX[tx_type], T2.HTX[tx_type]
    opt_row = 16 if bd == 8 else (18 if bd == 10 else 20)
    opt_col = 16 if bd == 8 else (16 if bd == 10 else 18)
    aw, ah = min(w, 32), min(h, 32)
    B = coeff_flat.shape[0]
    adj = coeff_flat.to(torch.int32).reshape(B, aw, ah)
    if (aw, ah) != (w, h):
        full = torch.zeros((B, w, h), dtype=torch.int32, device=adj.device)
        full[:, :aw, :ah] = adj
    else:
        full = adj
    x = full.transpose(-1, -2)                                # (B, h, w)
    if abs(T2._rect_log_ratio(w, h)) == 1:
        x = _mul_shift(x, T1.NEW_INV_SQRT2, T1.NEW_SQRT2_BITS)
    lo = -(1 << (bd + 7))
    x = x.clamp(lo, -lo - 1)
    rows = _tx1d(x, T2._kind(hk), w, T1.INV_COS_BIT, True, opt_row)
    rows = _round_shift(rows, -s0)
    if T2._flip(hk):
        rows = rows.flip(2)
    colsin = rows.transpose(-1, -2)
    lo2 = -(1 << (max(bd + 6, 16) - 1))
    colsin = colsin.clamp(lo2, -lo2 - 1)
    cols = _tx1d(colsin, T2._kind(vk), h, T1.INV_COS_BIT, True, opt_col)
    cols = _round_shift(cols, -s1)
    res = cols.transpose(-1, -2)
    if T2._flip(vk):
        res = res.flip(1)
    out = pred.to(torch.int32) + res
    return out.clamp(0, (1 << bd) - 1).to(torch.uint8)
