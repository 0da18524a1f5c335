"""AV1 2D transforms: forward (encoder) and inverse+add (normative).

Reference behavior: av1/encoder/av1_fwd_txfm2d.c fwd_txfm2d_c and
av1/common/av1_inv_txfm2d.c inv_txfm2d_add_c.  Layout contract: the
coefficient buffer is column-major over (row, col) — flat index
pos = col * tx_height + row — matching the coefficient coder
(common/coeffs.py) and the reference's transposed storage.

Input `resid` and output recon use natural (row, col) 2D arrays.
"""

from __future__ import annotations

import numpy as np

from ..bitstream import constants as c
from . import txfm1d as T1


# per-tx-size fwd shifts (av1_fwd_txfm2d.c:314) keyed by TX_*; [s0, s1, s2]
FWD_SHIFT = {
    c.TX_4X4: (2, 0, 0), c.TX_8X8: (2, -1, 0), c.TX_16X16: (2, -2, 0),
    c.TX_32X32: (2, -4, 0), c.TX_64X64: (0, -2, -2), c.TX_4X8: (2, -1, 0),
    c.TX_8X4: (2, -1, 0), c.TX_8X16: (2, -2, 0), c.TX_16X8: (2, -2, 0),
    c.TX_16X32: (2, -4, 0), c.TX_32X16: (2, -4, 0), c.TX_32X64: (0, -2, -2),
    c.TX_64X32: (2, -4, -2), c.TX_4X16: (2, -1, 0), c.TX_16X4: (2, -1, 0),
    c.TX_8X32: (2, -2, 0), c.TX_32X8: (2, -2, 0), c.TX_16X64: (0, -2, 0),
    c.TX_64X16: (2, -4, 0),
}

# inverse shifts (av1_inv_txfm2d.c:132)
INV_SHIFT = {
    c.TX_4X4: (0, -4), c.TX_8X8: (-1, -4), c.TX_16X16: (-2, -4),
    c.TX_32X32: (-2, -4), c.TX_64X64: (-2, -4), c.TX_4X8: (0, -4),
    c.TX_8X4: (0, -4), c.TX_8X16: (-1, -4), c.TX_16X8: (-1, -4),
    c.TX_16X32: (-1, -4), c.TX_32X16: (-1, -4), c.TX_32X64: (-1, -4),
    c.TX_64X32: (-1, -4), c.TX_4X16: (-1, -4), c.TX_16X4: (-1, -4),
    c.TX_8X32: (-2, -4), c.TX_32X8: (-2, -4), c.TX_16X64: (-2, -4),
    c.TX_64X16: (-2, -4),
}

# fwd cos bits by (txw_idx, txh_idx) (av1_fwd_txfm2d.c:342,350)
_FWD_COS_BIT_COL = [
    [13, 13, 13, 0, 0], [13, 13, 13, 12, 0], [13, 13, 13, 12, 13],
    [0, 13, 13, 12, 13], [0, 0, 13, 12, 13]]
_FWD_COS_BIT_ROW = [
    [13, 13, 12, 0, 0], [13, 13, 13, 12, 0], [13, 13, 12, 13, 12],
    [0, 12, 13, 12, 11], [0, 0, 12, 11, 10]]

# vertical / horizontal 1D type per 2D tx_type (av1_txfm.h vtx_tab/htx_tab);
# 0=DCT 1=ADST 2=FLIPADST 3=IDTX
VTX = [0, 1, 0, 1, 2, 0, 2, 1, 2, 3, 0, 3, 1, 3, 2, 3]
HTX = [0, 0, 1, 1, 0, 2, 2, 2, 1, 3, 3, 0, 3, 1, 3, 2]


def _kind(tx1d: int) -> str:
    return ("dct", "adst", "adst", "identity")[tx1d]


def _flip(tx1d: int) -> bool:
    return tx1d == 2


def _round_shift_array(x: np.ndarray, bit: int) -> np.ndarray:
    """av1_round_shift_array: bit>0 rounds down; bit<0 multiplies up."""
    if bit == 0:
        return x
    if bit > 0:
        return (x + (1 << (bit - 1))) >> bit
    return x << -bit


def _rect_log_ratio(w: int, h: int) -> int:
    if w == h:
        return 0
    r = (w // h) if w > h else (h // w)
    return {2: 1, 4: 2}[r]


def fwd_txfm2d(resid: np.ndarray, tx_size: int, tx_type: int,
               bd: int = 8) -> np.ndarray:
    """Residual (h, w) int -> flat coefficient array (col-major, len w*h)."""
    h, w = c.TX_HEIGHT[tx_size], c.TX_WIDTH[tx_size]
    assert resid.shape == (h, w)
    txw_idx = w.bit_length() - 3
    txh_idx = h.bit_length() - 3
    cb_col = _FWD_COS_BIT_COL[txw_idx][txh_idx]
    cb_row = _FWD_COS_BIT_ROW[txw_idx][txh_idx]
    s0, s1, s2 = FWD_SHIFT[tx_size]
    vk, hk = VTX[tx_type], HTX[tx_type]

    x = resid.astype(np.int64)
    if _flip(vk):  # ud_flip
        x = x[::-1, :]
    # columns: transform down each column => operate on x.T rows
    colsin = _round_shift_array(x.T, -s0)          # (w, h)
    cols = T1.fwd_txfm1d(colsin, _kind(vk), h, cb_col)
    cols = _round_shift_array(cols, -s1)
    buf = cols.T                                   # (h, w): row r of buf
    if _flip(hk):  # lr_flip
        buf = buf[:, ::-1]
    rows = T1.fwd_txfm1d(buf, _kind(hk), w, cb_row)
    rows = _round_shift_array(rows, -s2)
    if abs(_rect_log_ratio(w, h)) == 1:
        rows = (rows * T1.NEW_SQRT2 + (1 << (T1.NEW_SQRT2_BITS - 1))) >> \
            T1.NEW_SQRT2_BITS
    # output[c * h + r] = rows[r, c]; 64-dim sizes truncate + repack to the
    # visible 32 coeffs per axis (av1_fwd_txfm2d.c 64x* facades)
    full = np.ascontiguousarray(rows.T)  # (w, h)
    aw, ah = min(w, 32), min(h, 32)
    return np.ascontiguousarray(full[:aw, :ah]).reshape(-1).astype(np.int32)


def _clamp_bits(x: np.ndarray, bits: int) -> np.ndarray:
    lo = -(1 << (bits - 1))
    hi = (1 << (bits - 1)) - 1
    return np.clip(x, lo, hi)


def inv_txfm2d_add(coeff_flat: np.ndarray, recon_block: np.ndarray,
                   tx_size: int, tx_type: int, bd: int = 8) -> np.ndarray:
    """Normative inverse transform + add (spec §7.13.3).

    coeff_flat: col-major flat dequantized coefficients (w*h; for 64-wide
    dims only the visible 32 are nonzero and the flat array covers the
    full size).  recon_block: (h, w) uint8 prediction; returns recon.
    """
    h, w = c.TX_HEIGHT[tx_size], c.TX_WIDTH[tx_size]
    s0, s1 = INV_SHIFT[tx_size]
    vk, hk = VTX[tx_type], HTX[tx_type]
    rect = _rect_log_ratio(w, h)
    opt_range_row = 16 if bd == 8 else (18 if bd == 10 else 20)
    opt_range_col = 16 if bd == 8 else (16 if bd == 10 else 18)
    aw, ah = min(w, 32), min(h, 32)

    if (aw, ah) != (w, h):
        # 64-dim transforms carry only 32 visible coeffs per axis
        # (av1_inv_txfm2d.c mod_input remap)
        full = np.zeros((w, h), dtype=np.int64)
        adj = coeff_flat.astype(np.int64).reshape(aw, ah)
        full[:aw, :ah] = adj
        x = full.T
    else:
        x = coeff_flat.astype(np.int64).reshape(w, h).T  # (h, w) natural
    # rows
    if abs(rect) == 1:
        x = (x * T1.NEW_INV_SQRT2 + (1 << (T1.NEW_SQRT2_BITS - 1))) >> \
            T1.NEW_SQRT2_BITS
    x = _clamp_bits(x, bd + 8)
    rows = T1.inv_txfm1d(x, _kind(hk), w, [opt_range_row] * 14,
                         T1.INV_COS_BIT)
    rows = _round_shift_array(rows, -s0)
    # columns
    if _flip(hk):
        rows = rows[:, ::-1]
    colsin = _clamp_bits(rows.T, max(bd + 6, 16))  # (w, h)
    cols = T1.inv_txfm1d(colsin, _kind(vk), h, [opt_range_col] * 14,
                         T1.INV_COS_BIT)
    cols = _round_shift_array(cols, -s1)
    res = cols.T  # (h, w)
    if _flip(vk):
        res = res[::-1, :]
    out = recon_block.astype(np.int64) + res
    return np.clip(out, 0, (1 << bd) - 1).astype(
        np.uint8 if bd == 8 else np.uint16)
