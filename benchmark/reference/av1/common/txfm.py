"""Transforms — host bit-exact reference (numpy int32).

Currently: the lossless 4x4 Walsh-Hadamard pair (AV1 spec §7.13.3 inverse;
reference behavior: av1/encoder/hybrid_fwd_txfm.c:24 av1_fwht4x4_c,
av1/common/av1_inv_txfm2d.c:20 av1_highbd_iwht4x4_16_add_c).  The full
DCT/ADST/IDTX family lands with the lossy path.

Coefficient layout note: the reference stores coefficients *transposed*
(column-major: index = col * tx_height + row); our arrays keep natural
(row, col) 2D layout and the bitstream layer does the mapping.
"""

from __future__ import annotations

import numpy as np

UNIT_QUANT_SHIFT = 2


def _wht_stage(a1, b1, c1, d1):
    """One 4-point reversible WHT butterfly (forward direction)."""
    a1 = a1 + b1
    d1 = d1 - c1
    e1 = (a1 - d1) >> 1
    b1 = e1 - b1
    c1 = e1 - c1
    a1 = a1 - c1
    d1 = d1 + b1
    return a1, b1, c1, d1


def fwht4x4(residual: np.ndarray) -> np.ndarray:
    """Forward WHT of a 4x4 int residual; output scaled by 4 (<<2).

    Returns coefficients in the reference's flat layout reshaped (4, 4):
    out.ravel()[i] == reference output[i].  The bitstream layer maps scan
    positions onto this flat order (pos = col * 4 + row convention of the
    coefficient coder).
    """
    x = residual.astype(np.int64)
    interm = np.empty((4, 4), dtype=np.int64)
    for i in range(4):  # pass 1: input column i -> interm row i
        a1, b1, c1, d1 = _wht_stage(x[0, i], x[1, i], x[2, i], x[3, i])
        interm[i] = (a1, c1, d1, b1)
    out = np.empty((4, 4), dtype=np.int64)
    for i in range(4):  # pass 2: interm column i -> out column i
        a1, b1, c1, d1 = _wht_stage(interm[0, i], interm[1, i],
                                    interm[2, i], interm[3, i])
        out[:, i] = (a1, c1, d1, b1)
    return (out << UNIT_QUANT_SHIFT).astype(np.int32)


def iwht4x4(coeff: np.ndarray) -> np.ndarray:
    """Inverse WHT: returns the 4x4 int32 residual to add to prediction.

    `coeff` is the (4, 4)-reshaped flat buffer fwht4x4 produces (also the
    layout the coefficient decoder fills).  Matches
    av1_highbd_iwht4x4_16_add_c minus the clip+add, done by the caller.
    """
    x = (coeff.astype(np.int64) >> UNIT_QUANT_SHIFT).ravel()
    interm = np.empty(16, dtype=np.int64)
    for i in range(4):  # pass 1: reads x[4k+i], writes interm[4k+i]
        a1, c1, d1, b1 = x[i], x[4 + i], x[8 + i], x[12 + i]
        a1 += c1
        d1 -= b1
        e1 = (a1 - d1) >> 1
        b1 = e1 - b1
        c1 = e1 - c1
        a1 -= b1
        d1 += c1
        interm[i], interm[4 + i], interm[8 + i], interm[12 + i] = \
            a1, b1, c1, d1
    out = np.empty((4, 4), dtype=np.int64)
    for i in range(4):  # pass 2: reads interm[4i..4i+3], writes dest col i
        a1, c1, d1, b1 = interm[4 * i:4 * i + 4]
        a1 += c1
        d1 -= b1
        e1 = (a1 - d1) >> 1
        b1 = e1 - b1
        c1 = e1 - c1
        a1 -= b1
        d1 += c1
        out[:, i] = (a1, b1, c1, d1)
    return out.astype(np.int32)
