"""Coefficient (de)coding: contexts + symbol sequencing.

Normative AV1 coefficient syntax (spec §5.11.39, §8.3.2; reference behavior:
av1/decoder/decodetxb.c:110 av1_read_coeffs_txb, av1/common/txb_common.h
context derivation).  The same context functions drive the encoder's
tokenizer, so they live here plane-agnostic and side-agnostic.

Layout convention: coefficient position `pos` (from the scan tables) is
interpreted with bhl = log2(tx height): col = pos >> bhl, row = pos & (h-1)
— i.e. the flat coefficient buffer is column-major over the (row, col)
transform grid, matching the reference's transposed storage.
"""

from __future__ import annotations

import numpy as np

from ..bitstream import constants as c
from ..bitstream import tables

TX_CLASS_2D = 0
TX_CLASS_HORIZ = 1
TX_CLASS_VERT = 2


TX_TYPE_TO_CLASS = [TX_CLASS_2D] * 10 + [
    TX_CLASS_VERT, TX_CLASS_HORIZ, TX_CLASS_VERT, TX_CLASS_HORIZ,
    TX_CLASS_VERT, TX_CLASS_HORIZ]

EOB_GROUP_START = [0, 1, 2, 3, 5, 9, 17, 33, 65, 129, 257, 513]
EOB_OFFSET_BITS = [0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9]

COEFF_CONTEXT_BITS = 6
COEFF_CONTEXT_MASK = (1 << COEFF_CONTEXT_BITS) - 1
NUM_BASE_LEVELS = 2
MAX_BASE_BR_RANGE = 15
BR_CDF_SIZE = 4
COEFF_BASE_RANGE = 12


def adjusted_tx_size(tx_size: int) -> int:
    """64-wide transforms keep only 32 visible coeffs (av1_get_adjusted_tx_size)."""
    m = {c.TX_64X64: c.TX_32X32, c.TX_64X32: c.TX_32X32,
         c.TX_32X64: c.TX_32X32, c.TX_64X16: c.TX_32X16,
         c.TX_16X64: c.TX_16X32}
    return m.get(tx_size, tx_size)


def txsize_entropy_ctx(tx_size: int) -> int:
    """(sqr + sqr_up + 1) >> 1 (entropy.h:173 get_txsize_entropy_ctx):
    64-dim transforms land in class 4 even though their visible coeff
    domain is 32x32."""
    return (c.TX_SIZE_SQR[tx_size] + c.TX_SIZE_SQR_UP[tx_size] + 1) >> 1


def eob_multi_size(tx_size: int) -> int:
    adj = adjusted_tx_size(tx_size)
    return (c.TX_WIDTH[adj] * c.TX_HEIGHT[adj]).bit_length() - 1 - 4


def nz_map_ctx_offset(tx_size: int, row: int, col: int) -> int:
    """2D-class base context offset (txb_common.h:199 generator rule).

    The rect-asymmetry rule uses the RAW tx dims (so TX_32X64 keeps its
    width<height bias even though positions live in the adjusted 32x32
    domain); row/col are the col-major coords within the adjusted domain.
    """
    width = c.TX_WIDTH[tx_size]
    height = c.TX_HEIGHT[tx_size]
    if width < height and row < 2:
        return 11
    if width > height and col < 2:
        return 16
    if row + col < 2:
        return 1
    if row + col < 4:
        return 6
    return 21


_NZ_CTX_OFFSET_1D = [26, 31] + [36] * 30


class LevelsBuf:
    """Quantized-level magnitudes with bottom/right zero padding."""

    def __init__(self, width: int, height: int):
        self.w = width
        self.h = height
        self.a = np.zeros((height + 4, width + 4), dtype=np.int32)

    def get(self, row: int, col: int) -> int:
        return int(self.a[row, col])

    def set(self, row: int, col: int, v: int) -> None:
        self.a[row, col] = v


def pos_rc(pos: int, bhl: int) -> tuple:
    col = pos >> bhl
    row = pos - (col << bhl)
    return row, col


def base_ctx(levels: LevelsBuf, pos: int, bhl: int, tx_size: int,
             tx_class: int) -> int:
    """get_lower_levels_ctx: context for coeff_base of a non-eob coeff."""
    row, col = pos_rc(pos, bhl)
    a = levels.a
    if tx_class == TX_CLASS_2D:
        if pos == 0:
            return 0
        mag = (min(a[row + 1, col], 3) + min(a[row, col + 1], 3)
               + min(a[row + 1, col + 1], 3) + min(a[row + 2, col], 3)
               + min(a[row, col + 2], 3))
        ctx = min((mag + 1) >> 1, 4)
        return ctx + nz_map_ctx_offset(tx_size, row, col)
    if tx_class == TX_CLASS_VERT:
        mag = (min(a[row + 1, col], 3) + min(a[row, col + 1], 3)
               + min(a[row + 2, col], 3) + min(a[row + 3, col], 3)
               + min(a[row + 4, col], 3))
    else:
        mag = (min(a[row + 1, col], 3) + min(a[row, col + 1], 3)
               + min(a[row, col + 2], 3) + min(a[row, col + 3], 3)
               + min(a[row, col + 4], 3))
    ctx = min((mag + 1) >> 1, 4)
    idx = row if tx_class == TX_CLASS_VERT else col
    return ctx + _NZ_CTX_OFFSET_1D[min(idx, 31)]


def base_ctx_eob(bhl: int, width: int, scan_idx: int) -> int:
    if scan_idx == 0:
        return 0
    if scan_idx <= (width << bhl) >> 3:
        return 1
    if scan_idx <= (width << bhl) >> 2:
        return 2
    return 3


def br_ctx(levels: LevelsBuf, pos: int, bhl: int, tx_class: int) -> int:
    row, col = pos_rc(pos, bhl)
    a = levels.a
    mag = int(a[row + 1, col]) + int(a[row, col + 1])
    if tx_class == TX_CLASS_2D:
        mag += int(a[row + 1, col + 1])
        mag = min((mag + 1) >> 1, 6)
        if pos == 0:
            return mag
        if row < 2 and col < 2:
            return mag + 7
    elif tx_class == TX_CLASS_HORIZ:
        mag += int(a[row, col + 2])
        mag = min((mag + 1) >> 1, 6)
        if pos == 0:
            return mag
        if col == 0:
            return mag + 7
    else:
        mag += int(a[row + 2, col])
        mag = min((mag + 1) >> 1, 6)
        if pos == 0:
            return mag
        if row == 0:
            return mag + 7
    return mag + 14


def br_ctx_eob(pos: int, bhl: int, tx_class: int) -> int:
    row, col = pos_rc(pos, bhl)
    if pos == 0:
        return 0
    if ((tx_class == TX_CLASS_2D and row < 2 and col < 2)
            or (tx_class == TX_CLASS_HORIZ and col == 0)
            or (tx_class == TX_CLASS_VERT and row == 0)):
        return 7
    return 14


# --- txb skip / dc sign contexts from neighbor entropy contexts -----------

_SKIP_CONTEXTS = [[1, 2, 2, 2, 3], [2, 4, 4, 4, 5], [2, 4, 4, 4, 5],
                  [2, 4, 4, 4, 5], [3, 5, 5, 5, 6]]

# dc-sign contribution per entropy-context byte (sign field in the top bits)
_DC_SIGN_LUT = np.zeros(256, np.int32)
_DC_SIGN_LUT[(1 << 6):(2 << 6)] = -1   # COEFF_CONTEXT_BITS == 6
_DC_SIGN_LUT[(2 << 6):] = 1


def txb_ctx(plane_bsize: int, tx_size: int, plane: int,
            above_ctx: np.ndarray, left_ctx: np.ndarray) -> tuple:
    """(txb_skip_ctx, dc_sign_ctx) from the covered above/left entropy units
    (txb_common.h:281 get_txb_ctx_general)."""
    txb_w_unit = c.TX_WIDTH[tx_size] >> 2
    txb_h_unit = c.TX_HEIGHT[tx_size] >> 2
    a = above_ctx[:txb_w_unit]
    l = left_ctx[:txb_h_unit]
    _signs = _DC_SIGN_LUT
    dc_sign = int(_signs[a].sum()) + int(_signs[l].sum())
    dc_sign_ctx = 0 if dc_sign == 0 else (1 if dc_sign < 0 else 2)

    if plane == 0:
        tx_bsize = _tx_to_bsize(tx_size)
        if plane_bsize == tx_bsize:
            skip_ctx = 0
        else:
            top = min(int(np.bitwise_or.reduce(a)) & COEFF_CONTEXT_MASK, 4)
            left = min(int(np.bitwise_or.reduce(l)) & COEFF_CONTEXT_MASK, 4)
            skip_ctx = _SKIP_CONTEXTS[top][left]
    else:
        ctx_base = int(a.any()) + int(l.any())
        ctx_offset = 10 if (_npels_log2(plane_bsize)
                            > _npels_log2(_tx_to_bsize(tx_size))) else 7
        skip_ctx = ctx_base + ctx_offset
    return skip_ctx, dc_sign_ctx


def _tx_to_bsize(tx_size: int) -> int:
    from ..common import blockd
    return blockd.bsize_of(c.TX_WIDTH[tx_size], c.TX_HEIGHT[tx_size])


def _npels_log2(bsize: int) -> int:
    return (c.BLOCK_WIDTH[bsize] * c.BLOCK_HEIGHT[bsize]).bit_length() - 1


def set_entropy_spans(au, lu, acol, lrow, txw, txh, cul,
                      vis_w4, vis_h4, loc_c4, loc_r4,
                      cross_right, cross_bottom) -> None:
    """av1_set_entropy_contexts: edge-crossing blocks store cul only over
    the visible units; the out-of-frame remainder is zeroed."""
    if cul and cross_right:
        n = max(0, min(txw, vis_w4 - loc_c4))
        au[acol:acol + n] = cul
        au[acol + n:acol + txw] = 0
    else:
        au[acol:acol + txw] = cul
    if cul and cross_bottom:
        n = max(0, min(txh, vis_h4 - loc_r4))
        lu[lrow:lrow + n] = cul
        lu[lrow + n:lrow + txh] = 0
    else:
        lu[lrow:lrow + txh] = cul


def set_dc_sign(cul_level: int, dc_val: int) -> int:
    if dc_val < 0:
        cul_level |= 1 << COEFF_CONTEXT_BITS
    elif dc_val > 0:
        cul_level += 2 << COEFF_CONTEXT_BITS
    return cul_level


def read_golomb(rd) -> int:
    length = 0
    while rd.decode_bit() == 0:
        length += 1
        assert length < 32
    length += 1
    x = 1
    for _ in range(length - 1):
        x = (x << 1) | rd.decode_bit()
    return x - 1


def write_golomb(wr, level: int) -> None:
    x = level + 1
    length = x.bit_length()
    for _ in range(length - 1):
        wr.encode_bit(0)
    for i in range(length - 1, -1, -1):
        wr.encode_bit((x >> i) & 1)


def read_coeffs_txb(rd, fc, plane: int, tx_size: int, tx_type: int,
                    skip_ctx: int, dc_sign_ctx: int,
                    dqv_dc: int, dqv_ac: int, bd: int = 8, iqm_fn=None):
    """Decode one transform block's coefficients.

    Returns (eob, cul_level, dqcoeff flat int32 array of adjusted tx size).
    iqm_fn: optional tx_type -> flat inverse quant matrix (or None),
    applied per-position as in decodetxb.c get_dqv (AOM_QM_BITS=5).
    """
    adj = adjusted_tx_size(tx_size)
    width = c.TX_WIDTH[adj]
    height = c.TX_HEIGHT[adj]
    bhl = height.bit_length() - 1
    txs_ctx = txsize_entropy_ctx(tx_size)
    plane_type = int(plane > 0)
    shift = _tx_scale(tx_size)
    max_value = (1 << (7 + bd)) - 1
    min_value = -(1 << (7 + bd))

    all_zero = rd.decode_symbol_adapt(
        fc.txb_skip_cdf[txs_ctx][skip_ctx], 2)
    if all_zero:
        return 0, 0, None

    if callable(tx_type):  # luma: tx_type symbol follows the skip flag
        tx_type = tx_type()
    iqm = iqm_fn(tx_type) if iqm_fn is not None else None
    tx_class = TX_TYPE_TO_CLASS[tx_type]
    scan = tables.scan(adj, tx_type)
    eob_ms = eob_multi_size(tx_size)

    eob_multi_ctx = 0 if tx_class == TX_CLASS_2D else 1
    eob_cdf = getattr(fc, f"eob_flag_cdf{16 << eob_ms}")
    eob_pt = rd.decode_symbol_adapt(
        eob_cdf[plane_type][eob_multi_ctx], eob_ms + 5) + 1
    eob_extra = 0
    offset_bits = EOB_OFFSET_BITS[eob_pt]
    if offset_bits > 0:
        eob_ctx = eob_pt - 3
        bit = rd.decode_symbol_adapt(
            fc.eob_extra_cdf[txs_ctx][plane_type][eob_ctx], 2)
        if bit:
            eob_extra += 1 << (offset_bits - 1)
        for i in range(1, offset_bits):
            if rd.decode_bit():
                eob_extra += 1 << (offset_bits - 1 - i)
    eob = EOB_GROUP_START[eob_pt] + eob_extra

    levels = LevelsBuf(width, height)

    # last coefficient
    ci = eob - 1
    pos = int(scan[ci])
    ctx = base_ctx_eob(bhl, width, ci)
    level = rd.decode_symbol_adapt(
        fc.coeff_base_eob_cdf[txs_ctx][plane_type][ctx], 3) + 1
    if level > NUM_BASE_LEVELS:
        bctx = br_ctx_eob(pos, bhl, tx_class)
        cdf = fc.coeff_br_cdf[min(txs_ctx, c.TX_32X32)][plane_type][bctx]
        for _ in range(0, COEFF_BASE_RANGE, BR_CDF_SIZE - 1):
            k = rd.decode_symbol_adapt(cdf, BR_CDF_SIZE)
            level += k
            if k < BR_CDF_SIZE - 1:
                break
    r, col = pos_rc(pos, bhl)
    levels.set(r, col, level)

    # remaining coefficients in reverse scan order
    for ci in range(eob - 2, -1, -1):
        pos = int(scan[ci])
        ctx = base_ctx(levels, pos, bhl, tx_size, tx_class)
        level = rd.decode_symbol_adapt(
            fc.coeff_base_cdf[txs_ctx][plane_type][ctx], 4)
        if level > NUM_BASE_LEVELS:
            bctx = br_ctx(levels, pos, bhl, tx_class)
            cdf = fc.coeff_br_cdf[min(txs_ctx, c.TX_32X32)][plane_type][bctx]
            for _ in range(0, COEFF_BASE_RANGE, BR_CDF_SIZE - 1):
                k = rd.decode_symbol_adapt(cdf, BR_CDF_SIZE)
                level += k
                if k < BR_CDF_SIZE - 1:
                    break
        r, col = pos_rc(pos, bhl)
        levels.set(r, col, level)

    # signs + golomb + dequant, forward scan order
    dqcoeff = np.zeros(width * height, dtype=np.int32)
    cul_level = 0
    dc_val = 0
    for ci in range(eob):
        pos = int(scan[ci])
        r, col = pos_rc(pos, bhl)
        level = levels.get(r, col)
        if not level:
            continue
        if ci == 0:
            sign = rd.decode_symbol_adapt(
                fc.dc_sign_cdf[plane_type][dc_sign_ctx], 2)
        else:
            sign = rd.decode_bit()
        if level >= MAX_BASE_BR_RANGE:
            level += read_golomb(rd)
        if ci == 0:
            dc_val = -level if sign else level
        level &= 0xFFFFF
        cul_level += level
        dqv = dqv_dc if pos == 0 else dqv_ac
        if iqm is not None:
            dqv = (int(iqm[pos]) * dqv + 16) >> 5
        dq = (level * dqv) & 0xFFFFFF
        dq >>= shift
        if sign:
            dq = -dq
        dqcoeff[pos] = max(min(dq, max_value), min_value)

    cul_level = min(COEFF_CONTEXT_MASK, cul_level)
    cul_level = set_dc_sign(cul_level, dc_val)
    return eob, cul_level, dqcoeff


def _tx_scale(tx_size: int) -> int:
    """av1_get_tx_scale: rounding shift for large transforms."""
    pels = c.TX_WIDTH[tx_size] * c.TX_HEIGHT[tx_size]
    return int(pels > 256) + int(pels > 1024)


def write_coeffs_txb(wr, fc, qcoeff: np.ndarray, plane: int, tx_size: int,
                     tx_type: int, skip_ctx: int, dc_sign_ctx: int,
                     tx_type_writer=None) -> int:
    """Encode one transform block's quantized coefficients.

    `qcoeff` is the flat (scan-position-indexed) int array.  Symbol order
    mirrors read_coeffs_txb exactly (reference: av1/encoder/encodetxb.c:269
    av1_write_coeffs_txb).  Returns cul_level for entropy-context update.
    """
    adj = adjusted_tx_size(tx_size)
    width = c.TX_WIDTH[adj]
    height = c.TX_HEIGHT[adj]
    bhl = height.bit_length() - 1
    txs_ctx = txsize_entropy_ctx(tx_size)
    plane_type = int(plane > 0)
    tx_class = TX_TYPE_TO_CLASS[tx_type]
    scan = tables.scan(adj, tx_type)

    # eob = last nonzero scan index + 1
    nz = [si for si in range(len(scan)) if qcoeff[int(scan[si])] != 0]
    eob = nz[-1] + 1 if nz else 0

    all_zero = int(eob == 0)
    wr.encode_symbol_adapt(all_zero, fc.txb_skip_cdf[txs_ctx][skip_ctx], 2)
    if all_zero:
        return 0
    if tx_type_writer is not None:  # luma: tx_type symbol after skip flag
        tx_type_writer()

    # eob token
    eob_ms = eob_multi_size(tx_size)
    eob_multi_ctx = 0 if tx_class == TX_CLASS_2D else 1
    eob_pt = next(t for t in range(len(EOB_GROUP_START) - 1, 0, -1)
                  if EOB_GROUP_START[t] <= eob) \
        if eob > 0 else 1
    # find group: largest t with group_start[t] <= eob and eob < next start
    for t in range(1, 12):
        if EOB_GROUP_START[t] <= eob and \
                (t + 1 >= 12 or eob < EOB_GROUP_START[t + 1]):
            eob_pt = t
            break
    eob_cdf = getattr(fc, f"eob_flag_cdf{16 << eob_ms}")
    wr.encode_symbol_adapt(eob_pt - 1, eob_cdf[plane_type][eob_multi_ctx],
                           eob_ms + 5)
    offset_bits = EOB_OFFSET_BITS[eob_pt]
    eob_extra = eob - EOB_GROUP_START[eob_pt]
    if offset_bits > 0:
        eob_ctx = eob_pt - 3
        bit = (eob_extra >> (offset_bits - 1)) & 1
        wr.encode_symbol_adapt(
            bit, fc.eob_extra_cdf[txs_ctx][plane_type][eob_ctx], 2)
        for i in range(1, offset_bits):
            wr.encode_bit((eob_extra >> (offset_bits - 1 - i)) & 1)

    levels = LevelsBuf(width, height)
    # pre-fill levels with min(abs, 15)-equivalent coding levels: the level
    # buffer must hold the PRE-golomb coded level (base+br, <= 15), matching
    # what the decoder reconstructs during its reverse pass.
    # We fill entries as we "code" them in the same order as the decoder.

    # last coefficient
    ci = eob - 1
    pos = int(scan[ci])
    v = int(qcoeff[pos])
    level = min(abs(v), MAX_BASE_BR_RANGE)
    ctx = base_ctx_eob(bhl, width, ci)
    assert level >= 1
    wr.encode_symbol_adapt(min(level, 3) - 1,
                           fc.coeff_base_eob_cdf[txs_ctx][plane_type][ctx], 3)
    if level > NUM_BASE_LEVELS:
        bctx = br_ctx_eob(pos, bhl, tx_class)
        cdf = fc.coeff_br_cdf[min(txs_ctx, c.TX_32X32)][plane_type][bctx]
        rem = level - NUM_BASE_LEVELS - 1  # amount coded by br symbols
        for _ in range(0, COEFF_BASE_RANGE, BR_CDF_SIZE - 1):
            k = min(rem, BR_CDF_SIZE - 1)
            wr.encode_symbol_adapt(k, cdf, BR_CDF_SIZE)
            rem -= k
            if k < BR_CDF_SIZE - 1:
                break
    r_, col_ = pos_rc(pos, bhl)
    levels.set(r_, col_, level)

    # reverse pass
    for ci in range(eob - 2, -1, -1):
        pos = int(scan[ci])
        v = int(qcoeff[pos])
        level = min(abs(v), MAX_BASE_BR_RANGE)
        ctx = base_ctx(levels, pos, bhl, tx_size, tx_class)
        wr.encode_symbol_adapt(min(level, 3),
                               fc.coeff_base_cdf[txs_ctx][plane_type][ctx], 4)
        if level > NUM_BASE_LEVELS:
            bctx = br_ctx(levels, pos, bhl, tx_class)
            cdf = fc.coeff_br_cdf[min(txs_ctx, c.TX_32X32)][plane_type][bctx]
            rem = level - NUM_BASE_LEVELS - 1
            for _ in range(0, COEFF_BASE_RANGE, BR_CDF_SIZE - 1):
                k = min(rem, BR_CDF_SIZE - 1)
                wr.encode_symbol_adapt(k, cdf, BR_CDF_SIZE)
                rem -= k
                if k < BR_CDF_SIZE - 1:
                    break
        r_, col_ = pos_rc(pos, bhl)
        levels.set(r_, col_, level)

    # signs + golomb, forward order
    cul_level = 0
    dc_val = 0
    for ci in range(eob):
        pos = int(scan[ci])
        v = int(qcoeff[pos])
        if v == 0:
            continue
        level = abs(v)
        sign = int(v < 0)
        if ci == 0:
            wr.encode_symbol_adapt(sign,
                                   fc.dc_sign_cdf[plane_type][dc_sign_ctx], 2)
            dc_val = v
        else:
            wr.encode_bit(sign)
        if level >= MAX_BASE_BR_RANGE:
            write_golomb(wr, level - MAX_BASE_BR_RANGE)
        cul_level += level

    cul_level = min(COEFF_CONTEXT_MASK, cul_level)
    cul_level = set_dc_sign(cul_level, dc_val)
    return cul_level
