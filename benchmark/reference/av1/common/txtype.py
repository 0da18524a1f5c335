"""Transform-type sets and signaling helpers (spec §5.11.47/8.3.3;
reference behavior: av1/common/blockd.h av1_get_tx_type,
entropymode.h:169 av1_ext_tx_ind/inv)."""

from __future__ import annotations

from ..bitstream import constants as c

# set types
EXT_TX_SET_DCTONLY = 0
EXT_TX_SET_DCT_IDTX = 1
EXT_TX_SET_DTT4_IDTX = 2
EXT_TX_SET_DTT4_IDTX_1DDCT = 3
EXT_TX_SET_DTT9_IDTX_1DDCT = 4
EXT_TX_SET_ALL16 = 5

NUM_EXT_TX_SET = [1, 2, 5, 7, 12, 16]

EXT_TX_USED = [
    [1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    [1, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0],
    [1, 1, 1, 1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0],
    [1, 1, 1, 1, 0, 0, 0, 0, 0, 1, 1, 1, 0, 0, 0, 0],
    [1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0],
    [1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1],
]

EXT_TX_IND = [
    [0] * 16,
    [1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    [1, 3, 4, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    [1, 5, 6, 4, 0, 0, 0, 0, 0, 0, 2, 3, 0, 0, 0, 0],
    [3, 4, 5, 8, 6, 7, 9, 10, 11, 0, 1, 2, 0, 0, 0, 0],
    [7, 8, 9, 12, 10, 11, 13, 14, 15, 0, 1, 2, 3, 4, 5, 6],
]

EXT_TX_INV = [
    [0] * 16,
    [9, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    [9, 0, 3, 1, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    [9, 0, 10, 11, 3, 1, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    [9, 10, 11, 0, 1, 2, 4, 5, 3, 6, 7, 8, 0, 0, 0, 0],
    [9, 10, 11, 12, 13, 14, 15, 0, 1, 2, 4, 5, 3, 6, 7, 8],
]

# intra prediction mode -> derived tx type (blockd.h:1004)
INTRA_MODE_TO_TX_TYPE = [
    c.DCT_DCT, c.ADST_DCT, c.DCT_ADST, c.DCT_DCT, c.ADST_ADST, c.ADST_DCT,
    c.DCT_ADST, c.DCT_ADST, c.ADST_DCT, c.ADST_ADST, c.ADST_DCT,
    c.DCT_ADST, c.ADST_ADST,
]


def ext_tx_set_type(tx_size: int, is_inter: bool, reduced: bool) -> int:
    sqr_up = c.TX_SIZE_SQR_UP[tx_size]
    if sqr_up > c.TX_32X32:
        return EXT_TX_SET_DCTONLY
    if sqr_up == c.TX_32X32:
        return EXT_TX_SET_DCT_IDTX if is_inter else EXT_TX_SET_DCTONLY
    if reduced:
        return EXT_TX_SET_DCT_IDTX if is_inter else EXT_TX_SET_DTT4_IDTX
    sqr = c.TX_SIZE_SQR[tx_size]
    if is_inter:
        return (EXT_TX_SET_DTT9_IDTX_1DDCT if sqr == c.TX_16X16
                else EXT_TX_SET_ALL16)
    return (EXT_TX_SET_DTT4_IDTX if sqr == c.TX_16X16
            else EXT_TX_SET_DTT4_IDTX_1DDCT)


# intra set type -> cdf group index (av1_ext_tx_set_idx_to_type inverse)
_INTRA_SET_TO_IDX = {EXT_TX_SET_DCTONLY: 0, EXT_TX_SET_DTT4_IDTX_1DDCT: 1,
                     EXT_TX_SET_DTT4_IDTX: 2}


def intra_ext_tx_idx(set_type: int) -> int:
    return _INTRA_SET_TO_IDX[set_type]


# inter set type -> cdf group index (blockd.h:1110 ext_tx_set_index[1])
_INTER_SET_TO_IDX = {EXT_TX_SET_DCTONLY: 0, EXT_TX_SET_ALL16: 1,
                     EXT_TX_SET_DTT9_IDTX_1DDCT: 2, EXT_TX_SET_DCT_IDTX: 3}


def inter_ext_tx_idx(set_type: int) -> int:
    return _INTER_SET_TO_IDX[set_type]


def chroma_intra_tx_type(uv_mode: int, tx_size: int, reduced: bool) -> int:
    """av1_get_tx_type for intra chroma (uv mode drives the type)."""
    base = uv_mode if uv_mode < c.UV_CFL_PRED else c.DC_PRED
    tx_type = INTRA_MODE_TO_TX_TYPE[base]
    st = ext_tx_set_type(tx_size, False, reduced)
    if not EXT_TX_USED[st][tx_type]:
        return c.DCT_DCT
    return tx_type
