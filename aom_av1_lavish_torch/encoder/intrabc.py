"""IntraBC (screen content) encoding: hash-based DV search.

Re-designs the reference's intraBC encoder support —
av1/encoder/hash_motion.c (content-hash tables over block positions),
av1/encoder/mcomp.c:av1_refining_search_8p_c intrabc usage, and
av1/common/mvref_common.h:av1_is_dv_valid — for the all-intra screen
path: source blocks are indexed by content hash, candidate DVs are
validated against the normative constraints, and the winner competes in
RD against intra modes with its residual coded through the inter-style
transform path the decoder uses for intrabc blocks.
"""

from __future__ import annotations

import numpy as np

INTRABC_DELAY_SB64 = 4   # mvref_common.h:263 (256-pixel delay)


def build_hash_index(src_y: np.ndarray, sizes=(8, 16, 32, 64),
                     step: int = 4) -> dict:
    """size -> {hash: [(y, x), ...]} over the full source plane
    (av1_hash_table_create analog; zlib crc over rows)."""
    import zlib
    h, w = src_y.shape
    out = {}
    for s in sizes:
        table = {}
        for y in range(0, h - s + 1, step):
            for x in range(0, w - s + 1, step):
                key = zlib.crc32(src_y[y:y + s, x:x + s].tobytes())
                table.setdefault(key, []).append((y, x))
        out[s] = table
    return out


def hash_candidates(index: dict, src_y: np.ndarray, y0: int, x0: int,
                    size: int, limit: int = 16):
    """Positions whose `size`-block content equals the block at
    (y0, x0) (verified, not just hash-equal)."""
    import zlib
    table = index.get(size)
    if table is None:
        return []
    blk = src_y[y0:y0 + size, x0:x0 + size]
    key = zlib.crc32(blk.tobytes())
    out = []
    for (cy, cx) in table.get(key, ())[:64]:
        if (cy, cx) == (y0, x0):
            continue
        if np.array_equal(src_y[cy:cy + size, cx:cx + size], blk):
            out.append((cy, cx))
            if len(out) >= limit:
                break
    return out


def dv_valid(dv_row: int, dv_col: int, mi_row: int, mi_col: int,
             bw: int, bh: int, mi_rows: int, mi_cols: int,
             sb_mi_log2: int = 4) -> bool:
    """av1_is_dv_valid (mvref_common.h:277), single tile spanning the
    frame; dv in q8 full-pel multiples."""
    if (dv_row & 7) or (dv_col & 7):
        return False
    src_top = mi_row * 4 * 8 + dv_row
    src_left = mi_col * 4 * 8 + dv_col
    src_bottom = (mi_row * 4 + bh) * 8 + dv_row
    src_right = (mi_col * 4 + bw) * 8 + dv_col
    if src_top < 0 or src_left < 0:
        return False
    if src_bottom > mi_rows * 4 * 8 or src_right > mi_cols * 4 * 8:
        return False
    # sub-8 chroma guard (4:2:0): keep 4px off the top/left for <8 blocks
    if bw < 8 and src_left < 4 * 8:
        return False
    if bh < 8 and src_top < 4 * 8:
        return False
    sb_size = (1 << sb_mi_log2) * 4
    active_sb_row = mi_row >> sb_mi_log2
    active_sb64_col = (mi_col * 4) >> 6
    src_sb_row = ((src_bottom >> 3) - 1) // sb_size
    src_sb64_col = ((src_right >> 3) - 1) >> 6
    total_sb64_per_row = ((mi_cols - 1) >> 4) + 1
    active_sb64 = active_sb_row * total_sb64_per_row + active_sb64_col
    src_sb64 = src_sb_row * total_sb64_per_row + src_sb64_col
    if src_sb64 >= active_sb64 - INTRABC_DELAY_SB64:
        return False
    gradient = 1 + INTRABC_DELAY_SB64 + (sb_size > 64)
    wf_offset = gradient * (active_sb_row - src_sb_row)
    if (src_sb_row > active_sb_row
            or src_sb64_col >= active_sb64_col - INTRABC_DELAY_SB64
            + wf_offset):
        return False
    return True


def predict_intrabc(planes, plane: int, x0: int, y0: int, b_w: int,
                    b_h: int, dv, ss_x: int, ss_y: int,
                    mb_to_left: int, mb_to_right: int, mb_to_top: int,
                    mb_to_bottom: int, bd: int = 8) -> np.ndarray:
    """Encoder-side mirror of decoder._mc_intrabc: bilinear MC from the
    in-progress recon of the current frame."""
    from ..bitstream import constants as c
    from ..common import interpred as IP
    src = planes[plane]
    row_q4, col_q4 = IP.clamp_mv_to_umv_border(
        int(dv[0]), int(dv[1]), b_w, b_h, ss_x, ss_y, mb_to_left,
        mb_to_right, mb_to_top, mb_to_bottom)
    pos_x = (x0 << IP.SUBPEL_BITS) + col_q4
    pos_y = (y0 << IP.SUBPEL_BITS) + row_q4
    fx = pos_x >> IP.SUBPEL_BITS
    fy = pos_y >> IP.SUBPEL_BITS
    rows = np.clip(np.arange(fy - 3, fy + b_h + 4), 0, src.shape[0] - 1)
    cols = np.clip(np.arange(fx - 3, fx + b_w + 4), 0, src.shape[1] - 1)
    region = src[np.ix_(rows, cols)].astype(np.int32)
    kern = IP.filter_kernels(c.BILINEAR, b_w)
    return IP.convolve_sr(region, pos_x & IP.SUBPEL_MASK,
                          pos_y & IP.SUBPEL_MASK, kern, kern, bd)
