"""Block geometry: sizes, partitions, plane scaling, neighbor availability.

Normative AV1 block-size relations (spec §5.11.4, §6.10.4; reference
behavior: av1/common/common_data.h, av1/common/reconintra.c:190
has_top_right / :382 has_bottom_left).  The top-right / bottom-left
availability is computed from the superblock Z-order coding rule rather than
lookup tables: a neighbor square is available iff its Z-curve index (row bit
above column bit at each quadtree level) precedes the current block's; for
PARTITION_VERT_A/B the deepest level orders the pair column-major instead.
"""

from __future__ import annotations

from ..bitstream import constants as c

# dims -> bsize index
_DIMS_TO_BSIZE = {
    (c.BLOCK_WIDTH[i], c.BLOCK_HEIGHT[i]): i for i in range(c.BLOCK_SIZES_ALL)
}

_DIMS_TO_TX = {(c.TX_WIDTH[i], c.TX_HEIGHT[i]): i
               for i in range(c.TX_SIZES_ALL)}


def block_wide(bsize: int) -> int:
    return c.BLOCK_WIDTH[bsize]


def block_high(bsize: int) -> int:
    return c.BLOCK_HEIGHT[bsize]


def mi_size_wide(bsize: int) -> int:
    return c.BLOCK_WIDTH[bsize] >> 2


def mi_size_high(bsize: int) -> int:
    return c.BLOCK_HEIGHT[bsize] >> 2


def bsize_of(w: int, h: int) -> int:
    return _DIMS_TO_BSIZE[(w, h)]


def tx_size_of(w: int, h: int) -> int:
    return _DIMS_TO_TX[(w, h)]


def partition_subsize(bsize: int, partition: int) -> int:
    """subsize_lookup equivalent (valid for square bsize)."""
    w, h = block_wide(bsize), block_high(bsize)
    if partition == c.PARTITION_NONE:
        return bsize
    if partition in (c.PARTITION_HORZ, c.PARTITION_HORZ_A, c.PARTITION_HORZ_B):
        return bsize_of(w, h // 2)
    if partition in (c.PARTITION_VERT, c.PARTITION_VERT_A, c.PARTITION_VERT_B):
        return bsize_of(w // 2, h)
    if partition == c.PARTITION_SPLIT:
        return bsize_of(w // 2, h // 2)
    if partition == c.PARTITION_HORZ_4:
        return bsize_of(w, h // 4)
    if partition == c.PARTITION_VERT_4:
        return bsize_of(w // 4, h)
    raise ValueError(partition)


def plane_block_size(bsize: int, ss_x: int, ss_y: int) -> int:
    """ss_size_lookup equivalent: chroma block size for a luma bsize."""
    w = max(4, block_wide(bsize) >> ss_x)
    h = max(4, block_high(bsize) >> ss_y)
    # 1:4 shapes subsampled on their long axis keep min dim 4
    return _DIMS_TO_BSIZE[(w, h)]


def is_chroma_reference(mi_row: int, mi_col: int, bsize: int, ss_x: int,
                        ss_y: int) -> bool:
    bw = mi_size_wide(bsize)
    bh = mi_size_high(bsize)
    return (((mi_row & 1) or not (bh & 1) or not ss_y) and
            ((mi_col & 1) or not (bw & 1) or not ss_x))


def max_tx_size_rect(bsize: int) -> int:
    """Largest transform size with same aspect (max_txsize_rect_lookup)."""
    w = min(64, block_wide(bsize))
    h = min(64, block_high(bsize))
    # clamp aspect to 2:1 (no 4:1 tx sizes beyond the defined set)
    while (w, h) not in _DIMS_TO_TX:
        if w > h:
            w //= 2
        else:
            h //= 2
    return _DIMS_TO_TX[(w, h)]


# --- Z-order based neighbor availability (reconintra.c:190,382) -----------


def _z_order(r: int, c_: int, nbits: int) -> int:
    z = 0
    for b in range(nbits - 1, -1, -1):
        z = (z << 2) | (((r >> b) & 1) << 1) | ((c_ >> b) & 1)
    return z


def _vert_order(r: int, c_: int, nbits: int) -> int:
    """Z-order except the deepest level pairs column-major (VERT_A/B)."""
    if nbits == 0:
        return 0
    hi = _z_order(r >> 1, c_ >> 1, nbits - 1)
    return hi * 4 + ((c_ & 1) << 1) + (r & 1)


def _blk_available(blk_row: int, blk_col: int, nbr_row: int, nbr_col: int,
                   nbits: int, vert: bool) -> bool:
    order = _vert_order if vert else _z_order
    return order(nbr_row, nbr_col, nbits) < order(blk_row, blk_col, nbits)


def has_top_right(sb_size_log2: int, bsize: int, mi_row: int, mi_col: int,
                  top_available: bool, right_available: bool, partition: int,
                  tx_size: int, row_off: int, col_off: int, ss_x: int,
                  ss_y: int) -> int:
    if not top_available or not right_available:
        return 0
    bw_unit = mi_size_wide(bsize)
    plane_bw_unit = max(bw_unit >> ss_x, 1)
    tr_count_unit = c.TX_WIDTH[tx_size] >> 2
    if row_off > 0:
        if block_wide(bsize) > 64:
            if (row_off == (16 >> ss_y) and
                    col_off + tr_count_unit == (16 >> ss_x)):
                return 1
            plane_bw_unit_64 = 16 >> ss_x
            col_off_64 = col_off % plane_bw_unit_64
            return int(col_off_64 + tr_count_unit < plane_bw_unit_64)
        return int(col_off + tr_count_unit < plane_bw_unit)
    if col_off + tr_count_unit < plane_bw_unit:
        return 1
    bw_log2 = mi_size_wide(bsize).bit_length() - 1
    bh_log2 = mi_size_high(bsize).bit_length() - 1
    sb_mi = 1 << (sb_size_log2 - 2)
    blk_row_in_sb = (mi_row & (sb_mi - 1)) >> bh_log2
    blk_col_in_sb = (mi_col & (sb_mi - 1)) >> bw_log2
    if blk_row_in_sb == 0:
        return 1
    if ((blk_col_in_sb + 1) << bw_log2) >= sb_mi:
        return 0
    # square-block Z-order check (rect blocks behave as their square pairs:
    # only square sizes reach this point with equal log2s in practice, and
    # the reference tables were generated from the same traversal rule)
    vert = partition in (c.PARTITION_VERT_A, c.PARTITION_VERT_B)
    return int(_rect_available(blk_row_in_sb, blk_col_in_sb, bw_log2, bh_log2,
                               sb_mi, vert, tr=True))


def has_bottom_left(sb_size_log2: int, bsize: int, mi_row: int, mi_col: int,
                    bottom_available: bool, left_available: bool,
                    partition: int, tx_size: int, row_off: int, col_off: int,
                    ss_x: int, ss_y: int) -> int:
    if not bottom_available or not left_available:
        return 0
    if block_wide(bsize) > 64 and col_off > 0:
        plane_bw_unit_64 = 16 >> ss_x
        col_off_64 = col_off % plane_bw_unit_64
        if col_off_64 == 0:
            plane_bh_unit_64 = 16 >> ss_y
            row_off_64 = row_off % plane_bh_unit_64
            plane_bh_unit = min(mi_size_high(bsize) >> ss_y, plane_bh_unit_64)
            return int(row_off_64 + (c.TX_HEIGHT[tx_size] >> 2)
                       < plane_bh_unit)
    if col_off > 0:
        return 0
    bh_unit = mi_size_high(bsize)
    plane_bh_unit = max(bh_unit >> ss_y, 1)
    bl_count_unit = c.TX_HEIGHT[tx_size] >> 2
    if row_off + bl_count_unit < plane_bh_unit:
        return 1
    bw_log2 = mi_size_wide(bsize).bit_length() - 1
    bh_log2 = mi_size_high(bsize).bit_length() - 1
    sb_mi = 1 << (sb_size_log2 - 2)
    blk_row_in_sb = (mi_row & (sb_mi - 1)) >> bh_log2
    blk_col_in_sb = (mi_col & (sb_mi - 1)) >> bw_log2
    if blk_col_in_sb == 0:
        blk_start_row_off = blk_row_in_sb << bh_log2 >> ss_y
        row_off_in_sb = blk_start_row_off + row_off
        sb_height_unit = sb_mi >> ss_y
        return int(row_off_in_sb + bl_count_unit < sb_height_unit)
    if ((blk_row_in_sb + 1) << bh_log2) >= sb_mi:
        return 0
    vert = partition in (c.PARTITION_VERT_A, c.PARTITION_VERT_B)
    return int(_rect_available(blk_row_in_sb, blk_col_in_sb, bw_log2, bh_log2,
                               sb_mi, vert, tr=False))


def _rect_available(blk_row: int, blk_col: int, bw_log2: int, bh_log2: int,
                    sb_mi: int, vert: bool, tr: bool) -> bool:
    """Availability of the TR (tr=True) or BL neighbor of a (possibly
    rectangular) block in the SB coding order.

    Rectangular blocks are treated as pairs of squares of their short side
    (matching the reference's table semantics): the block's position is
    mapped into the square grid of size min(bw, bh).
    """
    sq_log2 = min(bw_log2, bh_log2)
    nbits = max((sb_mi >> sq_log2).bit_length() - 1, 0)
    # block's top-left square coords in the square grid
    r = blk_row << (bh_log2 - sq_log2)
    col = blk_col << (bw_log2 - sq_log2)
    if tr:
        # top-right square of this block, neighbor above-right of it
        col_tr = col + (1 << (bw_log2 - sq_log2)) - 1
        return _blk_available(r, col_tr, r - 1, col_tr + 1, nbits, vert)
    # bottom-left square, neighbor below-left
    r_bl = r + (1 << (bh_log2 - sq_log2)) - 1
    return _blk_available(r_bl, col, r_bl + 1, col - 1, nbits, vert)
