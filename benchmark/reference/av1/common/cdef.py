"""CDEF: constrained directional enhancement filter (AV1 spec 7.15).

Reference behavior: av1/common/cdef.c (av1_cdef_frame orchestration,
8x8 skip list), cdef_block.c (cdef_find_dir_c:57, adjust_strength:289,
cdef_filter_block_internal:139), cdef.h constrain:61.

Implementation strategy: instead of the reference's line/column buffers
(which exist so in-place filtering still reads pre-CDEF neighbors), we
filter from a pristine copy of the deblocked frame into the output, which
is equivalent.  Frame borders read CDEF_VERY_LARGE.
"""

from __future__ import annotations

import numpy as np

CDEF_VERY_LARGE = 0x4000
CDEF_SEC_STRENGTHS = 4

# tap offsets (row, col) per direction (cdef_block.c:25, stride-free form)
_DIRS = [
    [(-1, 1), (-2, 2)], [(0, 1), (-1, 2)], [(0, 1), (0, 2)],
    [(0, 1), (1, 2)], [(1, 1), (2, 2)], [(1, 0), (2, 1)],
    [(1, 0), (2, 0)], [(1, 0), (2, -1)],
]
_PRI_TAPS = [[4, 2], [3, 3]]
_SEC_TAPS = [2, 1]

_DIV_TABLE = [0, 840, 420, 280, 210, 168, 140, 120, 105]

# 8 directional projection index maps (cdef_find_dir_c:68)
_PARTIAL_IDX = None


def _partial_maps():
    global _PARTIAL_IDX
    if _PARTIAL_IDX is None:
        maps = np.zeros((8, 15, 64), np.int32)
        for i in range(8):
            for j in range(8):
                p = i * 8 + j
                maps[0, i + j, p] = 1
                maps[1, i + j // 2, p] = 1
                maps[2, i, p] = 1
                maps[3, 3 + i - j // 2, p] = 1
                maps[4, 7 + i - j, p] = 1
                maps[5, 3 - i // 2 + j, p] = 1
                maps[6, j, p] = 1
                maps[7, i // 2 + j, p] = 1
        _PARTIAL_IDX = maps
    return _PARTIAL_IDX


def find_dir_blocks(blocks: np.ndarray, coeff_shift: int = 0):
    """blocks (N, 8, 8) -> (dirs (N,), variances (N,))."""
    maps = _partial_maps()
    x = (blocks.reshape(-1, 64).astype(np.int64) >> coeff_shift) - 128
    partial = np.einsum("np,fkp->nfk", x, maps)  # (N, 8, 15)
    div = np.array(_DIV_TABLE, np.int64)
    cost = np.zeros((x.shape[0], 8), np.int64)
    cost[:, 2] = (partial[:, 2, :8] ** 2).sum(-1) * div[8]
    cost[:, 6] = (partial[:, 6, :8] ** 2).sum(-1) * div[8]
    for i in range(7):
        cost[:, 0] += (partial[:, 0, i] ** 2
                       + partial[:, 0, 14 - i] ** 2) * div[i + 1]
        cost[:, 4] += (partial[:, 4, i] ** 2
                       + partial[:, 4, 14 - i] ** 2) * div[i + 1]
    cost[:, 0] += partial[:, 0, 7] ** 2 * div[8]
    cost[:, 4] += partial[:, 4, 7] ** 2 * div[8]
    for i in (1, 3, 5, 7):
        cost[:, i] = (partial[:, i, 3:8] ** 2).sum(-1) * div[8]
        for j in range(3):
            cost[:, i] += (partial[:, i, j] ** 2
                           + partial[:, i, 10 - j] ** 2) * div[2 * j + 2]
    # ties resolve to the first maximum with a strict > scan from dir 0;
    # np.argmax picks the first maximum, matching `cost[i] > best_cost`
    best = np.argmax(cost, 1)
    var = cost[np.arange(len(best)), best] \
        - cost[np.arange(len(best)), (best + 4) & 7]
    return best.astype(np.int32), (var >> 10).astype(np.int64)


def _get_msb(v: int) -> int:
    return max(0, int(v).bit_length() - 1)


def adjust_strength(strength: int, var: int) -> int:
    if var == 0:
        return 0
    i = min(_get_msb(var >> 6), 12) if (var >> 6) else 0
    return (strength * (4 + i) + 8) >> 4


def _constrain(diff, threshold, damping):
    """Vectorized constrain (cdef.h:61); threshold is a scalar > 0."""
    shift = max(0, damping - _get_msb(threshold))
    ad = np.abs(diff)
    return np.sign(diff) * np.minimum(ad,
                                      np.maximum(0, threshold - (ad >> shift)))


def filter_block(inb: np.ndarray, pri_strength: int, sec_strength: int,
                 direction: int, pri_damping: int, sec_damping: int,
                 bw: int, bh: int, coeff_shift: int = 0) -> np.ndarray:
    """Filter one block.  inb: (bh+4, bw+4) int32 source with the block at
    [2:2+bh, 2:2+bw] (taps reach +-2); returns (bh, bw) int32."""
    enable_p = pri_strength != 0
    enable_s = sec_strength != 0
    x = inb[2:2 + bh, 2:2 + bw]
    if not enable_p and not enable_s:
        return x.copy()
    clip = enable_p and enable_s
    total = np.zeros((bh, bw), np.int64)
    mx = x.copy()
    mn = x.copy()

    def tap(dr, dc):
        return inb[2 + dr:2 + dr + bh, 2 + dc:2 + dc + bw]

    # tap parity from the unshifted strength (cdef_block.c:147)
    pri_taps = _PRI_TAPS[(pri_strength >> coeff_shift) & 1]
    for k in range(2):
        if enable_p:
            dr, dc = _DIRS[direction][k]
            for s in (1, -1):
                p = tap(s * dr, s * dc)
                total += pri_taps[k] * _constrain(p - x, pri_strength,
                                                  pri_damping)
                if clip:
                    mx = np.where(p != CDEF_VERY_LARGE, np.maximum(p, mx),
                                  mx)
                    mn = np.minimum(p, mn)
        if enable_s:
            # dir +-2 wraps through the padded table, i.e. modulo 8
            for doff in (2, -2):
                dr, dc = _DIRS[(direction + doff) % 8][k]
                for s in (1, -1):
                    p = tap(s * dr, s * dc)
                    if clip:
                        mx = np.where(p != CDEF_VERY_LARGE,
                                      np.maximum(p, mx), mx)
                        mn = np.minimum(p, mn)
                    total += _SEC_TAPS[k] * _constrain(p - x, sec_strength,
                                                       sec_damping)
    y = x + ((8 + total - (total < 0)) >> 4)
    if clip:
        y = np.clip(y, mn, mx)
    return y.astype(np.int32)


def cdef_frame(planes, mi_rows, mi_cols, ss_x, ss_y, num_planes,
               skip_grid, strength_grid, fh, bd=8):
    """Apply CDEF in place over mi-aligned planes.

    skip_grid: (mi_rows, mi_cols) skip_txfm per mi; strength_grid:
    per-64x64 cdef_strength index (-1 = not coded); fh carries the parsed
    cdef_* frame parameters."""
    coeff_shift = bd - 8
    nvfb = (mi_rows + 15) // 16
    nhfb = (mi_cols + 15) // 16
    w = mi_cols * 4
    h = mi_rows * 4
    pristine = []
    for p in range(num_planes):
        sx = ss_x if p else 0
        sy = ss_y if p else 0
        buf = np.full(((h >> sy) + 8, (w >> sx) + 8), CDEF_VERY_LARGE,
                      np.int32)
        buf[4:4 + (h >> sy), 4:4 + (w >> sx)] = \
            planes[p][:h >> sy, :w >> sx]
        pristine.append(buf)

    damping = fh.cdef_damping
    for fbr in range(nvfb):
        for fbc in range(nhfb):
            sidx = strength_grid[fbr, fbc]
            if sidx < 0:
                continue
            y_lvl = fh.cdef_y_pri[sidx]
            y_sec = fh.cdef_y_sec[sidx]
            y_sec += y_sec == 3
            uv_lvl = fh.cdef_uv_pri[sidx] if num_planes > 1 else 0
            uv_sec = fh.cdef_uv_sec[sidx] if num_planes > 1 else 0
            uv_sec += uv_sec == 3
            if y_lvl == 0 and y_sec == 0 and uv_lvl == 0 and uv_sec == 0:
                continue
            # 8x8 skip list
            maxr = min(16, mi_rows - fbr * 16)
            maxc = min(16, mi_cols - fbc * 16)
            blocks = []
            for r in range(0, maxr, 2):
                for cc in range(0, maxc, 2):
                    mr = fbr * 16 + r
                    mc = fbc * 16 + cc
                    sk = skip_grid[mr:min(mr + 2, mi_rows),
                                   mc:min(mc + 2, mi_cols)]
                    if not sk.all():
                        blocks.append((r >> 1, cc >> 1))
            if not blocks:
                continue
            # directions from luma
            y8 = np.stack([
                pristine[0][4 + fbr * 64 + 8 * by:4 + fbr * 64 + 8 * by + 8,
                            4 + fbc * 64 + 8 * bx:4 + fbc * 64 + 8 * bx + 8]
                for (by, bx) in blocks])
            dirs, variances = find_dir_blocks(y8, coeff_shift)
            if num_planes > 1 and ss_x != ss_y:
                # 4:2:2 / 4:4:0 chroma: directions remap to the
                # subsampled geometry (cdef_block.c:361 conv422/conv440)
                conv = (np.array([7, 0, 2, 4, 5, 6, 6, 6]) if ss_x
                        else np.array([1, 2, 2, 2, 3, 4, 6, 0]))
                chroma_dirs = conv[dirs]
            else:
                chroma_dirs = dirs
            for plane in range(num_planes):
                sx = ss_x if plane else 0
                sy = ss_y if plane else 0
                lvl = y_lvl if plane == 0 else uv_lvl
                sec = y_sec if plane == 0 else uv_sec
                if plane and lvl == 0 and sec == 0:
                    continue
                pri_strength = lvl << coeff_shift
                sec_strength = sec << coeff_shift
                dmp = damping + coeff_shift - (1 if plane else 0)
                bw = 8 >> sx
                bh = 8 >> sy
                for bi, (by, bx) in enumerate(blocks):
                    py = (fbr * 64 + 8 * by) >> sy
                    px = (fbc * 64 + 8 * bx) >> sx
                    if plane == 0:
                        t = adjust_strength(pri_strength,
                                            int(variances[bi]))
                    else:
                        t = pri_strength
                    if t == 0 and sec_strength == 0:
                        continue
                    d = int((dirs if plane == 0 else chroma_dirs)[bi]) \
                        if pri_strength else 0
                    inb = pristine[plane][4 + py - 2:4 + py + bh + 2,
                                          4 + px - 2:4 + px + bw + 2]
                    out = filter_block(inb, t, sec_strength, d, dmp, dmp,
                                       bw, bh, coeff_shift)
                    planes[plane][py:py + bh, px:px + bw] = \
                        np.clip(out, 0,
                                (1 << bd) - 1).astype(planes[plane].dtype)
