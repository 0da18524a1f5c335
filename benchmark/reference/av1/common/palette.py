"""Palette mode: color cache, color-index contexts, map coding.

Reference behavior: av1/decoder/decodemv.c:477 read_palette_colors_y /
read_palette_colors_uv / read_palette_mode_info,
av1/common/pred_common.c:73 av1_get_palette_cache,
av1/common/entropymode.c:893 av1_get_palette_color_index_context,
av1/decoder/detokenize.c:25 decode_color_map_tokens.
"""

from __future__ import annotations

import numpy as np

PALETTE_MAX_SIZE = 8
PALETTE_MIN_SIZE = 2
NUM_PALETTE_NEIGHBORS = 3

# entropymode.c:891 av1_palette_color_index_context_lookup
_CTX_HASH_LOOKUP = (-1, -1, 0, -1, -1, 4, 3, 2, 1)


def palette_bsize_ctx(bsize: int) -> int:
    """av1_get_palette_bsize_ctx: num_pels_log2 - num_pels_log2(8x8)."""
    from . import blockd
    n = (blockd.block_wide(bsize) * blockd.block_high(bsize))
    return n.bit_length() - 1 - 6


def palette_mode_ctx(above_bi, left_bi) -> int:
    ctx = 0
    if above_bi is not None:
        ctx += int(above_bi.palette_size[0] > 0)
    if left_bi is not None:
        ctx += int(left_bi.palette_size[0] > 0)
    return ctx


def get_palette_cache(above_bi, left_bi, plane: int) -> list:
    """av1_get_palette_cache: merge-sort-dedup of neighbor palettes.
    Caller is responsible for the SB-row gating of above_bi."""
    p = int(plane != 0)
    above = (above_bi.palette_colors[1][:above_bi.palette_size[1]]
             if above_bi is not None and above_bi.palette_colors is not None
             and above_bi.palette_size[p] else []) if p else \
        (above_bi.palette_colors[0][:above_bi.palette_size[0]]
         if above_bi is not None and above_bi.palette_colors is not None
         and above_bi.palette_size[0] else [])
    left = (left_bi.palette_colors[1][:left_bi.palette_size[1]]
            if left_bi is not None and left_bi.palette_colors is not None
            and left_bi.palette_size[p] else []) if p else \
        (left_bi.palette_colors[0][:left_bi.palette_size[0]]
         if left_bi is not None and left_bi.palette_colors is not None
         and left_bi.palette_size[0] else [])
    above = list(above)
    left = list(left)
    cache = []

    def add(v):
        if cache and cache[-1] == v:
            return
        cache.append(v)

    ai = li = 0
    while ai < len(above) and li < len(left):
        va, vl = above[ai], left[li]
        if vl < va:
            add(vl)
            li += 1
        else:
            add(va)
            ai += 1
            if vl == va:
                li += 1
    while ai < len(above):
        add(above[ai])
        ai += 1
    while li < len(left):
        add(left[li])
        li += 1
    return cache


def ceil_log2(n: int) -> int:
    if n < 2:
        return 0
    return (n - 1).bit_length()


def read_uniform(rd, n: int) -> int:
    """read_uniform (decodemv.c): spec ns(n), w = FloorLog2(n) + 1."""
    l_ = n.bit_length()
    m = (1 << l_) - n
    v = rd.decode_literal(l_ - 1)
    if v < m:
        return v
    return (v << 1) - m + rd.decode_literal(1)


def read_palette_colors_y(rd, bd, n, cache):
    colors = []
    cached = []
    for v in cache:
        if len(cached) >= n:
            break
        if rd.decode_literal(1):
            cached.append(v)
    idx = len(cached)
    if idx < n:
        colors.append(rd.decode_literal(bd))
        idx += 1
        if idx < n:
            min_bits = bd - 3
            bits = min_bits + rd.decode_literal(2)
            rng = (1 << bd) - colors[-1] - 1
            while idx < n:
                delta = rd.decode_literal(bits) + 1
                v = min(max(colors[-1] + delta, 0), (1 << bd) - 1)
                rng -= (v - colors[-1])
                colors.append(v)
                bits = min(bits, ceil_log2(rng))
                idx += 1
    return _merge_colors(cached, colors, n)


def read_palette_colors_u(rd, bd, n, cache):
    colors = []
    cached = []
    for v in cache:
        if len(cached) >= n:
            break
        if rd.decode_literal(1):
            cached.append(v)
    idx = len(cached)
    if idx < n:
        colors.append(rd.decode_literal(bd))
        idx += 1
        if idx < n:
            min_bits = bd - 3
            bits = min_bits + rd.decode_literal(2)
            rng = (1 << bd) - colors[-1]
            while idx < n:
                delta = rd.decode_literal(bits)
                v = min(max(colors[-1] + delta, 0), (1 << bd) - 1)
                rng -= (v - colors[-1])
                colors.append(v)
                bits = min(bits, ceil_log2(rng))
                idx += 1
    return _merge_colors(cached, colors, n)


def read_palette_colors_v(rd, bd, n):
    out = []
    if rd.decode_literal(1):  # delta encoding
        min_bits = bd - 4
        max_val = 1 << bd
        bits = min_bits + rd.decode_literal(2)
        out.append(rd.decode_literal(bd))
        for _ in range(1, n):
            delta = rd.decode_literal(bits)
            if delta and rd.decode_literal(1):
                delta = -delta
            v = out[-1] + delta
            if v < 0:
                v += max_val
            if v >= max_val:
                v -= max_val
            out.append(v)
    else:
        for _ in range(n):
            out.append(rd.decode_literal(bd))
    return out


def _merge_colors(cached, trans, n):
    """merge_colors (decodemv.c:462)."""
    out = []
    ci = ti = 0
    for _ in range(n):
        if ci < len(cached) and (ti >= len(trans)
                                 or cached[ci] <= trans[ti]):
            out.append(cached[ci])
            ci += 1
        else:
            out.append(trans[ti])
            ti += 1
    return out


def color_index_context(color_map, r, c_, n, color_order):
    """av1_get_palette_color_index_context; fills color_order and
    returns ctx."""
    neighbors = (
        int(color_map[r, c_ - 1]) if c_ - 1 >= 0 else -1,
        int(color_map[r - 1, c_ - 1]) if (c_ - 1 >= 0 and r - 1 >= 0)
        else -1,
        int(color_map[r - 1, c_]) if r - 1 >= 0 else -1,
    )
    weights = (2, 1, 2)
    scores = [0] * (PALETTE_MAX_SIZE + 2)
    for nb, w in zip(neighbors, weights):
        if nb >= 0:
            scores[nb] += w
    for i in range(PALETTE_MAX_SIZE):
        color_order[i] = i
    # partial selection sort of the top 3 (stable shift semantics)
    for i in range(NUM_PALETTE_NEIGHBORS):
        mx = scores[i]
        mi_ = i
        for j in range(i + 1, n):
            if scores[j] > mx:
                mx = scores[j]
                mi_ = j
        if mi_ != i:
            mcol = color_order[mi_]
            for k in range(mi_, i, -1):
                scores[k] = scores[k - 1]
                color_order[k] = color_order[k - 1]
            scores[i] = mx
            color_order[i] = mcol
    h = scores[0] * 1 + scores[1] * 2 + scores[2] * 2
    return _CTX_HASH_LOOKUP[h]


# ---------------------------------------------------------------------------
# Encoder side (av1/encoder/palette.c, bitstream.c:683-804)

def write_uniform(sink, n: int, v: int) -> None:
    """write_uniform (bitstream.c): inverse of read_uniform, via raw bits."""
    l_ = n.bit_length()
    m = (1 << l_) - n

    def lit(val, bits):
        for k in range(bits - 1, -1, -1):
            sink.bit((val >> k) & 1)

    if v < m:
        lit(v, l_ - 1)
    else:
        lit((v + m) >> 1, l_ - 1)
        sink.bit((v + m) & 1)


def index_color_cache(cache, colors):
    """av1_index_color_cache (palette.c:78): per-cache-entry found flags
    plus the out-of-cache colors (in palette order)."""
    if not cache:
        return [], list(colors)
    found = [0] * len(cache)
    in_cache = [0] * len(colors)
    n_in = 0
    for i, cv in enumerate(cache):
        if n_in >= len(colors):
            break
        for j, v in enumerate(colors):
            if v == cv and not in_cache[j]:
                in_cache[j] = 1
                found[i] = 1
                n_in += 1
                break
    out = [v for j, v in enumerate(colors) if not in_cache[j]]
    return found, out


def delta_encode_colors(sink, colors, bd: int, min_val: int) -> None:
    """delta_encode_palette_colors (bitstream.c:650)."""
    def lit(val, bits):
        for k in range(bits - 1, -1, -1):
            sink.bit((val >> k) & 1)

    if not colors:
        return
    lit(colors[0], bd)
    if len(colors) == 1:
        return
    deltas = [colors[i] - colors[i - 1] for i in range(1, len(colors))]
    min_bits = bd - 3
    bits = max(ceil_log2(max(deltas) + 1 - min_val), min_bits)
    rng = (1 << bd) - colors[0] - min_val
    lit(bits - min_bits, 2)
    for d in deltas:
        lit(d - min_val, bits)
        rng -= d
        bits = min(bits, ceil_log2(rng))


def write_palette_colors_y(sink, colors, bd: int, cache) -> None:
    """write_palette_colors_y (bitstream.c:683)."""
    found, out = index_color_cache(cache, colors)
    n_in = 0
    for f in found:
        if n_in >= len(colors):
            break
        sink.bit(f)
        n_in += f
    delta_encode_colors(sink, out, bd, 1)


def encode_color_map(sink, cdf_name, n: int, cmap, rows: int,
                     cols: int) -> None:
    """pack_map_tokens (bitstream.c:350): wavefront order, order-token
    symbols against palette_*_color_index_cdf[n-2][ctx]."""
    write_uniform(sink, n, int(cmap[0, 0]))
    order = [0] * PALETTE_MAX_SIZE
    for i in range(1, rows + cols - 1):
        for j in range(min(i, cols - 1), max(0, i - rows + 1) - 1, -1):
            ctx = color_index_context(cmap, i - j, j, n, order)
            tok = order.index(int(cmap[i - j, j]))
            sink.symbol(tok, n, cdf_name, n - PALETTE_MIN_SIZE, ctx)


def map_rate_estimate(cmap, rows: int, cols: int, n: int) -> float:
    """Cheap map-bits estimate for RD: per-symbol entropy of the index
    histogram plus the first write_uniform symbol."""
    vals = cmap[:rows, :cols].ravel()
    hist = np.bincount(vals, minlength=n).astype(np.float64)
    p = hist / max(1, hist.sum())
    ent = float(-(p[p > 0] * np.log2(p[p > 0])).sum())
    return n.bit_length() + max(ent, 0.35) * (rows * cols - 1)


def palette_candidates(block, max_size: int = PALETTE_MAX_SIZE):
    """Candidate palettes for one plane block (av1_rd_pick_palette_intra_sby
    analog): the exact color set when small enough, else k-means (Lloyd)
    at a few sizes seeded by quantiles."""
    vals, counts = np.unique(block, return_counts=True)
    if len(vals) < 2:
        return []
    if len(vals) <= max_size:
        return [vals.astype(np.int32)]
    out = []
    flat = block.astype(np.float64).ravel()
    for k in (max_size, max_size - 2, 4):
        if k < 2:
            continue
        cents = np.quantile(flat, (np.arange(k) + 0.5) / k)
        for _ in range(6):  # Lloyd iterations
            idx = np.argmin(np.abs(flat[:, None] - cents[None, :]), axis=1)
            for ci in range(k):
                sel = flat[idx == ci]
                if len(sel):
                    cents[ci] = sel.mean()
        pal = np.unique(np.round(cents).astype(np.int32))
        if len(pal) >= 2:
            out.append(pal)
    return out


# test-visible counter of decoded color maps (conformance tests reset
# this to prove palette blocks were actually exercised by a stream)
STATS = {"maps": 0}


def decode_color_map(rd, cdf_set, n, pw, ph, rows, cols):
    """decode_color_map_tokens: (ph, pw) uint8 map."""
    STATS["maps"] += 1
    cmap = np.zeros((ph, pw), np.uint8)
    cmap[0, 0] = read_uniform(rd, n)
    order = [0] * PALETTE_MAX_SIZE
    for i in range(1, rows + cols - 1):
        for j in range(min(i, cols - 1), max(0, i - rows + 1) - 1, -1):
            ctx = color_index_context(cmap, i - j, j, n, order)
            idx = rd.decode_symbol_adapt(
                cdf_set[n - PALETTE_MIN_SIZE][ctx], n)
            cmap[i - j, j] = order[idx]
    if cols < pw:
        cmap[:rows, cols:] = cmap[:rows, cols - 1:cols]
    if rows < ph:
        cmap[rows:, :] = cmap[rows - 1:rows, :]
    return cmap
