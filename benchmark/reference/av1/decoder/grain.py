"""Film grain synthesis (AV1 spec 7.18.3; reference
av1/decoder/grain_synthesis.c:972 av1_add_film_grain).

Design: the reference walks 32x32 blocks with pointer-carried overlap
line/column buffers.  Here the whole frame's noise plane is assembled
first — per-stripe patch placement with vectorized overlap blends —
and the scaling application (LUT gather + multiply + shift + clip) runs
as one elementwise pass over each plane.  Template generation (LFSR +
AR filter over a 73x82 block) is inherently serial and tiny, so it runs
on host and is cached per parameter set.

The 2048-entry gaussian sequence is normative data, extracted
programmatically by tools/extract_gaussian.py.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field, fields

import numpy as np

_GAUSS = None


def _gaussian():
    global _GAUSS
    if _GAUSS is None:
        path = os.path.join(os.path.dirname(__file__), "..", "..",
                            "data", "gaussian_sequence.npy")
        _GAUSS = np.load(os.path.abspath(path))
    return _GAUSS


@dataclass
class FilmGrainParams:
    """aom_film_grain_t analog (aom/internal/aom_image_internal.h)."""
    apply_grain: int = 0
    random_seed: int = 0
    update_parameters: int = 1
    num_y_points: int = 0
    scaling_points_y: tuple = ()
    chroma_scaling_from_luma: int = 0
    num_cb_points: int = 0
    scaling_points_cb: tuple = ()
    num_cr_points: int = 0
    scaling_points_cr: tuple = ()
    scaling_shift: int = 8
    ar_coeff_lag: int = 0
    ar_coeffs_y: tuple = ()
    ar_coeffs_cb: tuple = ()
    ar_coeffs_cr: tuple = ()
    ar_coeff_shift: int = 6
    grain_scale_shift: int = 0
    cb_mult: int = 0
    cb_luma_mult: int = 0
    cb_offset: int = 0
    cr_mult: int = 0
    cr_luma_mult: int = 0
    cr_offset: int = 0
    overlap_flag: int = 0
    clip_to_restricted_range: int = 0
    bit_depth: int = 8

    def key(self):
        """Cache key over everything that shapes the noise planes."""
        return tuple(getattr(self, f.name) for f in fields(self))


# ---------------------------------------------------------------------------
# Pseudo-random generator (grain_synthesis.c:434 get_random_number)
# ---------------------------------------------------------------------------


class _Lfsr:
    __slots__ = ("reg",)

    def __init__(self, reg: int):
        self.reg = reg & 0xFFFF

    def seed_row(self, luma_line: int, seed: int) -> None:
        """init_random_generator (grain_synthesis.c:444)."""
        luma_num = luma_line >> 5
        reg = seed & 0xFFFF
        reg ^= ((luma_num * 37 + 178) & 255) << 8
        reg ^= (luma_num * 173 + 105) & 255
        self.reg = reg

    def bits(self, n: int) -> int:
        r = self.reg
        bit = (r ^ (r >> 1) ^ (r >> 3) ^ (r >> 12)) & 1
        r = ((r >> 1) | (bit << 15)) & 0xFFFF
        self.reg = r
        return (r >> (16 - n)) & ((1 << n) - 1)

    def gauss_block(self, shape, gshift: int) -> np.ndarray:
        g = _gaussian()
        n = shape[0] * shape[1]
        idx = np.empty(n, np.int32)
        for k in range(n):
            idx[k] = self.bits(11)
        half = (1 << gshift) >> 1
        return ((g[idx].astype(np.int32) + half) >> gshift).reshape(shape)


# ---------------------------------------------------------------------------
# Grain template generation (73x82 luma / 38x44 chroma for 4:2:0)
# ---------------------------------------------------------------------------

_PAD = 3          # left/right/top padding, == ar_padding


def _ar_coeff_grid(coeffs, lag: int) -> np.ndarray:
    """AR taps as a (lag+1, 2*lag+1) int64 window grid; the causal scan
    covers rows -lag..-1 fully plus row 0 cols -lag..-1."""
    grid = np.zeros((lag + 1, 2 * lag + 1), np.int64)
    k = 0
    for row in range(lag):
        for col in range(2 * lag + 1):
            grid[row, col] = coeffs[k]
            k += 1
    for col in range(lag):
        grid[lag, col] = coeffs[k]
        k += 1
    return grid


def _ar_filter(blk: np.ndarray, grid: np.ndarray, lag: int,
               shift: int, gmin: int, gmax: int,
               luma_aux=None, luma_coeff: int = 0,
               sub_x: int = 0, sub_y: int = 0) -> None:
    """In-place causal AR filter over the template interior.  luma_aux
    (chroma path) adds luma_coeff * avg collocated luma per position."""
    H, W = blk.shape
    rnd = 1 << (shift - 1)
    b = blk.astype(np.int64)
    for i in range(_PAD, H):
        for j in range(_PAD, W - _PAD):
            w = b[i - lag:i + 1, j - lag:j + lag + 1]
            wsum = int((w * grid).sum())
            if luma_aux is not None:
                ly = ((i - _PAD) << sub_y) + _PAD
                lx = ((j - _PAD) << sub_x) + _PAD
                av = int(luma_aux[ly:ly + sub_y + 1,
                                  lx:lx + sub_x + 1].sum())
                nsamp = 1 << (sub_x + sub_y)
                av = (av + (nsamp >> 1)) >> (sub_x + sub_y)
                wsum += luma_coeff * av
            v = int(b[i, j]) + ((wsum + rnd) >> shift)
            b[i, j] = min(max(v, gmin), gmax)
    blk[:] = b.astype(np.int32)


_TEMPLATE_CACHE = {}


def _grain_templates(p: FilmGrainParams, sub_x: int, sub_y: int):
    """Returns (luma_tmpl, cb_tmpl, cr_tmpl) int32 arrays (zeros when a
    plane carries no grain).  generate_luma_grain_block /
    generate_chroma_grain_blocks (grain_synthesis.c:459/498)."""
    ck = (p.key(), sub_x, sub_y)
    if ck in _TEMPLATE_CACHE:
        return _TEMPLATE_CACHE[ck]
    bd = p.bit_depth
    gshift = 12 - bd + p.grain_scale_shift
    center = 128 << (bd - 8)
    gmin, gmax = -center, center - 1
    lag = p.ar_coeff_lag

    lsize_y = _PAD + 2 * _PAD + 64              # 73
    lsize_x = _PAD + 2 * _PAD + 64 + 2 * _PAD + _PAD   # 82
    luma = np.zeros((lsize_y, lsize_x), np.int32)
    rng = _Lfsr(p.random_seed)
    if p.num_y_points > 0:
        luma = rng.gauss_block((lsize_y, lsize_x), gshift)
        # reference runs the AR pass even at lag 0 (it still clamps the
        # template interior), so always filter
        _ar_filter(luma, _ar_coeff_grid(p.ar_coeffs_y, lag), lag,
                   p.ar_coeff_shift, gmin, gmax)

    csize_y = _PAD + (2 >> sub_y) * _PAD + (64 >> sub_y)
    csize_x = (_PAD + (2 >> sub_x) * _PAD + (64 >> sub_x)
               + (2 >> sub_x) * _PAD + _PAD)
    cb = np.zeros((csize_y, csize_x), np.int32)
    cr = np.zeros((csize_y, csize_x), np.int32)
    want_cb = p.num_cb_points or p.chroma_scaling_from_luma
    want_cr = p.num_cr_points or p.chroma_scaling_from_luma
    if want_cb:
        rng.seed_row(7 << 5, p.random_seed)
        cb = rng.gauss_block((csize_y, csize_x), gshift)
    if want_cr:
        rng.seed_row(11 << 5, p.random_seed)
        cr = rng.gauss_block((csize_y, csize_x), gshift)
    if (want_cb or want_cr) and (lag or p.num_y_points):
        grid = None
        for tmpl, coeffs, want in ((cb, p.ar_coeffs_cb, want_cb),
                                   (cr, p.ar_coeffs_cr, want_cr)):
            if not want:
                continue
            grid = _ar_coeff_grid(coeffs, lag)
            luma_coeff = (coeffs[2 * lag * (lag + 1)]
                          if p.num_y_points > 0 else 0)
            _ar_filter(tmpl, grid, lag, p.ar_coeff_shift, gmin, gmax,
                       luma_aux=luma if p.num_y_points > 0 else None,
                       luma_coeff=luma_coeff, sub_x=sub_x, sub_y=sub_y)
    _TEMPLATE_CACHE[ck] = (luma, cb, cr)
    if len(_TEMPLATE_CACHE) > 64:
        _TEMPLATE_CACHE.pop(next(iter(_TEMPLATE_CACHE)))
    return luma, cb, cr


# ---------------------------------------------------------------------------
# Scaling LUTs (grain_synthesis.c:595 init_scaling_function)
# ---------------------------------------------------------------------------


def _scaling_lut(points) -> np.ndarray:
    lut = np.zeros(256, np.int32)
    n = len(points)
    if n == 0:
        return lut
    lut[:points[0][0]] = points[0][1]
    for k in range(n - 1):
        x0, y0 = points[k]
        x1, y1 = points[k + 1]
        dx = x1 - x0
        delta = (y1 - y0) * ((65536 + (dx >> 1)) // dx)
        xs = np.arange(dx, dtype=np.int64)
        lut[x0:x1] = y0 + ((xs * delta + 32768) >> 16)
    lut[points[n - 1][0]:] = points[n - 1][1]
    return lut


# ---------------------------------------------------------------------------
# Noise plane assembly (spec 7.18.3.3; replaces the reference's
# line/column overlap buffers with whole-stripe vectorized blends)
# ---------------------------------------------------------------------------


def _blend_cols(left, right, n, gmin, gmax):
    """ver_boundary_overlap (grain_synthesis.c:899)."""
    if n == 1:
        out = (left * 23 + right * 22 + 16) >> 5
    else:
        out = np.empty_like(right)
        out[:, 0] = (27 * left[:, 0] + 17 * right[:, 0] + 16) >> 5
        out[:, 1] = (17 * left[:, 1] + 27 * right[:, 1] + 16) >> 5
    return np.clip(out, gmin, gmax)


def _blend_rows(top, bottom, n, gmin, gmax):
    """hor_boundary_overlap (grain_synthesis.c:937)."""
    if n == 1:
        out = (top * 23 + bottom * 22 + 16) >> 5
    else:
        out = np.empty_like(bottom)
        out[0] = (27 * top[0] + 17 * bottom[0] + 16) >> 5
        out[1] = (17 * top[1] + 27 * bottom[1] + 16) >> 5
    return np.clip(out, gmin, gmax)


def _noise_plane(tmpl, offsets, width, height, sub_x, sub_y,
                 overlap, gmin, gmax) -> np.ndarray:
    """Assemble one plane's full noise image from the template.
    offsets: list of per-stripe lists of (offset_y, offset_x)."""
    blk_y, blk_x = 32 >> sub_y, 32 >> sub_x
    ov_y, ov_x = 2 >> sub_y, 2 >> sub_x
    o_base_y = _PAD + (2 >> sub_y) * _PAD
    o_base_x = _PAD + (2 >> sub_x) * _PAD
    noise = np.zeros((height, width), np.int32)
    prev_stripe = None
    for m, row_offsets in enumerate(offsets):
        y0 = m * blk_y
        rows = min(blk_y + ov_y, height - y0)
        stripe = np.zeros((blk_y + ov_y, width + ov_x), np.int32)
        for j, (oy, ox) in enumerate(row_offsets):
            x0 = j * blk_x
            ty = o_base_y + oy * (2 >> sub_y)
            tx = o_base_x + ox * (2 >> sub_x)
            patch = tmpl[ty:ty + rows, tx:tx + blk_x + ov_x]
            cols = min(blk_x + ov_x, width + ov_x - x0)
            if overlap and j:
                stripe[:rows, x0:x0 + ov_x] = _blend_cols(
                    stripe[:rows, x0:x0 + ov_x],
                    patch[:, :ov_x], ov_x, gmin, gmax)
                stripe[:rows, x0 + ov_x:x0 + cols] = \
                    patch[:, ov_x:cols]
            else:
                stripe[:rows, x0:x0 + cols] = patch[:, :cols]
        body = min(blk_y, height - y0)
        if overlap and m:
            noise[y0:y0 + ov_y] = _blend_rows(
                prev_stripe[blk_y:blk_y + ov_y, :width],
                stripe[:ov_y, :width], ov_y, gmin, gmax)
            noise[y0 + ov_y:y0 + body] = stripe[ov_y:body, :width]
        else:
            noise[y0:y0 + body] = stripe[:body, :width]
        prev_stripe = stripe
    return noise


def _block_offsets(seed: int, width: int, height: int):
    """Per-stripe per-block (offset_y, offset_x) draws; one rand(8) per
    32x32 luma block, row RNG reseeded per stripe
    (grain_synthesis.c:1175)."""
    rng = _Lfsr(seed)
    out = []
    for y in range(0, height // 2, 16):
        rng.seed_row(y * 2, seed)
        row = []
        for _x in range(0, width // 2, 16):
            r = rng.bits(8)
            row.append((r & 15, (r >> 4) & 15))
        out.append(row)
    return out


# ---------------------------------------------------------------------------
# Application (add_noise_to_block, grain_synthesis.c:641 — full-plane)
# ---------------------------------------------------------------------------


def apply_film_grain(p: FilmGrainParams, planes, sub_x: int = 1,
                     sub_y: int = 1, mc_identity: bool = False):
    """Returns grained copies of (y, u, v) uint8 planes (u/v may be
    None for monochrome).  av1_add_film_grain analog, 8-bit."""
    if not p.apply_grain:
        return planes
    y, u, v = planes
    mono = u is None
    oh, ow = y.shape
    height, width = oh + (oh & 1), ow + (ow & 1)
    yp = np.pad(y, ((0, height - oh), (0, width - ow)), mode="edge") \
        .astype(np.int32)
    cb = cr = None
    if not mono:
        ch, cw = (height + sub_y) >> sub_y, (width + sub_x) >> sub_x
        cb = np.pad(u, ((0, ch - u.shape[0]), (0, cw - u.shape[1])),
                    mode="edge").astype(np.int32)
        cr = np.pad(v, ((0, ch - v.shape[0]), (0, cw - v.shape[1])),
                    mode="edge").astype(np.int32)

    center = 128 << (p.bit_depth - 8)
    gmin, gmax = -center, center - 1
    ltmpl, cbtmpl, crtmpl = _grain_templates(p, sub_x, sub_y)
    offsets = _block_offsets(p.random_seed, width, height)
    rnd = 1 << (p.scaling_shift - 1)

    if p.clip_to_restricted_range:
        min_l, max_l = 16, 235
        min_c, max_c = (16, 235) if mc_identity else (16, 240)
    else:
        min_l, max_l, min_c, max_c = 0, 255, 0, 255

    apply_y = p.num_y_points > 0
    apply_c = (not mono) and (p.num_cb_points or p.num_cr_points
                              or p.chroma_scaling_from_luma)

    out_cb, out_cr = cb, cr
    if apply_c:
        lut_y = _scaling_lut(p.scaling_points_y)
        if p.chroma_scaling_from_luma:
            lut_cb = lut_cr = lut_y
            cb_mult = cr_mult = 0
            cb_lmult = cr_lmult = 64
            cb_off = cr_off = 0
        else:
            lut_cb = _scaling_lut(p.scaling_points_cb)
            lut_cr = _scaling_lut(p.scaling_points_cr)
            cb_mult, cb_lmult = p.cb_mult - 128, p.cb_luma_mult - 128
            cr_mult, cr_lmult = p.cr_mult - 128, p.cr_luma_mult - 128
            cb_off, cr_off = p.cb_offset - 256, p.cr_offset - 256
        ch, cw = cb.shape
        # average collocated (pre-grain) luma per chroma sample
        ys = yp[::(1 << sub_y), :]
        if sub_x:
            avg = (ys[:, 0::2] + ys[:, 1::2] + 1) >> 1
        else:
            avg = ys
        avg = avg[:ch, :cw]
        for plane, tmpl, lut, mult, lmult, off, npts in (
                ("cb", cbtmpl, lut_cb, cb_mult, cb_lmult, cb_off,
                 p.num_cb_points),
                ("cr", crtmpl, lut_cr, cr_mult, cr_lmult, cr_off,
                 p.num_cr_points)):
            if not (npts or p.chroma_scaling_from_luma):
                continue
            src = cb if plane == "cb" else cr
            noise = _noise_plane(tmpl, offsets, cw, ch, sub_x, sub_y,
                                 p.overlap_flag, gmin, gmax)
            merged = np.clip(((avg * lmult + mult * src) >> 6) + off,
                             0, 255)
            grained = np.clip(
                src + ((lut[merged] * noise + rnd) >> p.scaling_shift),
                min_c, max_c)
            if plane == "cb":
                out_cb = grained
            else:
                out_cr = grained

    out_y = yp
    if apply_y:
        lut_y = _scaling_lut(p.scaling_points_y)
        noise_y = _noise_plane(ltmpl, offsets, width, height, 0, 0,
                               p.overlap_flag, gmin, gmax)
        out_y = np.clip(
            yp + ((lut_y[yp] * noise_y + rnd) >> p.scaling_shift),
            min_l, max_l)

    yr = out_y[:oh, :ow].astype(np.uint8)
    if mono:
        return yr, None, None
    return (yr, out_cb[:u.shape[0], :u.shape[1]].astype(np.uint8),
            out_cr[:v.shape[0], :v.shape[1]].astype(np.uint8))
