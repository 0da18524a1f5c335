"""Noise estimation + film-grain table fitting (encoder side).

Re-designs the reference pipeline (aom_dsp/noise_model.c
aom_noise_model_update / aom_noise_model_get_grain_parameters,
aom_dsp/noise_util.c aom_noise_psd_get_default_value,
av1/encoder/aq_variance-style flat-block selection) as vectorized numpy:

 1. wiener-style self-denoise in the FFT domain (dsp/fft.py) to expose
    the noise residual,
 2. flat-block selection by local gradient energy,
 3. AR(lag) coefficient fit by least squares over residual neighborhoods,
 4. intensity-binned residual std -> piecewise-linear scaling points,
    calibrated against the synthesis path's unit-grain std.

The output FilmGrainParams round-trips through the frame header and the
normative synthesis in decoder/grain.py.
"""

from __future__ import annotations

import numpy as np

from .fft import block_psd, fft2d, ifft2d


def estimate_noise_std(y: np.ndarray, block: int = 16) -> float:
    """Global noise sigma estimate from the flattest blocks
    (aom_noise_strength estimation analog)."""
    resid, mask = _noise_residual(y, block)
    vals = resid[mask]
    if vals.size < 256:
        return 0.0
    return float(1.4826 * np.median(np.abs(vals - np.median(vals))))


def _noise_residual(y: np.ndarray, block: int = 16):
    """(residual plane, flat-pixel mask) via FFT wiener self-denoise."""
    y = y.astype(np.float64)
    h, w = y.shape
    n = 32
    psd = block_psd(y, n)
    noise_floor = np.percentile(psd.ravel()[1:], 25)
    resid = np.zeros_like(y)
    for by in range(0, h - n + 1, n):
        for bx in range(0, w - n + 1, n):
            blk = y[by:by + n, bx:bx + n]
            mu = blk.mean()
            spec = fft2d(blk - mu)
            p = (spec.real ** 2 + spec.imag ** 2) / (n * n)
            gain = p / np.maximum(p + noise_floor, 1e-9)
            den = ifft2d(spec * gain) + mu
            resid[by:by + n, bx:bx + n] = blk - den
    # flat blocks: low denoised-gradient energy
    gy = np.abs(np.diff(y, axis=0, prepend=y[:1]))
    gx = np.abs(np.diff(y, axis=1, prepend=y[:, :1]))
    grad = gy + gx
    bs = block
    mask = np.zeros_like(y, bool)
    gthr = np.percentile(grad, 60)
    for by in range(0, h - bs + 1, bs):
        for bx in range(0, w - bs + 1, bs):
            if grad[by:by + bs, bx:bx + bs].mean() < gthr:
                mask[by:by + bs, bx:bx + bs] = True
    return resid, mask


def _ar_positions(lag: int):
    """Causal AR neighborhood (noise_model.c:equation_system order)."""
    pos = []
    for dy in range(-lag, 1):
        for dx in range(-lag, lag + 1):
            if dy == 0 and dx >= 0:
                break
            pos.append((dy, dx))
    return pos


def fit_grain_params(y: np.ndarray, lag: int = 2, seed: int = 7391,
                     bit_depth: int = 8):
    """Fit FilmGrainParams for the luma plane; returns None when the
    content carries no measurable grain."""
    from ..decoder.grain import FilmGrainParams

    resid, mask = _noise_residual(np.asarray(y))
    sigma = estimate_noise_std(np.asarray(y))
    if sigma < 0.4:
        return None

    # --- AR coefficients (least squares on flat-area residuals) ---
    pos = _ar_positions(lag)
    h, w = resid.shape
    m = lag
    core = resid[m:h - m, m:w - m]
    cmask = mask[m:h - m, m:w - m]
    cols = [resid[m + dy:h - m + dy, m + dx:w - m + dx][cmask]
            for (dy, dx) in pos]
    A = np.stack(cols, axis=1)
    b = core[cmask]
    coef, *_ = np.linalg.lstsq(A, b, rcond=None)
    ar_shift = 6
    qcoef = np.clip(np.round(coef * (1 << ar_shift)), -128, 127) \
        .astype(int)

    # --- scaling points from intensity-binned residual std ---
    # synthesis: noise = (scaling(px) * G) >> scaling_shift where G is
    # the AR-filtered unit grain; measure G's std from a simulation of
    # the quantized coefficients to calibrate.
    g_std = _grain_std(qcoef, ar_shift, lag, seed, bit_depth)
    yv = np.asarray(y, np.float64)[mask]
    rv = resid[mask]
    scaling_shift = 8
    pts = []
    for lo in range(0, 256, 32):
        sel = (yv >= lo) & (yv < lo + 32)
        if sel.sum() < 200:
            continue
        std = 1.4826 * np.median(np.abs(rv[sel] - np.median(rv[sel])))
        scale = int(round(std / max(g_std, 1e-6) * (1 << scaling_shift)
                          / (1 << (bit_depth - 8))))
        pts.append((min(lo + 16, 255), int(np.clip(scale, 0, 255))))
    if len(pts) < 2 or all(s == 0 for (_, s) in pts):
        return None
    return FilmGrainParams(
        apply_grain=1, random_seed=seed, num_y_points=len(pts),
        scaling_points_y=tuple(pts), chroma_scaling_from_luma=0,
        scaling_shift=scaling_shift, ar_coeff_lag=lag,
        ar_coeffs_y=tuple(int(v) for v in qcoef),
        ar_coeff_shift=ar_shift, overlap_flag=1,
        clip_to_restricted_range=0, bit_depth=bit_depth)


def _grain_std(qcoef, ar_shift: int, lag: int, seed: int,
               bit_depth: int) -> float:
    """Std of the normative luma grain template for these AR coeffs
    (decoder/grain.py synthesis, 64x64 region away from borders)."""
    from ..decoder.grain import FilmGrainParams, _grain_templates
    p = FilmGrainParams(
        apply_grain=1, random_seed=seed, num_y_points=1,
        scaling_points_y=((128, 64),), ar_coeff_lag=lag,
        ar_coeffs_y=tuple(int(v) for v in qcoef),
        ar_coeff_shift=ar_shift, bit_depth=bit_depth)
    g = _grain_templates(p, 1, 1)[0].astype(np.float64)
    inner = g[9:9 + 64, 9:9 + 64]
    return float(inner.std())
