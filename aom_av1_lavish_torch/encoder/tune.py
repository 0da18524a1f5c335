"""Psy tuning: perceptual rdmult maps (the lavish layer, step 1).

TPU-native re-design of the upstream SSIM tune that the lavish fork's
perceptual tunes build on:
  * av1/encoder/encoder_utils.c:1295 av1_set_mb_ssim_rdmult_scaling —
    per-16x16 scaling factor from local (Wiener-style) variance,
    geometric-mean normalized, applied per superblock
    (encodeframe_utils.c:21 av1_set_ssim_rdmult);
  * the lavish luma-bias sigmoid (partition_search.c:681-700) — rdmult
    lowered in dark regions where quantization noise is most visible.

Both produce a per-block multiplier on lambda; flat/dark areas get a
smaller lambda (more bits, fewer artifacts), busy areas a larger one.
The whole map is one vectorized pass over the source — no per-block
loops.
"""

from __future__ import annotations

import numpy as np


def _block_reduce(x, b, fn):
    H, W = x.shape
    Hc, Wc = H // b * b, W // b * b
    v = x[:Hc, :Wc].reshape(Hc // b, b, Wc // b, b)
    return fn(v, (1, 3))


def ssim_rdmult_map(src_y, block: int = 16) -> np.ndarray:
    """Per-block lambda multipliers from local variance (SSIM tune).

    Matches the reference's shape (encoder_utils.c:1295
    av1_set_mb_ssim_rdmult_scaling): mean of 8x8 per-pixel variances in
    each 16x16, mapped through the saturating exponential fit
    67.035434*(1-exp(-0.0021489*var))+17.492222 (range ~[17.5, 84.5]),
    then divided by the geometric mean so frame-average rdmult is
    preserved."""
    x = src_y.astype(np.float64)
    sub = 8
    mean8 = _block_reduce(x, sub, np.mean)
    ex28 = _block_reduce(x * x, sub, np.mean)
    var8 = np.maximum(ex28 - mean8 * mean8, 0.0)
    r = block // sub
    var = _block_reduce(var8, r, np.mean) if r > 1 else var8
    factor = 67.035434 * (1.0 - np.exp(-0.0021489 * var)) + 17.492222
    geo = np.exp(np.mean(np.log(factor)))
    return factor / geo


def luma_bias_map(src_y, block: int = 16, strength: float = 1.0,
                  midpoint: float = 128.0) -> np.ndarray:
    """Lavish luma-bias sigmoid: darker blocks get a lower lambda.

    multiplier = 1 / (1 + strength * sigmoid((mid - luma) / 32) - s/2)
    normalized to mean 1 so the operating point is bitrate-neutral."""
    x = src_y.astype(np.float64)
    mean = _block_reduce(x, block, np.mean)
    sig = 1.0 / (1.0 + np.exp((mean - midpoint) / 32.0))
    mult = 1.0 / (1.0 + strength * (sig - 0.5))
    return mult / mult.mean()


def saliency_map(src_y, block: int = 16) -> np.ndarray:
    """Spectral-residual saliency (Hou & Zhang 2007), the classic model
    behind av1/encoder/saliency_map.c's CNN: suppress the average log
    spectrum, keep the residual, and the inverse transform's energy
    marks the visually salient regions.  Returns per-block weights."""
    x = src_y.astype(np.float64)
    spec = np.fft.fft2(x)
    logamp = np.log(np.abs(spec) + 1e-9)
    # 3x3 mean of the log spectrum
    k = np.ones((3, 3)) / 9.0
    pad = np.pad(logamp, 1, mode="wrap")
    avg = sum(pad[i:i + logamp.shape[0], j:j + logamp.shape[1]] * k[i, j]
              for i in range(3) for j in range(3))
    resid = logamp - avg
    sal = np.abs(np.fft.ifft2(np.exp(resid + 1j * np.angle(spec)))) ** 2
    # smooth + per-block mean
    sal = sum(np.roll(np.roll(sal, i, 0), j, 1)
              for i in (-1, 0, 1) for j in (-1, 0, 1)) / 9.0
    return _block_reduce(sal, block, np.mean)


def saliency_rdmult_map(src_y, block: int = 16,
                        strength: float = 0.5) -> np.ndarray:
    """Salient blocks get a lower lambda (av1_set_saliency_map +
    av1_setup_sm_rdmult analog), normalized rate-neutral."""
    sal = saliency_map(src_y, block)
    n = sal / (sal.mean() + 1e-12)
    mult = 1.0 / (1.0 + strength * np.tanh(n - 1.0))
    return mult / mult.mean()


def combined_rdmult_map(src_y, tune: str = "psnr", block: int = 16,
                        luma_bias: float = 0.0,
                        saliency: float = 0.0):
    """Build the per-block lambda map for a tune setting, or None for
    plain PSNR tuning with no luma bias."""
    if tune == "psnr" and luma_bias == 0.0 and saliency == 0.0:
        return None
    m = np.ones(((src_y.shape[0] // block) or 1,
                 (src_y.shape[1] // block) or 1))
    if tune == "ssim":
        m = m * ssim_rdmult_map(src_y, block)
    if luma_bias > 0.0:
        m = m * luma_bias_map(src_y, block, strength=luma_bias)
    if saliency > 0.0:
        s = saliency_rdmult_map(src_y, block, strength=saliency)
        hh = min(m.shape[0], s.shape[0])
        ww = min(m.shape[1], s.shape[1])
        m[:hh, :ww] *= s[:hh, :ww]
    return m
