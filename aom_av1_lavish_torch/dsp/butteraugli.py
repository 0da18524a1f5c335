"""Psychovisual difference maps for perceptual tuning.

Re-designs the metric layer behind the reference's tune_butteraugli.c /
tune_vmaf.c.  The reference links external libraries (libjxl
butteraugli, libvmaf); this stack ships self-contained vectorized
approximations built on the same principles:

 * butteraugli_map: multi-scale contrast difference with activity
   masking (high-frequency errors in smooth areas dominate the score,
   as in butteraugli's XYB/masking model)
 * vif_map: variance-based visual information fidelity (the main VMAF
   elementary metric) per scale

Both return per-block maps used to scale rdmult the same way the
reference's av1_set_mb_butteraugli_rdmult_scaling does.
"""

from __future__ import annotations

import numpy as np


def _blur(x: np.ndarray, radius: int) -> np.ndarray:
    """Box blur (separable, edge-clamped)."""
    if radius <= 0:
        return x
    k = 2 * radius + 1
    pad = np.pad(x, radius, mode="edge")
    c = np.cumsum(pad, axis=0)
    v = (c[k - 1:] - np.concatenate(
        [np.zeros((1, c.shape[1])), c[:-k]], axis=0)) / k
    c = np.cumsum(v, axis=1)
    return (c[:, k - 1:] - np.concatenate(
        [np.zeros((c.shape[0], 1)), c[:, :-k]], axis=1)) / k


def _block_mean(x: np.ndarray, b: int) -> np.ndarray:
    h, w = x.shape
    hb, wb = h // b, w // b
    return x[:hb * b, :wb * b].reshape(hb, b, wb, b).mean(axis=(1, 3))


def butteraugli_map(src: np.ndarray, rec: np.ndarray,
                    block: int = 16) -> np.ndarray:
    """Per-block psychovisual difference (higher = more visible)."""
    a = src.astype(np.float64)
    b = rec.astype(np.float64)
    # activity mask: local contrast of the source at a fine scale
    act = _blur(np.abs(a - _blur(a, 1)), 2)
    total = np.zeros_like(a)
    for radius, weight in ((0, 1.0), (1, 0.65), (3, 0.45)):
        da = _blur(a, radius)
        db = _blur(b, radius)
        d = np.abs(da - db)
        total += weight * d / (1.0 + 0.45 * act)
    # cubic block norm: the scalar score is a 3-norm, so the per-block
    # stat must emphasize peaks the same way or the rdmult map trades
    # away exactly the pixels the score penalizes hardest
    return _block_mean(total ** 3, block) ** (1.0 / 3.0)


def butteraugli_score(src: np.ndarray, rec: np.ndarray) -> float:
    """Scalar distance (3-norm over the pixel map, butteraugli-style)."""
    m = butteraugli_map(src, rec, block=8)
    return float((m ** 3).mean() ** (1.0 / 3.0))


def vif_map(src: np.ndarray, rec: np.ndarray, block: int = 16,
            sigma_n: float = 2.0) -> np.ndarray:
    """Per-block VIF-style fidelity loss (higher = more information
    lost), the dominant VMAF elementary metric."""
    a = src.astype(np.float64)
    b = rec.astype(np.float64)
    loss = np.zeros_like(a)
    for radius in (1, 2, 4):
        mu_a = _blur(a, radius)
        mu_b = _blur(b, radius)
        var_a = np.maximum(_blur(a * a, radius) - mu_a ** 2, 0.0)
        cov = _blur(a * b, radius) - mu_a * mu_b
        g = cov / (var_a + 1e-3)
        var_b = np.maximum(_blur(b * b, radius) - mu_b ** 2, 0.0)
        sv = np.maximum(var_b - g * cov, 0.0)
        num = np.log2(1.0 + g * g * var_a / (sv + sigma_n))
        den = np.log2(1.0 + var_a / sigma_n)
        loss += np.where(den > 1e-6, 1.0 - num / np.maximum(den, 1e-6),
                         0.0)
    return _block_mean(loss / 3.0, block)


def perceptual_rdmult_map(src: np.ndarray, rec: np.ndarray,
                          metric: str = "butteraugli",
                          block: int = 16) -> np.ndarray:
    """rdmult multipliers from a trial recon
    (av1_set_mb_butteraugli_rdmult_scaling / tune_vmaf analog):
    blocks where the metric sees more damage than MSE explains get a
    lower lambda (more bits)."""
    fn = butteraugli_map if metric == "butteraugli" else vif_map
    p = fn(src, rec, block)
    d = (src.astype(np.float64) - rec.astype(np.float64)) ** 2
    mse = _block_mean(d, block)
    # tune_butteraugli.c:210-271 flow (weight from mse-vs-metric, eps
    # blocks neutral, geometric-mean normalized, rdmult *= weight) with
    # a gradient-aware exponent: the scalar objective is a 3-norm of the
    # block map, so the per-block marginal is d(sum p^3)/d(mse_i)
    # ~ p_i^3 / mse_i, and equalizing metric-improvement per bit wants
    # lambda_i proportional to mse_i / p_i^3
    eps = 1e-2
    valid = (p >= eps) & (mse >= eps)
    w = np.where(valid, mse / np.maximum(p, eps) ** 3, 1.0)
    if valid.any():
        geo = np.exp(np.mean(np.log(w[valid])))
    else:
        geo = 1.0
    # half-strength application (butteraugli_rd_mult=50-class): at fixed
    # base q the lambda redistribution cannot move bits between blocks,
    # so a full-strength map over-penalizes masked blocks
    w = np.where(valid, np.sqrt(w / geo), 1.0)
    return np.clip(w, 0.5, 2.0)
