"""RT temporal denoiser + source noise estimation.

Reference behavior: av1/encoder/av1_temporal_denoiser.c
(av1_denoiser_denoise: per-block motion-compensated blend of the source
with the last reconstructed frame, gated by SAD and noise level) and
av1/encoder/av1_noise_estimate.c (av1_noise_estimate_extract: running
estimate of source noise from low-motion flat blocks).

Re-designed as whole-frame vectorized ops: the block SAD gate, the
flat-block mask and the blend all run as single array expressions over
a (n_blocks, b, b) view instead of the reference's per-MB loops.
"""

from __future__ import annotations

import numpy as np

# noise levels (av1_noise_estimate.h)
NOISE_NONE = 0
NOISE_LOW = 1
NOISE_MEDIUM = 2
NOISE_HIGH = 3


def _block_view(y: np.ndarray, b: int):
    h, w = y.shape
    hb, wb = h // b, w // b
    return y[:hb * b, :wb * b].reshape(hb, b, wb, b).swapaxes(1, 2), hb, wb


def estimate_noise_level(src_y: np.ndarray, prev_y: np.ndarray | None,
                         b: int = 16):
    """av1_noise_estimate_extract analog: spatial variance of temporally
    static, spatially flat blocks -> (level, sigma)."""
    y = np.asarray(src_y, np.float64)
    blocks, hb, wb = _block_view(y, b)
    var = blocks.var(axis=(2, 3))
    if prev_y is not None:
        pv, _, _ = _block_view(np.asarray(prev_y, np.float64), b)
        sad = np.abs(blocks - pv).mean(axis=(2, 3))
        # relative motion gate: source noise inflates every block's
        # SAD, so "static" means low RELATIVE to the frame's floor
        static = sad <= max(4.0, float(np.percentile(sad, 30)))
    else:
        static = np.ones_like(var, bool)
    # flat-ish blocks: lowest variance quartile of static blocks
    cand = var[static]
    if cand.size < 4:
        return NOISE_NONE, 0.0
    sigma2 = float(np.percentile(cand, 25))
    sigma = np.sqrt(max(sigma2, 0.0))
    if sigma < 1.0:
        return NOISE_NONE, sigma
    if sigma < 2.5:
        return NOISE_LOW, sigma
    if sigma < 4.5:
        return NOISE_MEDIUM, sigma
    return NOISE_HIGH, sigma


def denoise_frame(src, ref, noise_level: int, b: int = 16):
    """av1_denoiser_denoise analog (zero-MV path): blend the source
    toward the previous recon on blocks whose zero-MV SAD is inside the
    noise-dependent threshold.  Returns new (y, u, v)."""
    if noise_level == NOISE_NONE or ref is None:
        return src
    # blend weight and SAD gate rise with noise level
    w_num = {NOISE_LOW: 1, NOISE_MEDIUM: 2, NOISE_HIGH: 3}[noise_level]
    thresh = {NOISE_LOW: 5.0, NOISE_MEDIUM: 8.0,
              NOISE_HIGH: 12.0}[noise_level]
    out = []
    for pi, (s, r) in enumerate(zip(src, ref)):
        s = np.asarray(s)
        r = np.asarray(r)
        bb = b if pi == 0 else b // 2
        h, w = s.shape
        hb, wb = h // bb, w // bb
        sv = s[:hb * bb, :wb * bb].astype(np.int32) \
            .reshape(hb, bb, wb, bb)
        rv = r[:hb * bb, :wb * bb].astype(np.int32) \
            .reshape(hb, bb, wb, bb)
        sad = np.abs(sv - rv).mean(axis=(1, 3))            # (hb, wb)
        gate = (sad < thresh)[:, None, :, None]
        blended = (sv * (8 - w_num) + rv * w_num + 4) >> 3
        outp = s.copy()
        outp[:hb * bb, :wb * bb] = np.where(gate, blended, sv) \
            .reshape(hb * bb, wb * bb).astype(s.dtype)
        out.append(outp)
    return tuple(out)
