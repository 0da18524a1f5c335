"""Block FFT helpers (aom_dsp/fft.c / fft_common.h analog).

The reference ships hand-unrolled radix-2 float FFTs at 2x2..32x32 for
the noise model's PSD estimation.  On this stack the same surface is a
thin, exact wrapper over numpy's pocketfft — the consumers (noise model,
wiener denoise) operate on small pixel blocks.
"""

from __future__ import annotations

import numpy as np

FFT_SIZES = (2, 4, 8, 16, 32)


def fft2d(block: np.ndarray) -> np.ndarray:
    """Forward 2D FFT of an NxN float block (aom_fft_NxN_float_c)."""
    n = block.shape[0]
    assert block.shape == (n, n) and n in FFT_SIZES
    return np.fft.fft2(block.astype(np.float64))


def ifft2d(spec: np.ndarray) -> np.ndarray:
    """Inverse 2D FFT returning the real part (aom_ifft_NxN_float_c)."""
    n = spec.shape[0]
    assert spec.shape == (n, n) and n in FFT_SIZES
    return np.fft.ifft2(spec).real


def block_psd(plane: np.ndarray, n: int = 32) -> np.ndarray:
    """Mean periodogram over the plane's NxN tiles (noise PSD used by
    aom_noise_model / wiener denoising)."""
    h, w = plane.shape
    acc = np.zeros((n, n))
    count = 0
    for y in range(0, h - n + 1, n):
        for x in range(0, w - n + 1, n):
            blk = plane[y:y + n, x:x + n].astype(np.float64)
            blk = blk - blk.mean()
            spec = fft2d(blk)
            acc += (spec.real ** 2 + spec.imag ** 2) / (n * n)
            count += 1
    return acc / max(count, 1)
