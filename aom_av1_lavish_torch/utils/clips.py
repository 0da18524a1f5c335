"""Synthetic test clips (numpy only).

make_frames is the clip of the repo's 1080p benchmark (bench.py
make_frames): a textured pan whose luma and chroma move coherently, made
from a fixed seed, so the port and the reference can be driven with the
same pixels.
"""

from __future__ import annotations

import numpy as np


def make_frames(n: int = 8, w: int = 1920, h: int = 1088) -> list:
    """n frames of (y, u, v) uint8 planes, 4:2:0, w x h."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:h + n * 2, 0:w + n * 2]
    base = (128 + 60 * np.sin(yy / 17.0) * np.cos(xx / 23.0)
            + 40 * (xx % 97 < 40) + rng.normal(0, 3, yy.shape))
    base = base.clip(0, 255).astype(np.uint8)
    cyy, cxx = np.mgrid[0:(h + n * 2) // 2, 0:(w + n * 2) // 2]
    cb = (128 + 35 * np.sin(cyy / 11.0 + 1.0) * np.cos(cxx / 19.0)
          + rng.normal(0, 2, cyy.shape)).clip(0, 255).astype(np.uint8)
    cr = (128 + 30 * np.cos(cyy / 13.0) * np.sin(cxx / 7.0 + 2.0)
          + rng.normal(0, 2, cyy.shape)).clip(0, 255).astype(np.uint8)
    frames = []
    for i in range(n):
        frames.append((
            np.ascontiguousarray(base[i:i + h, 2 * i:2 * i + w]),
            np.ascontiguousarray(cb[i // 2:i // 2 + h // 2, i:i + w // 2]),
            np.ascontiguousarray(cr[i // 2:i // 2 + h // 2,
                                    i:i + w // 2])))
    return frames
