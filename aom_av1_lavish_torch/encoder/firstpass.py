"""First pass: per-16x16 intra/inter error stats, batched on device.

Port of aom_av1_lavish_tpu/encoder/firstpass.py; re-design of
av1/encoder/firstpass.c (av1_first_pass :1248, FIRSTPASS_STATS :43-174):
the reference walks MBs serially doing DC-pred intra error + a small MV
search; here the whole frame's MB grid is one batched pass — DC intra error
vectorized, inter error as the exhaustive SSD surface (+-16 full-pel vs the
previous frame) from kernel K2's plane form, the entry the full-pel search
calls.  Its sums are exact integers; the stats are float32 sums over the
frame's blocks.  Stats serialize through a flat float64 array per frame
(stats/aomstats.h:34 analog) via save_stats/load_stats.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from .. import resolve_device
from ..ops.inter import PADR, _edge_pad, _tiles, to_device
from ..ops.kernels import ssd_surface_plane


@dataclass
class FirstPassStats:
    """Per-frame aggregate (FIRSTPASS_STATS analog, trimmed to the
    fields pass-2 consumes)."""
    frame: float = 0.0
    intra_error: float = 0.0      # sum DC-pred SSE over MBs
    coded_error: float = 0.0      # sum min(intra, inter) SSE
    pcnt_inter: float = 0.0       # fraction of MBs where inter wins
    pcnt_motion: float = 0.0      # fraction of inter MBs with nonzero MV
    mv_mag: float = 0.0           # mean |mv| of inter MBs (full-pel)
    count: float = 1.0

    def to_array(self) -> np.ndarray:
        return np.array([getattr(self, f.name) for f in fields(self)],
                        np.float64)

    @classmethod
    def from_array(cls, a) -> "FirstPassStats":
        return cls(**{f.name: float(v)
                      for f, v in zip(fields(cls), a)})


def _fp_frame(src_y, prev_pad):
    """One frame's sums: src_y (H, W) uint8 and the PADR-padded previous
    frame -> (intra error, coded error, inter share, moving share, summed
    |mv|, moving count or 1) as a (6,) float32 tensor."""
    H, W = src_y.shape
    nby, nbx = H // 16, W // 16
    B = nby * nbx
    blk = _tiles(src_y, 16, nby, nbx)
    # DC-pred intra error (mean-removed energy, firstpass.c style)
    mean = (blk.sum((1, 2)) + 128) >> 8
    d = (blk - mean[:, None, None]).to(torch.float32)
    intra_err = (d * d).sum((1, 2))
    # inter: exhaustive +-16 SSD surface vs the previous frame
    ssd = ssd_surface_plane(src_y, prev_pad, nby, nbx, 16, 16, PADR - 16,
                            PADR - 16)
    flat = ssd.reshape(B, -1)
    best, bidx = flat.min(1)
    mv_y = bidx // 33 - 16
    mv_x = bidx % 33 - 16
    zero_ssd = ssd[:, 16, 16]
    moved = best + 256.0 < zero_ssd   # motion must beat zero-mv bias
    inter_err = torch.where(moved, best, zero_ssd)
    is_inter = inter_err * 1.12 < intra_err   # firstpass gating flavor
    coded = torch.where(is_inter, inter_err, intra_err)
    moving = moved & is_inter
    mv_mag = torch.where(moving, mv_y.abs().to(torch.float32)
                         + mv_x.abs().to(torch.float32), 0.0)
    # the shares as XLA evaluates the reference's mean: the count times the
    # float32 reciprocal of the number of blocks
    inv_b = float(np.float32(1.0) / np.float32(B))
    return torch.stack([
        intra_err.sum(), coded.sum(),
        is_inter.sum().to(torch.float32) * inv_b,
        moving.sum().to(torch.float32) * inv_b, mv_mag.sum(),
        moving.sum().to(torch.float32).clamp(min=1.0)])


def first_pass(frames, device=None) -> list:
    """Run the stats pass over (y, u, v) frames on `device` (the card when
    None); returns [FirstPassStats] (one per frame; frame 0 is
    intra-only)."""
    device = resolve_device(device)
    stats = []
    prev = None
    for i, f in enumerate(frames):
        H = (f[0].shape[0] // 16) * 16
        W = (f[0].shape[1] // 16) * 16
        y = to_device(f[0][:H, :W], device)
        ref = y if prev is None else prev
        ie, ce, pi, pm, mv, nmv = _fp_frame(y, _edge_pad(ref, PADR)) \
            .cpu().tolist()
        if prev is None:
            stats.append(FirstPassStats(frame=i, intra_error=ie,
                                        coded_error=ie, pcnt_inter=0.0,
                                        pcnt_motion=0.0, mv_mag=0.0))
        else:
            stats.append(FirstPassStats(
                frame=i, intra_error=ie, coded_error=ce, pcnt_inter=pi,
                pcnt_motion=pm, mv_mag=mv / nmv))
        prev = y
    return stats


def save_stats(path: str, stats) -> None:
    """Serialize first-pass stats (stats_open_file/.fpf analog)."""
    np.save(path, np.stack([s.to_array() for s in stats]))


def load_stats(path: str) -> list:
    arr = np.load(path if path.endswith(".npy") else path + ".npy")
    return [FirstPassStats.from_array(r) for r in arr]
