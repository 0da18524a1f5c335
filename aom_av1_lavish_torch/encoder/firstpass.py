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
from ..ops.inter import PADR, _edge_pad, _tiles, to_device, to_host
from ..ops.kernels import ssd_surface_plane
from ..utils.profiler import profile


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


def fp_blocks(src_y, prev_pad):
    """Each 16x16 block's first-pass values: src_y (H, W) uint8 and the
    PADR-padded previous frame -> dict of (B,) tensors in raster order:
    intra (DC-pred error), inter (the error of the motion the gating
    kept: the best of the +-16 surface or zero motion), is_inter,
    moving, mv_y, mv_x (the surface's first minimum, full-pel)."""
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
    zero_ssd = ssd[:, 16, 16]
    moved = best + 256.0 < zero_ssd   # motion must beat zero-mv bias
    inter_err = torch.where(moved, best, zero_ssd)
    is_inter = inter_err * 1.12 < intra_err   # firstpass gating flavor
    return dict(intra=intra_err, inter=inter_err, is_inter=is_inter,
                moving=moved & is_inter, mv_y=bidx // 33 - 16,
                mv_x=bidx % 33 - 16)


def _fp_frame(src_y, prev_pad):
    """One frame's sums from fp_blocks: (intra error, coded error, inter
    share, moving share, summed |mv|, moving count or 1) as a (6,)
    float32 tensor."""
    b = fp_blocks(src_y, prev_pad)
    is_inter, moving = b["is_inter"], b["moving"]
    coded = torch.where(is_inter, b["inter"], b["intra"])
    mv_mag = torch.where(moving, b["mv_y"].abs().to(torch.float32)
                         + b["mv_x"].abs().to(torch.float32), 0.0)
    # the shares as XLA evaluates the reference's mean: the count times the
    # float32 reciprocal of the number of blocks
    inv_b = float(np.float32(1.0) / np.float32(is_inter.numel()))
    return torch.stack([
        b["intra"].sum(), coded.sum(),
        is_inter.sum().to(torch.float32) * inv_b,
        moving.sum().to(torch.float32) * inv_b, mv_mag.sum(),
        moving.sum().to(torch.float32).clamp(min=1.0)])


def first_pass(frames, device=None) -> list:
    """Run the stats pass over (y, u, v) frames on `device` (the card when
    None); returns [FirstPassStats] (one per frame; frame 0 is
    intra-only).  Section gop/first_pass; the frames' sums stay on the
    device and come to the host in one copy (site fp)."""
    device = resolve_device(device)
    sums = []
    prev = None
    with profile("gop/first_pass"):
        for f in frames:
            H = (f[0].shape[0] // 16) * 16
            W = (f[0].shape[1] // 16) * 16
            y = to_device(f[0][:H, :W], device)
            ref = y if prev is None else prev
            sums.append(_fp_frame(y, _edge_pad(ref, PADR)))
            prev = y
        rows = to_host(torch.stack(sums), "fp").tolist() if sums else []
    stats = []
    for i, (ie, ce, pi, pm, mv, nmv) in enumerate(rows):
        if i == 0:
            stats.append(FirstPassStats(frame=i, intra_error=ie,
                                        coded_error=ie, pcnt_inter=0.0,
                                        pcnt_motion=0.0, mv_mag=0.0))
        else:
            stats.append(FirstPassStats(
                frame=i, intra_error=ie, coded_error=ce, pcnt_inter=pi,
                pcnt_motion=pm, mv_mag=mv / nmv))
    return stats


def save_stats(path: str, stats) -> None:
    """Serialize first-pass stats (stats_open_file/.fpf analog)."""
    np.save(path, np.stack([s.to_array() for s in stats]))


def load_stats(path: str) -> list:
    arr = np.load(path if path.endswith(".npy") else path + ".npy")
    return [FirstPassStats.from_array(r) for r in arr]
