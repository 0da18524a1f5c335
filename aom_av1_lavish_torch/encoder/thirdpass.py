"""Third-pass encoding (av1/encoder/thirdpass.c analog).

The reference's third pass decodes the second-pass output bitstream and
mines block-level statistics (modes, MVs, partition shapes) to steer a
final encode.  Here the pass-2 stream is analyzed with the built-in
inspection API (decoder/inspect.py) and the derived per-frame signals
drive qindex offsets in the final GOP encode:

 * frames whose pass-2 result is intra-heavy (prediction failed —
   occlusion / scene transition) get a lower q,
 * frames that coded mostly skip blocks give bits back.
"""

from __future__ import annotations

import numpy as np


def third_pass_analyze(ivf_path: str) -> list:
    """Per-frame block statistics from a pass-2 bitstream
    (THIRD_PASS_DEC_CTX analog)."""
    from ..decoder.inspect import inspect_ivf
    out = []
    for info in inspect_ivf(ivf_path):
        inter = info.ref_grid > 0
        n = info.ref_grid.size
        mv = info.mv_grid[..., 0, :].astype(np.float64)
        out.append(dict(
            frame_type=info.frame_type,
            intra_ratio=float(1.0 - inter.sum() / n),
            skip_ratio=float(info.skip_grid.astype(bool).sum() / n),
            mean_mv=float(np.abs(mv).mean() / 8.0),
            base_qindex=info.base_qindex))
    return out


def third_pass_q_offsets(stats, strength: int = 10) -> np.ndarray:
    """qindex deltas per display frame from pass-2 block stats."""
    offs = np.zeros(len(stats), np.int32)
    for i, s in enumerate(stats):
        if s["frame_type"] == 0:       # key frames keep their RC q
            continue
        if s["intra_ratio"] > 0.5:     # prediction failing: spend more
            offs[i] = -strength
        elif s["skip_ratio"] > 0.9:    # nearly static: give bits back
            offs[i] = strength
    return offs


def encode_threepass_ivf(path: str, frames, width: int, height: int,
                         fps=(30, 1), **kw) -> None:
    """Pass 1 (stats) + pass 2 (encode) + pass 3 (re-encode with
    bitstream-mined hints); a `device` keyword names the device of all
    three (the card when absent)."""
    import os
    import tempfile

    from ..bitstream.ivf import write_ivf
    from .firstpass import first_pass
    from .gop import GopEncoder

    stats = first_pass(frames, device=kw.get("device"))
    with tempfile.TemporaryDirectory() as td:
        p2 = os.path.join(td, "pass2.ivf")
        enc2 = GopEncoder(width, height, twopass_stats=stats, **kw)
        payloads2 = enc2.encode_sequence(frames)
        write_ivf(p2, [(p, i) for i, p in enumerate(payloads2)],
                  width, height, fps[0], fps[1])
        offs = third_pass_q_offsets(third_pass_analyze(p2))
    enc3 = GopEncoder(width, height, twopass_stats=stats,
                      q_offsets=offs, **kw)
    payloads = enc3.encode_sequence(frames)
    write_ivf(path, [(p, i) for i, p in enumerate(payloads)],
              width, height, fps[0], fps[1])
