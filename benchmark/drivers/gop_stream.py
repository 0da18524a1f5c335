"""Closed-loop encodes: one encoder at a time, back to back.

Traffic parameters: frames_per_encode (each encode is one clip of that
many frames, its own stream), video (the scene, the camera and the noise:
benchmark/clips.Video), warm_frames (the set-up's encode codes the clip's first that many
frames: enough for every GF group length the window meets),
sample_among (the encode the reference checks is drawn from the seed
among the first that many), check_coded_frames (how many coded frames of
it the reference decodes), trace_seconds (with trace on, whole encodes
are traced until this many seconds of the window have passed).

Set-up makes the clip from the seed on the device and encodes its first warm_frames
frames once, which builds and captures every program shape the window
meets.  The window starts encodes while `seconds` have not passed
and ends at the last one's completion; encode_fps is every completed
frame over that time.  Every encode codes the same clip, so every stream
of the window must be the sampled one byte for byte.
"""

from __future__ import annotations

import os
import time

import numpy as np

from benchmark.clips import Clip, Video
from benchmark.harness import Outcome, resolve
from benchmark.work import gop_work


class _Recon:
    """While `on`, keeps the encoder's reconstruction of each coded frame
    in coding order: a frame coded by a device program (the ARF and the
    chain) as the program returned it (its deblocked planes, through
    ops.inter.group_results, cloned before the program's next replay
    overwrites them), any other (the KEY, a lone P frame) as the encoder
    holds it on the host when GopEncoder._store_recon stores it."""

    def __init__(self, n_coded: int):
        from aom_av1_lavish_torch.encoder.gop import GopEncoder
        from aom_av1_lavish_torch.ops import inter

        self.n_coded, self.on, self.frames = n_coded, False, []
        self.gop, self.inter = GopEncoder, inter
        self.store, self.results = GopEncoder._store_recon, \
            inter.group_results
        spy = self

        def store(enc_self, enc, refresh_flags, fh):
            out = spy.store(enc_self, enc, refresh_flags, fh)
            # frames coded by a device program were taken at its output
            if spy.wants() and not getattr(enc, "_recon_prefiltered",
                                           False):
                spy.frames.append(tuple(enc.recon))
            return out

        def results(out):
            raw, rec = spy.results(out)
            for f in range(rec[0].shape[0]):
                if spy.wants():
                    spy.frames.append(tuple(p[f].clone() for p in rec))
            return raw, rec

        GopEncoder._store_recon = store
        inter.group_results = results

    def wants(self) -> bool:
        return self.on and len(self.frames) < self.n_coded

    def close(self):
        self.gop._store_recon = self.store
        self.inter.group_results = self.results


def _on_host(frames) -> list:
    return [tuple(p.cpu().numpy() if hasattr(p, "cpu") else p for p in f)
            for f in frames]


def _ivf_frames(path: str) -> int:
    from benchmark.reference.av1.bitstream.ivf import read_ivf
    return sum(1 for _ in read_ivf(path))


def run(ctx) -> Outcome:
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    W, H = cfg["frame_width"], cfg["frame_height"]
    n = int(tr["frames_per_encode"])
    kw = dict(cfg["kwargs"])
    entry = resolve(cfg["entry"])
    frames = Clip(ctx.seed, n, W, H, Video.from_mix(tr),
                  device=ctx.device).frames()
    ctx.inputs_made()
    warm = os.path.join(ctx.tmp, "warm.ivf")
    entry(warm, frames[:int(tr["warm_frames"])], W, H, device=ctx.device,
          **kw)
    os.remove(warm)
    sample = int(np.random.default_rng(ctx.seed % 2 ** 64)
                 .integers(int(tr["sample_among"])))
    spy = _Recon(int(tr["check_coded_frames"]))
    traced = {"encodes": 0, "work": []}
    paths, ends, recon = [], [], None
    try:
        ctx.window_opened()
        ctx.trace_start()
        t0 = time.perf_counter()
        while not paths or time.perf_counter() - t0 < ctx.seconds:
            k = len(paths)
            path = os.path.join(ctx.tmp, f"enc{k}.ivf")
            spy.on, spy.frames = k <= sample, []
            entry(path, frames, W, H, device=ctx.device, **kw)
            ctx.sync()
            done = time.perf_counter()
            ends.append(done)
            paths.append(path)
            if spy.on:
                recon = (k, spy.frames)
            if ctx.tracing:
                traced["encodes"] += 1
                if done - t0 >= float(tr["trace_seconds"]):
                    ctx.trace_stop()
        window_s = done - t0
    finally:
        spy.close()
    ctx.trace_stop()
    for _ in range(traced["encodes"]):
        work, counts = gop_work(W, H, n, kw["kf_interval"], kw["gf_length"])
        traced["work"] += work
        for key, v in counts.items():
            traced[key] = traced.get(key, 0) + v
    k_checked, rec = recon[0], _on_host(recon[1])
    with open(paths[k_checked], "rb") as f:
        checked = f.read()
    got = [_ivf_frames(p) for p in paths]
    missing = sum(max(0, n - g) for g in got)
    differing = total = 0
    for p in paths:
        with open(p, "rb") as f:
            data = f.read()
        total += len(data)
        differing += data != checked
    failed = sum(g != n for g in got)
    return Outcome(
        attempted=len(paths), failed=failed, frames=n * len(paths) - missing,
        window_s=window_s, stream_bytes=total,
        check={"path": paths[k_checked],
               "n_coded": int(tr["check_coded_frames"]), "recon": rec,
               "sources": frames, "frames_missing": missing,
               "streams_differing": differing},
        traced=traced,
        lines=[f"window: {len(paths)} encodes of {n} frames in "
               f"{window_s:.3f} s; encode {k_checked} checked; each took "
               + " ".join(f"{b - a:.3f}" for a, b in zip([t0] + ends, ends))
               + " s"])
