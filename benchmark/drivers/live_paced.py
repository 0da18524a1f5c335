"""One live stream fed by a camera clock (open loop).

Traffic parameters: fps (the camera's rate; the stream has fps x seconds
frames, a KEY only at frame 0), video (the scene, the camera and the
noise: benchmark/clips.Video), warm_frames (unpaced frames encoded in set-up, which
builds the KEY's kernels and captures the realtime step's program),
check_coded_frames (how many frames from the stream's start the
reference decodes), trace_seconds (with trace on, the first this many
seconds of the stream are traced).

Set-up makes every frame of the stream from the seed (on the device, in
host memory, as a camera's frames arrive), then encodes the warm-up.
The frames go into the entry's `frames` argument through a generator
that releases frame i at t0 + i / fps; a frame the encoder asks for late,
behind a stall, is released at once and carries the stall.  A frame's
latency runs from when it was due to when the port returned its payload
(TorchAllIntraEncoder.encode_frame for the KEY, TpuInterFrameEncoder
.encode_frame for each P frame, timed by spies); the window ends at the
last payload.  How late the generator itself ran (its sleeps' overshoot)
is printed apart.
"""

from __future__ import annotations

import os
import time

from benchmark.clips import Clip, Video
from benchmark.harness import Outcome, resolve
from benchmark.work import key_work, p_frame_work


class _Spy:
    """Wraps cls.method; after each call (outermost only) calls
    after(self, t_start, t_end)."""

    def __init__(self, cls, method, after):
        self.cls, self.method = cls, method
        self.orig = cls.__dict__[method]
        orig, depth = self.orig, [0]

        def spy(inst, *a, **k):
            depth[0] += 1
            t0 = time.perf_counter()
            try:
                return orig(inst, *a, **k)
            finally:
                depth[0] -= 1
                if depth[0] == 0:
                    after(inst, t0, time.perf_counter())

        setattr(cls, method, spy)

    def close(self):
        setattr(self.cls, self.method, self.orig)


def run(ctx) -> Outcome:
    from aom_av1_lavish_torch.encoder.tpu_inter import TpuInterFrameEncoder
    from aom_av1_lavish_torch.encoder.tpu_intra import TorchAllIntraEncoder
    from aom_av1_lavish_torch.ops.inter import DeviceRtEncoder

    cfg, tr = ctx.cell.config, ctx.cell.traffic
    W, H = cfg["frame_width"], cfg["frame_height"]
    fps = float(tr["fps"])
    n = max(2, round(fps * ctx.seconds))
    n_coded = int(tr["check_coded_frames"])
    kw = dict(cfg["kwargs"])
    entry = resolve(cfg["entry"])
    frames = Clip(ctx.seed, n, W, H, Video.from_mix(tr),
                  device=ctx.device).frames()
    ctx.inputs_made()
    warm = os.path.join(ctx.tmp, "warm.ivf")
    entry(warm, frames[:int(tr["warm_frames"])], W, H, device=ctx.device,
          **kw)
    os.remove(warm)

    done, emit, recon, steps = [], [], [], []
    due, released, waited = [0.0] * n, [0.0] * n, [False] * n
    traced = {"frames": 0, "keys": 0, "steps": 0}

    def key_done(enc, t0, t1):
        done.append(t1)
        if len(recon) < n_coded:
            recon.append(tuple(enc.recon))
        if ctx.tracing:
            traced["keys"] += 1

    def p_done(enc, t0, t1):
        done.append(t1)
        if ctx.tracing:
            emit.append((t0, t1))

    def step_done(dev, t0, t1):
        if len(steps) < n_coded - 1:
            steps.append(dev._rec_d)
        if ctx.tracing:
            traced["steps"] += 1

    spies = [_Spy(TorchAllIntraEncoder, "encode_frame", key_done),
             _Spy(TpuInterFrameEncoder, "encode_frame", p_done),
             _Spy(DeviceRtEncoder, "encode_frame_async", step_done)]
    t0 = None

    def camera():
        for i in range(n):
            f = frames[i]
            due[i] = t0 + i / fps
            if ctx.tracing and due[i] - t0 >= float(tr["trace_seconds"]):
                ctx.trace_stop()
            now = time.perf_counter()
            if now < due[i]:
                waited[i] = True
                time.sleep(due[i] - now)
            released[i] = time.perf_counter()
            if ctx.tracing:
                traced["frames"] += 1
            yield f

    path = os.path.join(ctx.tmp, "stream.ivf")
    try:
        ctx.window_opened()
        ctx.trace_start()
        t0 = time.perf_counter()
        entry(path, camera(), W, H, device=ctx.device, **kw)
        ctx.sync()
    finally:
        for s in spies:
            s.close()
    ctx.trace_stop()
    window_s = done[-1] - t0
    # the device recon of each checked P frame, (H + H/2, W) packed
    for rec in steps:
        r = rec.cpu().numpy()
        recon.append((r[:H], r[H:, :W // 2], r[H:, W // 2:]))
    traced["work"] = (key_work(W, H) * traced["keys"]
                      + p_frame_work(W, H, 1, interp=False, merge=False)
                      * traced["steps"])
    from benchmark.reference.av1.bitstream.ivf import read_ivf
    got = sum(1 for _ in read_ivf(path))
    over = sorted((released[i] - due[i]) * 1e3 for i in range(n)
                  if waited[i])
    behind = n - len(over)
    lat = sorted((d - due[i]) * 1e3 for i, d in enumerate(done[:n]))
    lines = [f"window: {n} frames at {fps:g} fps in {window_s:.3f} s; "
             f"{len(done)} payloads; latency ms median "
             f"{lat[len(lat) // 2]:.2f}, the 10 longest "
             + " ".join(f"{v:.1f}" for v in lat[-10:])]
    if over:
        lines.append(f"generator: {len(over)} frames released on time, "
                     f"late by median {over[len(over) // 2]:.3f} ms, "
                     f"max {over[-1]:.3f} ms; {behind} asked for behind a "
                     "stall")
    return Outcome(
        attempted=n, failed=n - min(len(done), got), frames=min(len(done), n),
        window_s=window_s, stream_bytes=os.path.getsize(path),
        latencies_s=[d - due[i] for i, d in enumerate(done[:n])],
        check={"path": path, "n_coded": n_coded, "recon": recon,
               "sources": frames[:n_coded],
               "frames_missing": n - got, "streams_differing": None},
        traced=traced, spans={"emit": emit}, lines=lines)
