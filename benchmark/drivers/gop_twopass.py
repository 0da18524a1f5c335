"""Closed-loop two-pass encodes at a target bitrate: one encoder at a time,
back to back, each with its own first pass.

Traffic parameters: those of gop_stream (frames_per_encode, video,
warm_frames, sample_among, check_coded_frames, trace_seconds), and
scene_cuts: the frames where a new scene starts.  Scene s (from the clip's
start or its s-th cut to the next cut or the end) is frames of the clip
benchmark/clips.py makes from seed + s, at the same frame indices, so the
camera and the disc carry on and the content changes at once, as at a cut
in edited video.  The configuration's `rate_control` ({"mode": "vbr",
"target_bps", "fps"}) becomes the encode's RateControlConfig (`rc_cfg`), a
new one each encode.

Set-up makes the clip from the seed on the device and encodes its first
warm_frames frames once: with warm_frames the whole clip, every GF length
the stats-driven schedule meets is captured before the window.  The window
runs as gop_stream's.  The recon spy is gop_stream's, with one change:
inside GopEncoder._recode each new attempt at a frame first drops what the
attempt before it left, so the spy keeps, for each coded frame, the
reconstruction of the attempt the stream holds.

After the window the plain reference (benchmark/plain_twopass.py)
computes the first pass of the clip on the device and the schedule its
statistics give.  The first pass's statistics of the checked encode must
equal the reference's: the shares and mv_mag exactly, intra_error and
coded_error within a relative 2 * ceil(log2 B) * 2^-24 (B blocks a frame):
torch sums B float32 terms as a tree of about ceil(log2 B) levels, a few
more where a thread first adds its own few terms, each level rounding by
at most 2^-24, against the reference's exact sums; a sum taken in float16
or bfloat16 (unit roundoff 2^-11, 2^-8) departs far beyond that.  The
checked stream's layout, as its frame headers say (KEYs, hidden ARFs,
shown P frames, show_existing_frame), must be the one the plain schedule
gives.  A departure makes the checked stream one the configuration's
guarantee does not describe: it counts in `streams_differing`, whose limit
is 0, and the checked encode in `failed`.

The rate plan of the checked encode is printed by frame kind: the bits
TwoPassAllocator planned, the targets the VBR correction made of them as
each frame's q was picked (GopEncoder._target), and the bits each frame
spent (GopEncoder._tp_note).

The traced work (benchmark/work.py) follows what ran: the first pass's
surfaces, every KEY and ARF attempt, and the groups of the stream's layout.
"""

from __future__ import annotations

import math
import os
import time

import numpy as np

from benchmark.clips import Clip, Video
from benchmark.harness import Outcome, load_plugin, resolve
from benchmark import plain_twopass as plain
from benchmark.work import (FULLPEL_RADIUS, _surface, key_work,
                            lookahead_work, p_frame_work)

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: rows of 16x16 blocks the reference computes at once on the device
REFERENCE_ROWS = 8
EXACT_FIELDS = ("pcnt_inter", "pcnt_motion", "mv_mag")
SUMMED_FIELDS = ("intra_error", "coded_error")


def rc_config(spec: dict):
    """The configuration's rate_control as a RateControlConfig."""
    from aom_av1_lavish_torch.encoder.ratectrl import (MODE_VBR,
                                                       RateControlConfig)
    modes = {"vbr": MODE_VBR}
    return RateControlConfig(mode=modes[spec["mode"]],
                             target_bps=int(spec["target_bps"]),
                             fps=float(spec["fps"]))


def scene_frames(seed: int, n: int, w: int, h: int, video: Video,
                 cuts: list, device) -> list:
    """The n frames of a clip whose scene changes at each frame of `cuts`
    (module docstring), as (y, u, v) uint8 arrays."""
    bounds = [0] + [int(c) for c in cuts] + [n]
    if any(a >= b for a, b in zip(bounds, bounds[1:])):
        raise ValueError(f"scene_cuts {cuts} must rise inside 1 .. {n - 1}")
    out = []
    for s, (a, b) in enumerate(zip(bounds, bounds[1:])):
        clip = Clip(seed + s, n, w, h, video, device=device)
        for i0 in range(a, b, 16):
            planes = [p.cpu().numpy() for p in clip.batch(i0, min(b, i0 + 16))]
            out += [tuple(p[k] for p in planes)
                    for k in range(planes[0].shape[0])]
    return out


class _Spy:
    """gop_stream's recon spy, each attempt inside GopEncoder._recode first
    dropping the frames the attempt before it left; the encodes _recode
    made of each anchor kind (`attempts`); the first pass's statistics of
    the latest encode (`stats`); its rate plan (`plan`: display index ->
    [bits planned, targeted, spent])."""

    def __init__(self, n_coded: int):
        from aom_av1_lavish_torch.encoder import firstpass
        from aom_av1_lavish_torch.encoder.gop import GopEncoder

        self.recon = load_plugin("drivers", "gop_stream", BENCH)._Recon(
            n_coded)
        self.attempts, self.stats, self.plan = {"key": 0, "arf": 0}, None, {}
        self.fp, self.gop = firstpass, GopEncoder
        self.first_pass, self.recode = firstpass.first_pass, \
            GopEncoder._recode
        self.target, self.note = GopEncoder._target, GopEncoder._tp_note
        spy = self

        def row(enc_self, i):
            return spy.plan.setdefault(
                i, [float(enc_self._targets[i]), None, None])

        def target(enc_self, i):
            t = spy.target(enc_self, i)
            if t is not None:
                row(enc_self, i)[1] = t
            return t

        def note(enc_self, i, bits):
            spy.note(enc_self, i, bits)
            if enc_self._targets is not None:
                row(enc_self, i)[2] = float(bits)

        def first_pass(frames, *a, **k):
            spy.stats = spy.first_pass(frames, *a, **k)
            return spy.stats

        def recode(enc_self, kind, display_idx, q, encode_fn):
            mark = len(spy.recon.frames)

            def attempt(qq):
                del spy.recon.frames[mark:]
                if kind in spy.attempts:
                    spy.attempts[kind] += 1
                return encode_fn(qq)
            return spy.recode(enc_self, kind, display_idx, q, attempt)

        firstpass.first_pass = first_pass
        GopEncoder._recode = recode
        GopEncoder._target, GopEncoder._tp_note = target, note

    def close(self):
        self.fp.first_pass = self.first_pass
        self.gop._recode = self.recode
        self.gop._target, self.gop._tp_note = self.target, self.note
        self.recon.close()


def stream_layout(path: str) -> list:
    """The temporal units of an IVF stream as its frame headers say, in
    order: the frames of each joined by "+", each "key" (a shown KEY),
    "arf" (a hidden inter frame), "inter" (a shown inter frame) or
    "show_existing"."""
    from benchmark.reference.av1.bitstream import constants as c
    from benchmark.reference.av1.bitstream.bits import BitReader
    from benchmark.reference.av1.bitstream.headers import (
        parse_sequence_header, split_obus)
    from benchmark.reference.av1.bitstream.ivf import read_ivf
    out = []
    for payload, _ in read_ivf(path):
        kinds = []
        for obu_type, body in split_obus(payload):
            if obu_type == c.OBU_SEQUENCE_HEADER and \
                    parse_sequence_header(body).reduced_still_picture_header:
                raise ValueError("a reduced still-picture header")
            if obu_type not in (c.OBU_FRAME, c.OBU_FRAME_HEADER):
                continue
            r = BitReader(body, 0)
            if r.read_bit():
                kinds.append("show_existing")
                continue
            frame_type, shown = r.read_literal(2), r.read_bit()
            kinds.append({(c.KEY_FRAME, 1): "key",
                          (c.INTER_FRAME, 1): "inter",
                          (c.INTER_FRAME, 0): "arf"}.get(
                              (frame_type, shown), f"type{frame_type}"))
        out.append("+".join(kinds))
    return out


def layout_work(layout: list, W: int, H: int, attempts: dict):
    """The work of one encode (benchmark/work.py) and its counts, from its
    stream's layout and the encodes of each anchor kind _recode made: the
    first pass (a surface a frame), each KEY attempt, each ARF attempt,
    each group's lookahead and chained P frames, and each lone P frame.  A
    group is an ARF's (from its "arf+inter" to its "show_existing") or a
    run of lone P frames."""
    n = sum(1 for tu in layout for k in tu.split("+")
            if k in ("key", "inter", "show_existing"))
    counts = {"frames": n, "keys": 0, "groups": 0, "arfs": 0, "inter": 0,
              "key_attempts": attempts["key"],
              "arf_attempts": attempts["arf"]}
    work = [("ssd_surface",) + _surface(W, H, 16, FULLPEL_RADIUS, "int8")
            ] * n
    work += key_work(W, H) * attempts["key"]
    work += p_frame_work(W, H, 1) * attempts["arf"]
    group, lone = None, False
    for tu in layout:
        if tu == "key":
            counts["keys"] += 1
            lone = False
        elif tu == "arf+inter":
            group, lone = 2, False
        elif tu == "show_existing" and group is not None:
            counts["groups"] += 1
            counts["arfs"] += 1
            counts["inter"] += group
            work += lookahead_work(W, H, group)
            work += p_frame_work(W, H, 2) * (group - 1)
            group = None
        elif tu == "inter" and group is not None:
            group += 1
        elif tu == "inter":
            counts["groups"] += not lone
            counts["inter"] += 1
            work += p_frame_work(W, H, 1)
            lone = True
    return work, counts


def plan_by_kind(plan: dict, sched) -> str:
    """The rate plan (_Spy.plan) summed over the KEYs, the ARFs and the
    other frames of the schedule `sched`, in kbit, with the range of the
    VBR correction (targeted over planned)."""
    keys = {item[1] for item in sched if item[0] == "key"}
    arfs = {item[1] + item[2] - 1 for item in sched
            if item[0] == "gf" and item[2] >= 3}
    parts = []
    for kind in ("key", "arf", "inter"):
        rows = [r for i, r in sorted(plan.items())
                if (i in keys, i in arfs) == (kind == "key", kind == "arf")
                and None not in r]
        if not rows:
            continue
        planned, targeted, spent = (sum(r[k] for r in rows) / 1e3
                                    for k in range(3))
        corr = [r[1] / r[0] for r in rows]
        parts.append(f"{kind} ({len(rows)}) planned {planned:.1f}, "
                     f"targeted {targeted:.1f}, spent {spent:.1f} kbit "
                     f"(correction {min(corr):.3f}..{max(corr):.3f})")
    return "; ".join(parts)


def sums_rtol(n_blocks: int) -> float:
    """The relative limit of the summed first-pass fields (module
    docstring)."""
    return 2 * math.ceil(math.log2(n_blocks)) * 2.0 ** -24


def stats_departure(got, want, n_blocks: int):
    """The first (frame, field, got, want) where the port's first-pass
    statistics `got` depart from the reference's `want` beyond the limits
    (module docstring), or None; and the largest relative difference of
    the summed fields."""
    rtol = sums_rtol(n_blocks)
    worst, first = 0.0, None
    if len(got) != len(want):
        first = (min(len(got), len(want)), "frames", len(got), len(want))
    for g, w in zip(got, want):
        for f in SUMMED_FIELDS + EXACT_FIELDS:
            a, b = float(getattr(g, f)), float(getattr(w, f))
            if f in SUMMED_FIELDS:
                rel = abs(a - b) / max(abs(b), 1.0)
                worst = max(worst, rel)
                bad = not rel <= rtol
            else:
                bad = a != b
            if bad and first is None:
                first = (int(w.frame), f, a, b)
    return first, worst


def run(ctx) -> Outcome:
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    W, H = cfg["frame_width"], cfg["frame_height"]
    n = int(tr["frames_per_encode"])
    kw = dict(cfg["kwargs"])
    entry = resolve(cfg["entry"])
    frames = scene_frames(ctx.seed, n, W, H, Video.from_mix(tr),
                          tr.get("scene_cuts", []), ctx.device)
    ctx.inputs_made()
    warm = os.path.join(ctx.tmp, "warm.ivf")
    entry(warm, frames[:int(tr["warm_frames"])], W, H, device=ctx.device,
          rc_cfg=rc_config(cfg["rate_control"]), **kw)
    os.remove(warm)
    sample = int(np.random.default_rng(ctx.seed % 2 ** 64)
                 .integers(int(tr["sample_among"])))
    spy = _Spy(int(tr["check_coded_frames"]))
    traced = {"encodes": 0, "work": []}
    traced_attempts, paths, ends, recon = [], [], [], None
    try:
        ctx.window_opened()
        ctx.trace_start()
        t0 = time.perf_counter()
        while not paths or time.perf_counter() - t0 < ctx.seconds:
            k = len(paths)
            path = os.path.join(ctx.tmp, f"enc{k}.ivf")
            spy.recon.on, spy.recon.frames = k <= sample, []
            spy.attempts, spy.plan = {"key": 0, "arf": 0}, {}
            entry(path, frames, W, H, device=ctx.device,
                  rc_cfg=rc_config(cfg["rate_control"]), **kw)
            ctx.sync()
            done = time.perf_counter()
            ends.append(done)
            paths.append(path)
            if spy.recon.on:
                recon = (k, spy.recon.frames, spy.stats, dict(spy.attempts),
                         spy.plan)
            if ctx.tracing:
                traced["encodes"] += 1
                traced_attempts.append((path, dict(spy.attempts)))
                if done - t0 >= float(tr["trace_seconds"]):
                    ctx.trace_stop()
        window_s = done - t0
    finally:
        spy.close()
    ctx.trace_stop()
    for path, attempts in traced_attempts:
        work, counts = layout_work(stream_layout(path), W, H, attempts)
        traced["work"] += work
        for key, v in counts.items():
            traced[key] = traced.get(key, 0) + v
    gop = load_plugin("drivers", "gop_stream", BENCH)
    k_checked, rec = recon[0], gop._on_host(recon[1])
    with open(paths[k_checked], "rb") as f:
        checked = f.read()
    got = [gop._ivf_frames(p) for p in paths]
    missing = sum(max(0, n - g) for g in got)
    differing = total = 0
    for p in paths:
        with open(p, "rb") as f:
            data = f.read()
        total += len(data)
        differing += data != checked
    failed = sum(g != n for g in got)
    rc = cfg["rate_control"]
    kbps = total * 8 / len(paths) / n * float(rc["fps"]) / 1e3
    lines = [f"window: {len(paths)} encodes of {n} frames in "
             f"{window_s:.3f} s; encode {k_checked} checked; each took "
             + " ".join(f"{b - a:.3f}" for a, b in zip([t0] + ends, ends))
             + " s",
             f"rate: {kbps:.1f} kbit/s against {rc['target_bps'] / 1e3:.1f}"
             f" targeted; the checked encode's KEY and ARF encodes "
             f"(recodes included): {recon[3]}"]
    # the plain reference: the first pass on the device, its schedule
    t_ref = time.perf_counter()
    want = plain.first_pass(frames, device=ctx.device,
                            rows_at_once=REFERENCE_ROWS)
    ctx.sync()
    departure, worst = stats_departure(recon[2] or [], want,
                                       (W // 16) * (H // 16))
    sched = plain.schedule(want, n, kw["kf_interval"], kw["gf_length"])
    expect, layout = plain.layout(sched), stream_layout(paths[k_checked])
    lines.append(f"first pass: {len(want)} frames against the plain "
                 f"reference ({time.perf_counter() - t_ref:.1f} s), largest "
                 f"relative difference of the sums {worst:.3g} (limit "
                 f"{sums_rtol((W // 16) * (H // 16)):.3g}); "
                 + ("equal" if departure is None else
                    "departs at frame {} in {}: {!r} against {!r}".format(
                        *departure)))
    where = next((i for i, (a, b) in enumerate(zip(layout, expect))
                  if a != b), None if len(layout) == len(expect)
                 else min(len(layout), len(expect)))
    lines.append(f"schedule: {sum(s[0] == 'key' for s in sched)} KEYs, GF "
                 f"lengths {[s[2] for s in sched if s[0] == 'gf']}; "
                 + ("the stream's layout is the plain schedule's"
                    if where is None else
                    f"the stream departs at temporal unit {where}: "
                    f"{(layout + [None])[min(where, len(layout))]!r} against "
                    f"{(expect + [None])[min(where, len(expect))]!r}"))
    lines.append("rate plan of the checked encode: "
                 + plan_by_kind(recon[4], sched))
    if departure is not None or where is not None:
        differing += 1
        failed += got[k_checked] == n
    return Outcome(
        attempted=len(paths), failed=failed, frames=n * len(paths) - missing,
        window_s=window_s, stream_bytes=total,
        check={"path": paths[k_checked],
               "n_coded": int(tr["check_coded_frames"]), "recon": rec,
               "sources": frames, "frames_missing": missing,
               "streams_differing": differing},
        traced=traced, lines=lines)
