#!/usr/bin/env python3
"""Device time of the port's ARF P-frame program, grouped by caller.

    python3 tools/profile_p_frame.py [--root DIR ...] [--json PATH]

Runs the ARF program of chip_smoke.py (ops/inter._p_chain_fn over one
1920x1088 frame and LAST, the first group of chip_smoke.PROGRAM_QS) on the
card, once as its plain version (the eager function that the program's CUDA
graph captures) and once as a replay of the graph, each under
torch.profiler after a warm-up call.  Every device kernel of the plain run
is charged to the innermost of these callers that was open on the host
when it was launched (each caller is a record_function range, which the
profiler also puts on the device timeline around its kernels):

  fullpel      ops/inter._fullpel_search (K2 twice, K1 once, argmins)
  subpel       ops/inter._subpel_refine (K3, 22 predictions and costs)
  residual     ops/inter._code_residual, the nine calls of a P frame
  rd_skip      ops/inter._rd_skip
  merge_cands  ops/inter._eval_merge_level outside the two calls above:
               the candidate loop and the chroma predictions
  deblock      ops/inter.deblock_leafmask
  other        the rest of p_frame (snap, filter pick, merge DP, planes)

Each --root is a checkout of the repo (another commit unpacked with
git archive, or "."); each runs in a process of its own, importing that
checkout's package and chip_smoke.py.  Prints one table a checkout and
writes the records as JSON to --json (default
chiprun_out/profile_p_frame.json).  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CALLERS = {"_fullpel_search": "fullpel", "_subpel_refine": "subpel",
           "_code_residual": "residual", "_rd_skip": "rd_skip",
           "_eval_merge_level": "merge_cands",
           "deblock_leafmask": "deblock"}


def _wrapped(fn, label):
    from torch.profiler import record_function

    def call(*a, **k):
        with record_function(f"caller/{label}"):
            return fn(*a, **k)
    return call


def _by_caller(events) -> dict:
    """{caller: [kernel runs, device ms]} from torch.profiler's events.  A
    record_function range is also an event on the device timeline, from
    the first to the last kernel launched inside it (one stream: kernels
    run in launch order), so each kernel goes to the innermost caller
    range that holds its start there."""
    from torch.autograd import DeviceType

    ranges, kernels = [], []
    for ev in events:
        if ev.device_type != DeviceType.CUDA:
            continue
        span = (ev.time_range.start, ev.time_range.end)
        low = ev.name.lower()
        if ev.name.startswith("caller/"):
            ranges.append(span + (ev.name[len("caller/"):],))
        elif "memcpy" not in low and "memset" not in low:
            kernels.append(span)
    out = {}
    for s, e in kernels:
        inner = max((r for r in ranges if r[0] <= s < r[1]),
                    key=lambda r: r[0], default=None)
        acc = out.setdefault(inner[2] if inner else "other", [0, 0.0])
        acc[0] += 1
        acc[1] += (e - s) / 1e3
    if kernels and not ranges:
        raise RuntimeError("the profiler put no caller range on the device "
                           "timeline")
    return out


def _totals(events) -> dict:
    """{"all": [kernel runs, device ms]} of a graph replay."""
    from torch.autograd import DeviceType
    spans = [ev.time_range for ev in events
             if ev.device_type == DeviceType.CUDA
             and not ev.name.startswith("caller/")
             and "memcpy" not in ev.name.lower()
             and "memset" not in ev.name.lower()]
    return {"all": [len(spans), sum(t.end - t.start for t in spans) / 1e3]}


def profile_here() -> dict:
    """The records of this process's checkout (already first on
    sys.path)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as CS
    from aom_av1_lavish_torch.ops import inter as IT
    from aom_av1_lavish_torch.utils.clips import make_frames

    dev = torch.device("cuda")
    frames = make_frames(CS.N_FRAMES, CS.W, CS.H)
    name, prog, args = CS.program_cases(dev, frames, CS.PROGRAM_QS[0], CS.W,
                                        CS.H)[0]
    assert name == "ARF"
    saved = {f: getattr(IT, f) for f in CALLERS}
    for f, label in CALLERS.items():
        setattr(IT, f, _wrapped(saved[f], label))
    rec = {"root": os.getcwd(), "card": CS.gpu_line()}
    try:
        for what, fn in (("plain", lambda: prog.fn(*args)),
                         ("replay", lambda: prog(*args))):
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            events = prof.events()
            rec[what] = (_by_caller(events) if what == "plain" else
                         _totals(events))
    finally:
        for f, orig in saved.items():
            setattr(IT, f, orig)
    return rec


def show(rec) -> None:
    print(f"{rec['root']}: {rec['card']}")
    total = [sum(v[0] for v in rec["plain"].values()),
             sum(v[1] for v in rec["plain"].values())]
    print(f"  {'caller':<13} {'kernel runs':>11} {'device ms':>10} "
          f"{'share':>6}")
    for label, (runs, ms) in sorted(rec["plain"].items(),
                                    key=lambda kv: -kv[1][1]):
        print(f"  {label:<13} {runs:>11d} {ms:>10.3f} "
              f"{ms / total[1]:>6.1%}")
    print(f"  {'plain total':<13} {total[0]:>11d} {total[1]:>10.3f}")
    rep = [sum(v[0] for v in rec["replay"].values()),
           sum(v[1] for v in rec["replay"].values())]
    print(f"  {'replay total':<13} {rep[0]:>11d} {rep[1]:>10.3f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", nargs="+", default=[ROOT])
    ap.add_argument("--json", default=os.path.join(ROOT, "chiprun_out",
                                                   "profile_p_frame.json"))
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    opts = ap.parse_args(argv)
    if opts.child:
        import torch
        if not torch.cuda.is_available():
            print("profile_p_frame: no CUDA device", file=sys.stderr)
            return 2
        print("RECORD " + json.dumps(profile_here()), flush=True)
        return 0
    recs = []
    for root in opts.root:
        root = os.path.abspath(root)
        done = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child"],
            cwd=root, capture_output=True, text=True, timeout=600,
            env=dict(os.environ, PYTHONPATH=root))
        line = next((ln for ln in done.stdout.splitlines()
                     if ln.startswith("RECORD ")), None)
        if done.returncode != 0 or line is None:
            print(done.stdout[-3000:] + done.stderr[-3000:], file=sys.stderr)
            return done.returncode or 1
        recs.append(json.loads(line[len("RECORD "):]))
        show(recs[-1])
    os.makedirs(os.path.dirname(opts.json), exist_ok=True)
    with open(opts.json, "w") as f:
        json.dump(recs, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
