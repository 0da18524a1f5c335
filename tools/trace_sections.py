#!/usr/bin/env python3
"""One traced run of a cell of the port's benchmark, as

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace 1

runs it, that also prints what the port's tracing (utils/profiler) kept
of the traced part: each section's seconds and calls, every counter
(fetch_bytes, the bytes copied to the host, and fetch_bytes/<site> by
site), the checks below of the trace, and the pinned host memory held.
Prints the run's lines, its result line, then one JSON line {"sections":
{name: seconds}, "calls": {name: n}, "counters": {...}, "checks": {...},
"host_pinned": {...}}; with --out, appends both JSON lines to that file too.  From the
checkout's root:

    python3 tools/trace_sections.py --workload rt_live.call_1080p30 \\
        --seed 7 --seconds 51 --out build/sections.jsonl
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def checks(trace) -> dict:
    """What the trace says beside the metrics: each section's count and
    ms as the trace holds it (a section still open when the trace stopped
    is not there), the device's time in every copy to the host (the union
    of its `Memcpy DtoH` intervals, ms), the idle stretches between device
    operations longer than 5 ms that no section is open over (the window's
    lead-in and tail left out), and for each key/waves section its host ms
    and the device's busy ms in it."""
    from benchmark.trace import idle_gaps, union_us
    held = {}
    for s, e, n in trace.sections:
        c, ms = held.get(n, (0, 0.0))
        held[n] = (c + 1, ms + (e - s) / 1e3)
    dtoh = [d for d in trace.device if d[2].startswith("Memcpy DtoH")]
    busy = [(s, e) for s, e, _ in trace.device]
    gaps = idle_gaps(busy, trace.sections, None, n=len(busy))
    waves = [[(e - s) / 1e3, union_us(trace.device, (s, e)) / 1e3]
             for s, e, n in trace.sections if n == "key/waves"]
    return {"in_trace": held, "dtoh_ms": union_us(dtoh) / 1e3,
            "none_gaps_ms": [g[1] * 1e3 for g in gaps
                             if g[0] == "none" and g[1] > 5e-3],
            "key_waves_host_device_ms": waves}


def traced(workload, seed, seconds, device=None, bench=None):
    """run_cell with trace on -> (result, lines, what the sections kept
    and the checks of the trace)."""
    from aom_av1_lavish_torch.utils import profiler

    from benchmark import harness
    seen = {}
    per_layer = harness.per_layer

    def keep(cell, trace, *a, **k):
        seen["trace"] = trace
        return per_layer(cell, trace, *a, **k)

    harness.per_layer = keep
    try:
        kw = {"bench": bench} if bench else {}
        result, lines, _ = harness.run_cell(workload, seed, seconds, True,
                                            T_START, device=device, **kw)
    finally:
        harness.per_layer = per_layer
    kept = {"sections": profiler.times(), "calls": dict(profiler._COUNTS),
            "counters": profiler.counters(),
            "checks": checks(seen["trace"]), "host_pinned": host_pinned()}
    return result, lines, kept


def host_pinned() -> dict:
    """What torch's caching host allocator held since the process began
    (the pinned memory the copies to the host land in): its bytes at the
    peak and now, as blocks of rounded size, and the blocks it pinned; {}
    without a card or without the allocator's statistics."""
    import torch
    stats = getattr(torch.cuda, "host_memory_stats", None)
    if not torch.cuda.is_available() or stats is None:
        return {}
    got = stats()
    return {k: got.get(k) for k in ("allocated_bytes.peak",
                                     "allocated_bytes.current",
                                     "active_bytes.peak", "num_host_alloc")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out")
    opts = ap.parse_args(argv)
    result, lines, kept = traced(opts.workload, opts.seed, opts.seconds)
    rows = [json.dumps(dict(result, workload=opts.workload,
                            seed=opts.seed)), json.dumps(kept)]
    for ln in lines + rows:
        print(ln, flush=True)
    if opts.out:
        with open(opts.out, "a") as f:
            f.write("\n".join(rows) + "\n")
    return 0


if __name__ == "__main__":
    sys.path[0] = ROOT
    # any import of JAX or of the JAX package now fails, as in run.py
    for _name in ("jax", "jaxlib", "flax", "aom_av1_lavish_tpu"):
        sys.modules[_name] = None
    sys.exit(main())
