"""The harness of the port's benchmark: one cell, one run, one result line.

A cell is an entry of BENCHMARK.json's `workloads`: a configuration (an
encoder deployment, `configs/<config>.json`: the port's entry point and
its keywords, the frame size, the limits of the comparison) under a
traffic mix (`traffic/<traffic>.json`: the driver that feeds the entry
and its parameters).  Everything is found by name: the driver in
`drivers/<driver>.py` (a `run(ctx) -> Outcome`), each per-layer metric in
`metrics/<metric>.py` (a `read(trace) -> float | None`).  A new cell, mix,
driver or metric is a new file and a new entry in BENCHMARK.json.

A run: build (or find built) the port's CUDA kernels and native runtime,
let the driver make the video from the seed, warm up on the cell's shapes
and open the window (`setup_s` ends there), measure for `seconds`, then
judge what the window wrote with the reference (reference/compare.py)
and print the result line.  With trace on, part of the window runs under
torch.profiler and the per-layer metrics are read from it.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

#: top-level modules no run may hold: JAX and the JAX package
BLOCKED = ("jax", "jaxlib", "flax", "aom_av1_lavish_tpu")
HERE = os.path.dirname(os.path.abspath(__file__))


class BenchError(RuntimeError):
    """A run that cannot give a result."""


def blocked_modules() -> list:
    """The blocked top-level names that sys.modules holds a module of,
    compared by the whole name before the first dot."""
    return sorted({m.split(".")[0] for m, v in list(sys.modules.items())
                   if v is not None and m.split(".")[0] in BLOCKED})


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One workload with its configuration and traffic as loaded, and the
    metrics BENCHMARK.json gives it."""
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: list
    per_layer: list


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: str = HERE) -> Cell:
    """The cell `name` of the BENCHMARK.json beside the folder `bench`."""
    spec = load_json(os.path.join(os.path.dirname(bench), "BENCHMARK.json"))
    root = os.path.dirname(bench)
    wl = {w["name"]: w for w in spec["workloads"]}
    if name not in wl:
        raise BenchError(f"unknown workload {name!r}; workloads: "
                         f"{sorted(wl)}")
    w = wl[name]
    cfg = {c["name"]: c for c in spec["configs"]}[w["config"]]
    e2e = [m for m in spec["end_to_end"] if _applies(m, name)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if m["moves"] in e2e_names and _applies(m, name)]
    return Cell(name, int(w["chips"]), w["config"],
                load_json(os.path.join(root, cfg["file"])), w["traffic"],
                load_json(os.path.join(bench, "traffic",
                                       f"{w['traffic']}.json")),
                e2e, per_layer)


def load_plugin(kind: str, name: str, bench: str = HERE):
    """The module `<bench>/<kind>/<name>.py` (a driver or a metric)."""
    path = os.path.join(bench, kind, f"{name}.py")
    if not os.path.isfile(path):
        raise BenchError(f"no {kind[:-1]} {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"_bench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def resolve(dotted: str):
    """The object named by a dotted path, such as the port's entry."""
    module, _, attr = dotted.rpartition(".")
    return getattr(importlib.import_module(module), attr)


@dataclasses.dataclass
class Outcome:
    """What a driver's window did.  attempted, failed: units (encodes, or
    frames of a stream) started in the window and those that did not
    complete whole; frames: frames completed; window_s: seconds from the
    window's start to the last completion; stream_bytes: bytes of every
    stream the window wrote; latencies_s: each frame's seconds from when
    it was due to when its payload came back (paced traffic) or None;
    check: what the reference judges (path, n_coded, recon, sources,
    frames_missing, streams_differing); traced: counts of the traced part;
    spans: host spans by name; lines: lines to print before the result."""
    attempted: int
    failed: int
    frames: int
    window_s: float
    stream_bytes: int
    check: dict
    latencies_s: list | None = None
    traced: dict = dataclasses.field(default_factory=dict)
    spans: dict = dataclasses.field(default_factory=dict)
    lines: list = dataclasses.field(default_factory=list)


class Context:
    """What a driver gets: the cell, the seed, the window's length, the
    device, a scratch directory for the streams, and the calls that mark
    the window's start and the traced part."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device, tmp: str, t_start: float):
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.trace, self.device, self.tmp = trace, device, tmp
        self.t_start = t_start
        self.setup_s = None
        self.captures = 0
        self.tracing = False
        self._prof = self._range = None

    def sync(self) -> None:
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def inputs_made(self) -> None:
        """Marks the inputs made (the clip, in host memory): the device's
        memory peak counts from here, the program's alone."""
        import torch
        self.sync()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.device)

    def window_opened(self) -> None:
        """Marks the end of set-up: the window starts now."""
        self.sync()
        gc.collect()
        self.captures = n_captures()
        self.setup_s = time.perf_counter() - self.t_start

    def trace_start(self) -> None:
        """With trace on, starts torch.profiler and the port's sections."""
        if not self.trace:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        from aom_av1_lavish_torch.utils import profiler as sections

        from .trace import WINDOW_RANGE
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.sync()
        self._prof = profile(activities=acts)
        self._prof.start()
        self._range = torch.profiler.record_function(WINDOW_RANGE)
        self._range.__enter__()
        sections.reset()
        sections.enable(True)
        self.tracing = True

    def trace_stop(self) -> None:
        """Ends the traced part (the device synchronized first)."""
        if not self.tracing:
            return
        from aom_av1_lavish_torch.utils import profiler as sections
        self.sync()
        sections.enable(False)
        self._range.__exit__(None, None, None)
        self._prof.stop()
        self.tracing = False

    def events(self):
        return self._prof.events() if self._prof is not None else None


def n_captures() -> int:
    """CUDA graphs the port's P-frame programs have captured so far."""
    from aom_av1_lavish_torch.ops import graphs
    return sum(len(p.captures) for p in graphs.PROGRAMS.values())


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        "nvidia-smi: no reading"


def build_port(device) -> None:
    """Builds the port's CUDA kernels (on a CUDA device) and its native
    runtime, or finds them built in the checkout (build/torch_kernels/,
    aom_av1_lavish_torch/runtime/_build/)."""
    from aom_av1_lavish_torch.ops import build
    from aom_av1_lavish_torch.runtime import native_available
    if device.type == "cuda":
        build.build()
    if not native_available():
        raise BenchError("the port's native runtime did not build")


def percentile(values, q: float) -> float:
    """The q-th percentile (0 < q < 100) by linear interpolation between
    the closest ranks (statistics.quantiles, inclusive)."""
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=100, method="inclusive")[
        round(q) - 1]


def end_to_end(cell: Cell, out: Outcome, quality: dict, setup_s: float):
    """The cell's end-to-end metrics from the window and the check."""
    val = {
        "encode_fps": lambda: out.frames / out.window_s,
        "frame_latency_p95_ms": lambda: (
            percentile(out.latencies_s, 95) * 1e3 if out.latencies_s
            else None),
        "kbytes_per_frame": lambda: out.stream_bytes / out.frames / 1e3,
        "psnr_y_db": lambda: quality.get("psnr_y_db"),
        "setup_s": lambda: setup_s,
    }
    metrics = {}
    for m in cell.end_to_end:
        v = val[m["name"]]()
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    return metrics


def per_layer(cell: Cell, trace, bench: str = HERE) -> dict:
    """The cell's per-layer metrics, each read by its reader from the
    trace; a reader that finds nothing leaves its metric out."""
    metrics = {}
    for m in cell.per_layer:
        v = load_plugin("metrics", m["name"], bench).read(trace)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return metrics


def judge(cell: Cell, out: Outcome) -> tuple:
    """The reference's verdict on what the window wrote -> (correct, the
    numbers compared with their limits, quality)."""
    from .reference.compare import check_stream
    chk = out.check
    cfg = cell.config
    quality = check_stream(chk["path"], chk["n_coded"], chk["recon"],
                           chk["sources"], cfg["frame_width"],
                           cfg["frame_height"])
    limits = cfg["limits"]
    compared = {"mismatch_samples": quality["mismatch_samples"],
                "frames_missing": chk["frames_missing"]}
    if chk.get("streams_differing") is not None:
        compared["streams_differing"] = chk["streams_differing"]
    numbers = {k: {"value": v, "max": limits[k]} for k, v in compared.items()}
    correct = all(v["value"] <= v["max"] for v in numbers.values())
    return correct, numbers, quality


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             t_start: float, device=None, bench: str = HERE):
    """One run of cell `name` -> (result, lines to print before it,
    lines for standard error).  device=None: the card, which the cell
    must find; tests pass "cpu", which skips the look for a card."""
    import torch

    cell = load_cell(name, bench)
    if device is None:
        if not torch.cuda.is_available():
            raise BenchError("no CUDA device (torch.cuda.is_available() "
                             "is False)")
        if torch.cuda.device_count() < cell.chips:
            raise BenchError(f"{cell.name} needs {cell.chips} device(s); "
                             f"{torch.cuda.device_count()} found")
        device = "cuda"
    dev = torch.device(device)
    build_port(dev)
    driver = load_plugin("drivers", cell.traffic["driver"], bench)
    tmp_root = tempfile.mkdtemp(prefix="bench_",
                                dir=os.environ.get("TMPDIR") or None)
    try:
        ctx = Context(cell, seed, seconds, trace, dev, tmp_root, t_start)
        out = driver.run(ctx)
        ctx.trace_stop()
        peak = (torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else 0)
        found = blocked_modules()
        if found:
            raise BenchError(f"the run loaded {found}")
        device_rec = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                      "kind": (torch.cuda.get_device_name(dev)
                               if dev.type == "cuda" else "cpu"),
                      "count": cell.chips, "memory_peak_bytes": int(peak)}
        lines = list(out.lines)
        lines.append(f"programs captured in the window: "
                     f"{n_captures() - ctx.captures}")
        breakdown = None
        t_read = time.perf_counter()
        if trace:
            from .trace import Trace, breakdown as make_breakdown
            tr = Trace.from_profiler(ctx.events(), out.spans, out.traced,
                                     cell)
            metrics = per_layer(cell, tr, bench)
            device_rec["busy_s"] = tr.busy_s()
            device_rec["window_s"] = tr.window_s
            breakdown = make_breakdown(tr)
            lines.append(f"trace: {len(tr.device)} device operations, "
                         f"{len(tr.sections)} sections, read in "
                         f"{time.perf_counter() - t_read:.1f} s")
        t_check = time.perf_counter()
        correct, numbers, quality = judge(cell, out)
        if not trace:
            metrics = end_to_end(cell, out, quality, ctx.setup_s)
        if quality.get("error"):
            lines.append(f"reference: {quality['error']}")
        lines.append(f"check: {quality['coded_decoded']} coded frames "
                     f"decoded of {out.check['n_coded']}, "
                     f"{quality['shown']} shown, Y PSNR "
                     f"{quality['psnr_y_db']}; the reference took "
                     f"{time.perf_counter() - t_check:.1f} s")
    finally:
        shutil.rmtree(tmp_root, ignore_errors=True)
    result = {"correct": bool(correct), "attempted": out.attempted,
              "failed": out.failed, "metrics": metrics, "device": device_rec}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compared"] = numbers
    err = [f"compared {k}: {v['value']} (limit {v['max']})"
           for k, v in numbers.items()]
    return result, lines, err


def main(argv=None, t_start: float | None = None) -> int:
    import argparse
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="One run of a cell of the "
                                 "port's benchmark (BENCHMARK.json).")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    opts = ap.parse_args(argv)
    try:
        result, lines, err = run_cell(opts.workload, opts.seed,
                                      opts.seconds, bool(opts.trace),
                                      t_start)
    except BenchError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    found = blocked_modules()
    if found:
        print(f"benchmark: the run loaded {found}", file=sys.stderr)
        return 2
    print(f"card: {gpu_line()}", flush=True)
    for ln in lines:
        print(ln, flush=True)
    for ln in err:
        print(ln, file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
