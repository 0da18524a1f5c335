"""A copy of the benchmark folder at a size the CPU holds: every
configuration at 96x64, the traffic cut to a few frames, beside a copy of
BENCHMARK.json, so that tests can add files and entries to it without
touching the benchmark itself."""

from __future__ import annotations

import json
import os
import shutil

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "benchmark")
W, H = 96, 64
#: traffic cut to the CPU: a 12-frame sequence (a KEY, GF groups of 8
#: and 3: two ARFs) and a live stream of 30 x seconds frames (15 in the
#: tests' half second); the reference decodes every coded frame of both
TRAFFIC = {"vod_gop120": {"frames_per_encode": 12, "check_coded_frames": 12,
                          "sample_among": 1},
           "live_1080p30": {"check_coded_frames": 15}}


def small_bench(tmp: str) -> str:
    """tmp/BENCHMARK.json and tmp/benchmark/ (configs, traffic, drivers,
    metrics) at the CPU's size -> the folder, for harness.run_cell's
    `bench`."""
    b = os.path.join(tmp, "benchmark")
    os.makedirs(b)
    for kind in ("configs", "traffic", "drivers", "metrics"):
        shutil.copytree(os.path.join(BENCH, kind), os.path.join(b, kind),
                        ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    for c in spec["configs"]:
        edit_json(os.path.join(tmp, c["file"]),
                  {"frame_width": W, "frame_height": H})
    for name, over in TRAFFIC.items():
        edit_json(os.path.join(b, "traffic", f"{name}.json"), over)
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    return b


def edit_json(path: str, over: dict) -> None:
    with open(path) as f:
        data = json.load(f)
    data.update(over)
    with open(path, "w") as f:
        json.dump(data, f)
