"""The reader of gop.fetch_pinned_share: the port's counter
fetch_pinned_bytes over its counter fetch_bytes, on synthetic counters, on
a port that lacks the pinned counter or the counter family, and in a
traced CPU run of the VOD cell (no card, so nothing lands in pinned memory
and nothing is counted)."""

import os
import sys

import pytest

from small import ROOT, small_bench

from benchmark import harness
from benchmark.trace import Trace


def _read(trace):
    return harness.load_plugin("metrics", "gop.fetch_pinned_share").read(
        trace)


def _vod():
    sections = [(1000, 2000, "encode/fetch"), (3000, 3500, "key/fetch")]
    return Trace((0, 10000), [(1000, 1800, "Memcpy DtoH (Device -> Pinned)")],
                 sections, {}, {"frames": 2, "keys": 1})


@pytest.fixture
def profiler():
    from aom_av1_lavish_torch.utils import profiler
    profiler.reset()
    yield profiler
    profiler.reset()


@pytest.mark.parametrize("fetched,pinned,share", [
    (3_000_000, 3_000_000, 100.0), (3_000_000, 750_000, 25.0),
    (3_000_000, 0, 0.0), (3_000_000, None, None), (0, None, None)])
def test_fetch_pinned_share_reads_the_port_counters(profiler, fetched,
                                                    pinned, share):
    """100 x pinned bytes over fetched bytes; no pinned counter (a port
    without it, or the CPU) or no bytes fetched reads nothing."""
    profiler.enable(True)
    if fetched:
        profiler.count("fetch_bytes", fetched)
    if pinned is not None:
        profiler.count("fetch_pinned_bytes", pinned)
    profiler.enable(False)
    assert _read(_vod()) == share


def test_fetch_pinned_share_counts_only_while_sections_are_on(profiler):
    profiler.count("fetch_bytes", 100)
    profiler.count("fetch_pinned_bytes", 100)
    assert _read(_vod()) is None


def test_fetch_pinned_share_on_a_port_without_counters(profiler,
                                                       monkeypatch):
    """A port without the counter family reads nothing and does not
    raise."""
    monkeypatch.delattr(profiler, "counters")
    assert _read(_vod()) is None


def test_fetch_pinned_share_has_its_entry():
    import json
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    entry, = [m for m in spec["per_layer"]
              if m["name"] == "gop.fetch_pinned_share"]
    gop = [w["name"] for w in spec["workloads"]
           if not w["name"].startswith("rt_live")]
    assert entry["layer"] == "copies to the host"
    assert entry["moves"] == "encode_fps" and entry["workloads"] == gop


def test_traced_cpu_vod_run_leaves_the_share_out(tmp_path):
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        from trace_sections import traced
    finally:
        sys.path.remove(os.path.join(ROOT, "tools"))
    bench = small_bench(str(tmp_path))
    result, _, kept = traced("ra_good.vod_1080p_gop120", 2 ** 31 + 17, 0.5,
                             device="cpu", bench=bench)
    assert result["correct"], result["compared"]
    assert kept["counters"]["fetch_bytes"] > 0
    assert "fetch_pinned_bytes" not in kept["counters"]
    assert "gop.fetch_pinned_share" not in result["metrics"]
