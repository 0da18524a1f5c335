"""The readers of the port's own spans and counters (the realtime
pipeline's sections, the tile walk, the emit's own time, the copies to
the host) on synthetic traces, a parent-like port that lacks them, and a
traced CPU run of each cell through tools/trace_sections.py."""

import os
import sys

import pytest

from small import ROOT, small_bench

from benchmark import harness
from benchmark.trace import Trace

READERS = ("live.hold_ms_per_frame", "live.tile_walk_ms_per_frame",
           "live.emit_self_ms_per_frame", "gop.tile_walk_ms_per_frame",
           "gop.fetch_mb_per_frame", "gop.fetch_ms_per_frame")


def _read(name, trace):
    return harness.load_plugin("metrics", name).read(trace)


def _live():
    """Two P frames of a one-frame pipeline (us): step k ends, frame k+1
    is pulled and stepped, then frame k's emit waits for its rows and
    walks its tile; the KEY's walk lies outside every emit."""
    sections = [
        (0, 900, "encode/tile_walk"),                 # the KEY's
        (1000, 2000, "encode/rt_step"),
        (2000, 34000, "encode/rt_source"),
        (34000, 35000, "encode/rt_step"),
        (35000, 57000, "encode/rt_emit"),
        (35000, 35500, "encode/rt_realize"),
        (36000, 52000, "encode/tile_walk"),
        (51000, 53000, "encode/filter_search"),
        (57000, 67000, "encode/rt_source"),
        (67000, 68000, "encode/rt_step"),
        (68000, 90000, "encode/rt_emit"),
        (68000, 68200, "encode/rt_realize"),
        (69000, 85000, "encode/tile_walk"),
    ]
    return Trace((0, 100000), [(1000, 5000, "k")], sections, {},
                 {"frames": 3, "keys": 1, "steps": 2})


def test_live_hold_pairs_steps_and_realizes_by_order():
    # frame 1: 35000 - 2000; frame 2: 68000 - 35000
    assert _read("live.hold_ms_per_frame", _live()) == pytest.approx(33.0)


def test_live_tile_walk_counts_only_the_p_frames():
    assert _read("live.tile_walk_ms_per_frame", _live()) \
        == pytest.approx(16.0)


def test_live_emit_self_is_the_emit_less_what_it_encloses():
    # emit 1: 22 ms less 0.5 + (36..53 = 17) = 4.5; emit 2: 22 less 0.2
    # + 16 = 5.8
    assert _read("live.emit_self_ms_per_frame", _live()) \
        == pytest.approx((4.5 + 5.8) / 2)


def test_live_readers_find_nothing_without_the_sections():
    bare = Trace((0, 100), [(0, 10, "k")], [(0, 5, "encode/tile_walk")],
                 {}, {"frames": 3, "steps": 2})
    for name in READERS[:3]:
        assert _read(name, bare) is None, name


def _vod(**counts):
    sections = [(0, 4000, "gop/key"), (100, 900, "encode/tile_walk"),
                (500, 700, "key/fetch"), (520, 680, "encode/fetch"),
                (5000, 6000, "gop/chain_device"),
                (5800, 6000, "encode/fetch"),
                (6000, 9000, "gop/emit"), (6100, 8100, "encode/tile_walk"),
                (9000, 12000, "gop/emit"), (9100, 11100, "encode/tile_walk")]
    device = [(530, 600, "Memcpy DtoH (Device -> Pageable)"),
              (5000, 5800, "conv8_plane_kernel"),
              (5850, 5990, "Memcpy DtoH (Device -> Pageable)"),
              (5900, 5950, "Memcpy DtoH (Device -> Pageable)"),
              (7000, 7100, "Memcpy DtoH (Device -> Pinned)"),
              (6500, 6600, "Memcpy HtoD (Pageable -> Device)")]
    return Trace((0, 12000), device, sections, {}, counts)


def test_gop_tile_walk_leaves_out_the_key():
    assert _read("gop.tile_walk_ms_per_frame", _vod(frames=3, inter=2)) \
        == pytest.approx(2.0)


def test_gop_fetch_ms_is_the_copies_inside_the_fetches():
    # 70 us in key/fetch, 140 in the chain's fetch (a nested copy once);
    # the pinned copy outside every fetch is left out
    assert _read("gop.fetch_ms_per_frame", _vod(frames=2, inter=1)) \
        == pytest.approx(0.21 / 2)
    assert _read("gop.fetch_ms_per_frame", _vod()) is None


@pytest.fixture
def counted():
    from aom_av1_lavish_torch.utils import profiler
    profiler.reset()
    profiler.enable(True)
    profiler.count("fetch_bytes", 3_000_000)
    profiler.count("fetch_bytes/group/r16", 3_000_000)
    profiler.enable(False)
    yield profiler
    profiler.reset()


def test_gop_fetch_mb_reads_the_port_counter(counted):
    assert _read("gop.fetch_mb_per_frame", _vod(frames=2)) \
        == pytest.approx(1.5)
    counted.reset()
    assert _read("gop.fetch_mb_per_frame", _vod(frames=2)) is None


def test_gop_fetch_mb_on_a_port_without_counters(counted, monkeypatch):
    """A port without the counter family (the parent of this metric)
    reads nothing and does not raise."""
    monkeypatch.delattr(counted, "counters")
    assert _read("gop.fetch_mb_per_frame", _vod(frames=2)) is None


@pytest.mark.parametrize("cell", ["ra_good.vod_1080p_gop120",
                                  "rt_live.call_1080p30"])
def test_traced_cpu_run_reads_the_new_metrics(tmp_path, cell):
    """A traced run on the CPU at 96x64 prints every new metric that has
    something to read there (no device: gop.fetch_ms_per_frame reads no
    copy), and the sections and counters it read them from."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        from trace_sections import traced
    finally:
        sys.path.remove(os.path.join(ROOT, "tools"))
    bench = small_bench(str(tmp_path))
    result, _, kept = traced(cell, 2 ** 31 + 11, 0.5, device="cpu",
                             bench=bench)
    assert result["correct"], result["compared"]
    got = result["metrics"]
    if cell.startswith("rt_live"):
        for name in READERS[:3]:
            assert got[name]["value"] > 0, name
        for name in ("encode/rt_step", "encode/rt_realize",
                     "encode/rt_emit", "encode/rt_source"):
            assert kept["calls"][name] > 0, name
        assert kept["counters"]["fetch_bytes/rt_rows"] > 0
    else:
        assert got["gop.tile_walk_ms_per_frame"]["value"] > 0
        # one traced encode of 12 frames
        assert got["gop.fetch_mb_per_frame"]["value"] == pytest.approx(
            kept["counters"]["fetch_bytes"] / 1e6 / 12)
        assert kept["counters"]["fetch_bytes/group/r16"] > 0
        assert "gop.fetch_ms_per_frame" not in got
