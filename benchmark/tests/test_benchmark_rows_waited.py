"""The reader of live.rows_waited_share: the port's counter rt_rows_waited
over the traced steps, on synthetic counters, on a port that lacks the
counter family, and in a traced CPU run of the live cell (no card, so the
rows are on the host at once and nothing is counted)."""

import os
import sys

import pytest

from small import ROOT, small_bench

from benchmark import harness
from benchmark.trace import Trace


def _read(trace):
    return harness.load_plugin("metrics", "live.rows_waited_share").read(
        trace)


def _two_steps():
    sections = [(1000, 2000, "encode/rt_step"),
                (2000, 9000, "encode/rt_emit"),
                (2500, 3000, "encode/rt_realize"),
                (9000, 10000, "encode/rt_step"),
                (10000, 17000, "encode/rt_emit"),
                (10500, 11000, "encode/rt_realize")]
    return Trace((0, 20000), [(1000, 1800, "k")], sections, {},
                 {"frames": 3, "keys": 1, "steps": 2})


@pytest.fixture
def profiler():
    from aom_av1_lavish_torch.utils import profiler
    profiler.reset()
    yield profiler
    profiler.reset()


@pytest.mark.parametrize("waits,share", [((1, 0), 50.0), ((1, 1), 100.0),
                                         ((0, 0), 0.0), ((), None)])
def test_live_rows_waited_share_reads_the_port_counter(profiler, waits,
                                                       share):
    """Each realize on the card adds 0 or 1 to rt_rows_waited; the share
    is over the traced steps (2).  No realize counted reads nothing."""
    profiler.enable(True)
    for w in waits:
        profiler.count("rt_rows_waited", w)
    profiler.enable(False)
    assert _read(_two_steps()) == share


def test_live_rows_waited_share_counts_only_while_sections_are_on(
        profiler):
    profiler.count("rt_rows_waited", 1)
    assert _read(_two_steps()) is None


def test_live_rows_waited_share_without_steps(profiler):
    profiler.enable(True)
    profiler.count("rt_rows_waited", 1)
    profiler.enable(False)
    bare = Trace((0, 100), [(0, 10, "k")], [], {}, {"frames": 1})
    assert _read(bare) is None


def test_live_rows_waited_share_on_a_port_without_counters(profiler,
                                                           monkeypatch):
    """A port without the counter family reads nothing and does not
    raise."""
    monkeypatch.delattr(profiler, "counters")
    assert _read(_two_steps()) is None


def test_traced_cpu_live_run_leaves_the_share_out(tmp_path):
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        from trace_sections import traced
    finally:
        sys.path.remove(os.path.join(ROOT, "tools"))
    bench = small_bench(str(tmp_path))
    result, _, kept = traced("rt_live.call_1080p30", 2 ** 31 + 13, 0.5,
                             device="cpu", bench=bench)
    assert result["correct"], result["compared"]
    assert kept["calls"]["encode/rt_realize"] > 0
    assert "rt_rows_waited" not in kept["counters"]
    assert "live.rows_waited_share" not in result["metrics"]
