"""The comparison that decides `correct`, driven through whole runs of the
harness on the CPU at 96x64 (the look for a card skipped): the program
as it is reads correct, and the control and each fault that a cell can
have read not correct."""

import time

import pytest

from faults import plant
from small import small_bench

from benchmark.harness import run_cell

CELLS = ("ra_good.vod_1080p_gop120", "rt_live.call_1080p30")
FAULTS = ("control", "state_unchanged", "state_unchanged_late",
          "half_left_out", "answer_altered")


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return small_bench(str(tmp_path_factory.mktemp("small")))


def _run(bench, cell, name, seed=2 ** 31 + 11):
    with plant(name):
        result, _, _ = run_cell(cell, seed, 0.5, False, time.perf_counter(),
                                device="cpu", bench=bench)
    return result


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(bench, cell):
    result = _run(bench, cell, "none")
    assert result["correct"], result["compared"]
    assert all(v["value"] == 0 for v in result["compared"].values())
    assert result["failed"] == 0


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(bench, cell, fault):
    result = _run(bench, cell, fault)
    assert not result["correct"], (fault, result["compared"])
