"""On a card: each cell through the benchmark's command, a short window,
and the control on one seed.  Skipped without a CUDA device (decided
inside each test):

    python -m pytest benchmark/tests/test_benchmark_card.py -q
"""

import json
import os
import subprocess
import sys

import pytest

from small import ROOT

CELLS = ("ra_good.vod_1080p_gop120", "rt_live.call_1080p30")


def _card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")


def _run(*args):
    out = subprocess.run([sys.executable, *args], capture_output=True,
                         text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return [json.loads(ln) for ln in out.stdout.splitlines()
            if ln.startswith("{")]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", (0, 1))
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell, trace):
    _card()
    result = _run("benchmark/run.py", "--workload", cell, "--seed",
                  str(2 ** 31 + 5), "--seconds", "5", "--trace",
                  str(trace))[-1]
    assert result["correct"], result["compared"]
    assert result["device"]["platform"] == "gpu"
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_on_the_card(cell):
    _card()
    rows = _run(os.path.join("benchmark", "tests", "faults.py"),
                "--workload", cell, "--plant", "control", "--seconds", "3",
                "--seed", "17")
    assert rows and not any(r["correct"] for r in rows)
