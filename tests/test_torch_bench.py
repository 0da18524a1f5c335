"""The port's benchmark (bench_torch.py, bench_full_torch.py) on the CPU:
the cell runner on the main cell at 96x64 (a cold run and one warm run),
the checks that refuse a run (other bytes, a capture in a warm run, a
short decode), the device summary of a profiled run and its idle-stretch
labeller on synthetic events, --pair's order A, B, B, A, and the refusal
to run without a card.  Times taken here are the CPU's and are only
checked for their shape.  Imports no JAX."""

import dataclasses
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

import bench_torch as B

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: every field of a cell's record
FIELDS = ("metric", "value", "unit", "runs_s", "median_s", "min_s", "max_s",
          "spread", "cold_s", "bytes", "psnr_y", "stages_s", "launches",
          "peak_mib", "card", "decoded_frames")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several worker processes share a few cores: torch's OpenMP pool, as
    wide as the machine in each, would stall at every barrier."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _small(name, **kw):
    return dataclasses.replace(B.CELLS[name], w=96, h=64, **kw)


def test_main_cell_record_at_96x64_on_the_cpu():
    """The main cell (bench.py's workload, default configuration) through
    the runner at 96x64: a cold run and one warm run that wrote the same
    bytes, every field of the record, the stream decoded to its 8 frames
    above 30 dB, and launch counters that are all 0 (only a CUDA launch
    counts)."""
    rec = B.run_cell(_small(B.MAIN, warm=1), device="cpu")
    assert set(FIELDS) <= set(rec)
    assert rec["metric"] == B.MAIN and rec["unit"] == "frames/s"
    assert rec["kw"] == B.KW_DEFAULT == dict(
        qindex=120, gf_length=8, use_tpu=True, enable_cdef=False)
    assert len(rec["runs_s"]) == 1 and rec["spread"] == 0.0
    assert rec["median_s"] == rec["min_s"] == rec["max_s"] > 0
    assert rec["value"] == pytest.approx(8 / rec["median_s"])
    assert rec["cold_s"] > 0 and rec["bytes"] > 32
    assert rec["decoded_frames"] == 8 and rec["psnr_y"] > 30.0
    assert rec["launches"] and set(rec["launches"].values()) == {0}
    assert {"gop/key", "gop/chain_device", "gop/tpl"} <= set(rec["stages_s"])
    assert all(k.startswith(B.SECTIONS) for k in rec["stages_s"])
    assert rec["device"] == "cpu" and rec["peak_mib"] is None
    assert rec["card"] is None
    json.dumps(rec)


def _fake_entry(payload_of_run):
    """An entry whose n-th run writes payload_of_run(n) as its stream."""
    def entry(cell, frames, path, dev):
        runs = []

        def job():
            runs.append(None)
            with open(path, "wb") as f:
                f.write(payload_of_run(len(runs)))
        return job
    return entry


def test_a_warm_run_that_writes_other_bytes_is_refused(monkeypatch):
    monkeypatch.setitem(B.ENTRIES, "gop", _fake_entry(lambda n: bytes([n])))
    with pytest.raises(B.BenchError, match="other bytes than the cold run"):
        B.run_cell(_small(B.MAIN, warm=2), device="cpu")


def test_a_warm_run_that_captures_again_is_refused(monkeypatch):
    caps = iter(range(100))
    monkeypatch.setitem(B.ENTRIES, "gop", _fake_entry(lambda n: b"same"))
    monkeypatch.setattr(B, "n_captures", lambda: next(caps))
    with pytest.raises(B.BenchError, match="captured"):
        B.run_cell(_small(B.MAIN, warm=1), device="cpu")


def test_a_stream_that_decodes_short_is_refused(monkeypatch):
    """The decode must return every frame: the lossless stream of 2
    frames does not stand for a cell of 3."""
    from aom_av1_lavish_torch.encoder import encode_lossless_ivf

    def entry(cell, frames, path, dev):
        return lambda: encode_lossless_ivf(path, frames[:2], cell.w, cell.h,
                                           device=dev)
    monkeypatch.setitem(B.ENTRIES, "lossless", entry)
    with pytest.raises(B.BenchError, match="decoded to 2 of 3 frames"):
        B.run_cell(_small("lossless_allintra_352x288", frames=3, warm=1),
                   device="cpu")


def test_idle_gaps_are_the_longest_stretches_labelled_by_section():
    """Device spans (µs) with overlaps, host sections nested in gop/key:
    the stretches between the spans and at both ends of the run's window,
    longest first, each at its start from the window's, labelled with the
    innermost section open at its midpoint, None outside every section."""
    busy = [(0, 10), (12, 20), (50, 60), (58, 70), (100, 101)]
    sections = [(-1, 200, "gop/key"), (25, 45, "key/emit"),
                (70, 99, "gop/emit")]
    gaps = B.idle_gaps(busy, sections, window=(-5, 110))
    assert [(round(g["ms"] * 1e3, 6), round(g["at_ms"] * 1e3, 6),
             g["section"]) for g in gaps] == [
        (30, 25, "key/emit"), (30, 75, "gop/emit"), (9, 106, "gop/key"),
        (5, 0, None), (2, 15, "gop/key")]
    assert B.idle_gaps(busy, sections, window=(-5, 110), n=2) == gaps[:2]
    assert B.idle_gaps(busy, [])[0]["section"] is None
    assert len(B.idle_gaps(busy, sections)) == 3


def _event(name, start, end, device=DeviceType.CUDA):
    return SimpleNamespace(name=name, device_type=device,
                           time_range=SimpleNamespace(start=start, end=end))


def test_device_summary_of_profiler_events():
    """Kernels by K1-K4 and the rest, memcpy/memset apart, a section's
    range on the device timeline left out, the busy share over the run's
    wall clock, the longest operations and the idle stretches with their
    host section."""
    events = [
        _event(B.RUN_RANGE, 0, 1000, DeviceType.CPU),
        _event("gop/key", 0, 400, DeviceType.CPU),
        _event("gop/emit", 600, 1000, DeviceType.CPU),
        _event("gop/key", 0, 300),      # the range again, on the device
        _event("void wave_encode_kernel<4>(...)", 10, 110),
        _event("ssd_plane_kernel", 110, 130),
        _event("void at::native::elementwise_kernel<128>", 130, 150),
        _event("void at::native::elementwise_kernel<128>", 150, 170),
        _event("Memcpy DtoH (Device -> Pinned)", 300, 310),
        _event("aten::add", 5, 6, DeviceType.CPU),
    ]
    rec = B.device_summary(events, 0.001, {"gop/key", "gop/emit"})
    assert rec["kernel_ms"] == pytest.approx(0.16)
    assert rec["device_busy"] == pytest.approx(0.16)
    assert rec["hand_ms"]["quantize_b_vec"] == {"ms": 0.1, "runs": 1}
    assert rec["hand_ms"]["ssd_surface"] == {"ms": 0.02, "runs": 1}
    assert rec["hand_ms"]["convolve_8tap"] == {"ms": 0.0, "runs": 0}
    assert rec["other_kernels"] == {"ms": 0.04, "runs": 2}
    assert rec["memcpy_memset"] == {"ms": 0.01, "runs": 1}
    assert [(t["name"][:10], t["runs"]) for t in rec["top_device_ops"]] == \
        [("void wave_", 1), ("void at::n", 2), ("ssd_plane_", 1),
         ("Memcpy Dto", 1)]
    assert [(round(g["ms"] * 1e3, 6), g["section"])
            for g in rec["idle_gaps"]] == [
        (690, "gop/emit"), (130, "gop/key"), (10, "gop/key")]
    with pytest.raises(B.BenchError, match="no device kernel"):
        B.device_summary(events[:2], 0.001, {"gop/key"})


def test_pair_runs_the_checkouts_in_turns(capsys, monkeypatch):
    """--pair of this checkout with itself on one small cell on the CPU:
    four processes, records printed in the order A, B, B, A with the same
    bytes, then one line with both sides."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    recs = B.pair([ROOT, ROOT], ["lossless_allintra_352x288"], device="cpu",
                  over=dict(w=96, h=64, warm=1), timeout=300)
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [r["side"] for r in lines[:4]] == list("ABBA")
    assert [r["side"] for r in recs] == list("ABBA")
    assert all("error" not in r for r in recs), recs
    assert len({r["bytes"] for r in recs}) == 1
    assert lines[4]["pair"] == "lossless_allintra_352x288"
    assert lines[4]["A_bytes"] == lines[4]["B_bytes"] == [recs[0]["bytes"]] * 2


@pytest.mark.parametrize("argv", [["bench_torch.py"],
                                  ["bench_torch.py", "--pair", ".", "."],
                                  ["bench_full_torch.py"]])
def test_scripts_exit_non_zero_without_a_card(argv):
    """No card and no device="cpu": each script says so and exits with a
    code other than 0, printing no record."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, *argv], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert "metric" not in proc.stdout


def test_cells_cover_the_benchmark_matrix():
    """Every row of bench_full.py that the port has a path for, and the
    cells PERF.md read by hand, with their entry points, sizes, frames
    and keywords; the main cell is bench.py's workload."""
    want = {
        "gop_1080p_default": ("gop", 1920, 1088, 8, 120),
        "gop_1080p_cpu8": ("gop", 1920, 1088, 8, 120),
        "gop_1080p_fpmt": ("gop", 1920, 1088, 8, 120),
        "lowdelay_1080p": ("lowdelay", 1920, 1088, 4, 60),
        "realtime_1080p_4": ("realtime", 1920, 1088, 4, 90),
        "twopass_1080p": ("twopass", 1920, 1088, 8, 120),
        "gop_720x576_default": ("gop", 720, 576, 8, 120),
        "lossless_allintra_352x288": ("lossless", 352, 288, 8, None),
        "lossy_allintra_352x288": ("allintra", 352, 288, 8, 60),
        "lossy_allintra_rdo_352x288": ("rdo", 352, 288, 2, 80),
        "inter_gop_352x288": ("gop", 352, 288, 8, 60),
        "inter_gop_1280x720": ("gop", 1280, 720, 8, 60),
        "inter_gop_1920x1088": ("gop", 1920, 1088, 8, 60),
        "inter_gop_cpu_backend_1280x720": ("gop", 1280, 720, 8, 60),
        "rtc_352x288": ("realtime_stream", 352, 288, 8, 90),
        "rtc_1920x1088": ("realtime_stream", 1920, 1088, 8, 90),
        "rtc_nonrd_host_352x288": ("realtime_host", 352, 288, 8, 90),
        "decode_lossless_352x288": ("decode", 352, 288, 8, None),
        "speed_ladder_cpu2": ("gop", 352, 288, 2, 60),
        "speed_ladder_cpu5": ("gop", 352, 288, 2, 60),
        "speed_ladder_cpu8": ("gop", 352, 288, 2, 60),
    }
    got = {n: (c.entry, c.w, c.h, c.frames, c.kw.get("qindex"))
           for n, c in B.CELLS.items()}
    assert got == want
    assert all(c.entry in B.ENTRIES for c in B.CELLS.values())
    assert [n for n, c in B.CELLS.items() if c.device] == \
        ["inter_gop_cpu_backend_1280x720"]
    assert B.CELLS["gop_1080p_cpu8"].kw["cpu_used"] == 8
    assert B.CELLS["gop_1080p_fpmt"].kw["frame_parallel"] is True
    assert B.CELLS["speed_ladder_cpu5"].kw == dict(qindex=60, gf_length=2,
                                                   cpu_used=5)
    assert B.CELLS[B.MAIN].expected == B.EXPECTED["default"]
    assert B.EXPECTED["default"]["avl_wave_encode"] == 187
