"""Cells, mixes, drivers and metrics are data found by name: a test adds
a configuration, a traffic mix, a driver and a per-layer metric as new
files and new entries in a copy of BENCHMARK.json, edits no file that is
there, and runs the new cell through the harness on the CPU."""

import json
import os
import time

import pytest

from small import small_bench

from benchmark import harness

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def added(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("added"))
    bench = small_bench(tmp)
    before = {os.path.join(d, f): os.path.getmtime(os.path.join(d, f))
              for d, _, fs in os.walk(bench) for f in fs}
    with open(os.path.join(bench, "configs", "ra_good.json")) as f:
        cfg = json.load(f)
    cfg.update(name="ra_fast", kwargs=dict(cfg["kwargs"], cpu_used=8))
    with open(os.path.join(bench, "configs", "ra_fast.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bench, "traffic", "clips_4f.json"), "w") as f:
        json.dump({"driver": "gop_stream_again", "frames_per_encode": 4,
                   "video": {"noise": 3.0}, "warm_frames": 4, "sample_among": 2,
                   "check_coded_frames": 4,
                   "trace_seconds": 0}, f)
    with open(os.path.join(bench, "drivers", "gop_stream.py")) as f:
        driver = f.read()
    with open(os.path.join(bench, "drivers", "gop_stream_again.py"),
              "w") as f:
        f.write(driver)
    with open(os.path.join(bench, "metrics", "gop.frames_traced.py"),
              "w") as f:
        f.write("def read(trace):\n"
                "    return trace.counts.get('frames') or None\n")
    spec_path = os.path.join(tmp, "BENCHMARK.json")
    with open(spec_path) as f:
        spec = json.load(f)
    spec["configs"].append({"name": "ra_fast", "source": cfg["source"],
                            "file": "benchmark/configs/ra_fast.json",
                            "reduced": cfg["reduced"], "why": "cpu_used 8"})
    spec["workloads"].append({"name": "ra_fast.clips_4f", "config": "ra_fast",
                              "traffic": "clips_4f", "chips": 1,
                              "why": "4-frame clips at cpu_used 8"})
    for m in spec["end_to_end"]:
        if m["name"] == "encode_fps":
            m["workloads"].append("ra_fast.clips_4f")
    spec["per_layer"].append({"name": "gop.frames_traced", "unit": "frames",
                              "better": "higher", "source": "host_clock",
                              "layer": "host emit and native entropy coder",
                              "moves": "encode_fps",
                              "workloads": ["ra_fast.clips_4f"]})
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    after = {os.path.join(d, f): os.path.getmtime(os.path.join(d, f))
             for d, _, fs in os.walk(bench) for f in fs}
    assert all(after[p] == t for p, t in before.items())
    return bench


def test_new_cell_loads_from_data(added):
    cell = harness.load_cell("ra_fast.clips_4f", added)
    assert cell.config["kwargs"]["cpu_used"] == 8
    assert cell.traffic["frames_per_encode"] == 4
    assert [m["name"] for m in cell.end_to_end] == [
        "encode_fps", "kbytes_per_frame", "psnr_y_db", "setup_s"]
    assert [m["name"] for m in cell.per_layer][-1] == "gop.frames_traced"
    assert harness.load_plugin("drivers", "gop_stream_again", added).run


def test_new_cell_runs_and_prints_the_result_line(added):
    result, lines, err = harness.run_cell(
        "ra_fast.clips_4f", 987654321012, 0.5, False, time.perf_counter(),
        device="cpu", bench=added)
    assert list(result) == KEYS + ["compared"]
    assert result["correct"] and result["failed"] == 0
    assert set(result["metrics"]) == {"encode_fps", "kbytes_per_frame",
                                      "psnr_y_db", "setup_s"}
    assert all(set(v) == {"value", "unit"}
               for v in result["metrics"].values())
    assert set(result["device"]) == {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    assert [e.split(":")[0] for e in err] == [
        f"compared {k}" for k in result["compared"]]
    json.dumps(result)


def test_new_metric_is_read_in_a_traced_run(added):
    result, _, _ = harness.run_cell(
        "ra_fast.clips_4f", 5, 0.5, True, time.perf_counter(), device="cpu",
        bench=added)
    assert list(result) == KEYS + ["breakdown", "compared"]
    assert result["metrics"]["gop.frames_traced"]["value"] == 4
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def test_unknown_names_are_refused(added):
    with pytest.raises(harness.BenchError):
        harness.load_cell("ra_fast.nothing", added)
    with pytest.raises(harness.BenchError):
        harness.load_plugin("metrics", "gop.nothing", added)
