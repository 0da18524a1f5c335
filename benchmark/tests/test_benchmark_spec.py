"""BENCHMARK.json against the benchmark's format: its keys, names,
units, limits, the files it names, and the budget of a full check."""

import json
import os
import re

import pytest

from small import BENCH, ROOT

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    SPEC = json.load(f)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_command_and_paths():
    cmd, paths = SPEC["command"], SPEC["paths"]
    assert 1 <= len(paths) <= 16 and 1 <= len(cmd) <= 32
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in paths)
    assert all(_line(w) and not w.startswith("/") and ".." not in w
               for w in cmd)
    files = [w for w in cmd if os.path.exists(os.path.join(ROOT, w))]
    assert files and all(any(f == p or f.startswith(p + "/") for p in paths)
                         for f in files)
    assert not any(p.endswith("_torch") for p in paths)


def test_run_seconds_fits_a_full_check():
    s = SPEC["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_entries():
    names = []
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    assert len(set(names)) == len(names) and 1 <= len(names) <= 24
    cells = []
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert _line(w["why"])
        cells.append(w["name"])
    assert len(set(cells)) == len(cells) and 1 <= len(cells) <= 24
    assert len({(w["config"], w["traffic"]) for w in SPEC["workloads"]}) \
        == len(cells)
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(
        1, len(cells) // 4)
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == set(names)
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
        assert m["moves"] in [e["name"] for e in SPEC["end_to_end"]]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= set(cells)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    assert "setup_s" in [m["name"] for m in SPEC["end_to_end"]]


def test_every_cell_reports_enough():
    for w in SPEC["workloads"]:
        e2e = [m["name"] for m in SPEC["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in e2e and len(e2e) >= 2
        per = [m for m in SPEC["per_layer"] if m["moves"] in e2e
               and w["name"] in m.get("workloads", [w["name"]])]
        assert per
        for m in SPEC["per_layer"]:
            if w["name"] in m.get("workloads", []):
                assert m["moves"] in e2e


@pytest.mark.parametrize("c", SPEC["configs"], ids=lambda c: c["name"])
def test_config_files(c):
    assert any(c["file"].startswith(p + "/") for p in SPEC["paths"])
    with open(os.path.join(ROOT, c["file"])) as f:
        cfg = json.load(f)
    assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
    assert cfg["reduced"] == c["reduced"]
    assert set(cfg["source_values"]) == set(c["reduced"])
    for k in ("entry", "kwargs", "frame_width", "frame_height", "limits",
              "assumed", "guarantees"):
        assert k in cfg
    assert cfg["frame_width"] % 16 == 0 and cfg["frame_height"] % 16 == 0


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_traffic_and_driver_files(w):
    path = os.path.join(BENCH, "traffic", f"{w['traffic']}.json")
    with open(path) as f:
        traffic = json.load(f)
    assert os.path.isfile(os.path.join(BENCH, "drivers",
                                       f"{traffic['driver']}.py"))


@pytest.mark.parametrize("m", SPEC["per_layer"], ids=lambda m: m["name"])
def test_metric_readers(m):
    assert os.path.isfile(os.path.join(BENCH, "metrics", f"{m['name']}.py"))


def test_files_are_named_from_names():
    for dirpath, _, files in os.walk(BENCH):
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
            if "__pycache__" in rel:
                continue
            assert PATH.match(rel), rel
