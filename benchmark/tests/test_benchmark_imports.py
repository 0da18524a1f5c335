"""What the benchmark may load: nothing of JAX or of the JAX package, by
whole top-level module name; nothing of the repository's older benchmark
scripts; and a reference that imports nothing of the port.  Also the
exits without a card and outside a checkout."""

import ast
import os
import subprocess
import sys

import pytest

from small import BENCH, ROOT

BLOCKED = {"jax", "jaxlib", "flax", "aom_av1_lavish_tpu"}
OLD = {"bench", "bench_full", "bench_torch", "bench_full_torch",
       "chip_smoke"}


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], 0
        elif isinstance(node, ast.ImportFrom):
            yield (node.module or "").split(".")[0], node.level


def _sources(top):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_nor_old_benchmark_scripts():
    for path in _sources(BENCH):
        for name, level in _imports(path):
            if level == 0:
                assert name not in BLOCKED | OLD, (path, name)


def test_the_reference_imports_nothing_of_the_port():
    allowed = {"__future__", "numpy", "dataclasses", "os", "math",
               "functools", "struct", "typing", "collections", "itertools",
               "contextlib", "enum", "io", "sys", "types", "warnings",
               "copy", "bisect", "array", "multiprocessing", "concurrent",
               "heapq", "time", "zlib", "collections.abc"}
    for path in _sources(os.path.join(BENCH, "reference")):
        for name, level in _imports(path):
            assert level > 0 or name in allowed, (path, name)


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from benchmark import harness, clips, trace, work\n"
            "from benchmark.reference import compare\n"
            "import aom_av1_lavish_torch.encoder.gop, "
            "aom_av1_lavish_torch.encoder.nonrd\n"
            "for k in ('drivers', 'metrics'):\n"
            "    import os\n"
            "    for f in os.listdir(os.path.join(%r, k)):\n"
            "        if f.endswith('.py'):\n"
            "            harness.load_plugin(k, f[:-3])\n"
            "print(harness.blocked_modules())\n" % (ROOT, BENCH))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_blocked_modules_compares_whole_names(monkeypatch):
    from benchmark import harness
    monkeypatch.setitem(sys.modules, "aom_av1_lavish_tpu_x", sys)
    monkeypatch.setitem(sys.modules, "jaxfoo", sys)
    assert harness.blocked_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.blocked_modules() == ["jax"]


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "ra_good.vod_1080p_gop120", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=ROOT)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
    assert "no CUDA device" in out.stderr


def test_outside_a_checkout_no_result(tmp_path):
    import shutil
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "ra_good.vod_1080p_gop120", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=tmp_path, env=env)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
