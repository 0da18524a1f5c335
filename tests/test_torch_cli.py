"""The port's CLI (aom_av1_lavish_torch/apps/enc.py and dec.py) against
the JAX package's on the CPU: one 96x64 y4m clip written by utils/y4m.py,
encoded by both packages' apps.enc.main with --tpu (the port's also with
--device cpu) in one-pass, two-pass and frame-parallel (--fp-mt 1) mode,
must give equal IVF bytes, and both apps.dec.main equal y4m bytes.  The
JAX encodes run once per module (their XLA compiles are the file's
time)."""

import os

import numpy as np
import pytest
import torch

from aom_av1_lavish_tpu.apps import dec as jdec
from aom_av1_lavish_tpu.apps import enc as jenc
from aom_av1_lavish_torch.apps import dec as tdec
from aom_av1_lavish_torch.apps import enc as tenc
from aom_av1_lavish_torch.utils.y4m import read_y4m, write_y4m

W, H, N = 96, 64, 5
#: --cpu-used 8 (wavefront KEY, no TPL or filter): the cheapest JAX
#: compile of the device route
COMMON = ["--tpu", "--cpu-used", "8", "--cq-level", "80", "--gf-length", "4",
          "-q"]
MODES = {
    "1-pass": ["--enable-cdef", "0"],
    "2-pass": ["--passes", "2"],
    "fp-mt": ["--fp-mt", "1", "--enable-cdef", "0"],
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tests run in several worker processes on a few cores.  torch's
    OpenMP pool, as wide as the machine in every worker, then waits at
    each barrier for threads that are not scheduled (measured: the same
    trial sweeps 50 times slower in six processes of eight threads than in
    six of one), so this file computes on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clip():
    """A textured pan with moving chroma."""
    rng = np.random.default_rng(11)
    yy, xx = np.mgrid[0:H + 32, 0:W + 32]
    base = (128 + 60 * np.sin(yy / 11.0) * np.cos(xx / 7.0)
            + rng.normal(0, 3, yy.shape)).clip(0, 255).astype(np.uint8)
    return [(np.ascontiguousarray(base[i:i + H, 2 * i:2 * i + W]),
             np.ascontiguousarray(base[i:i + H // 2, :W // 2] // 2 + 60),
             np.ascontiguousarray(base[:H // 2, i:i + W // 2] // 2 + 40))
            for i in range(N)]


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """mode -> {package: (IVF bytes, decoded y4m bytes)}."""
    d = tmp_path_factory.mktemp("cli")
    src = str(d / "in.y4m")
    write_y4m(src, _clip(), W, H)
    out = {}
    for mode, extra in MODES.items():
        out[mode] = {}
        for name, enc, dec, dev in (("jax", jenc, jdec, []),
                                    ("port", tenc, tdec,
                                     ["--device", "cpu"])):
            ivf = str(d / f"{name}_{mode}.ivf")
            y4m = str(d / f"{name}_{mode}.y4m")
            assert enc.main([src, "-o", ivf] + COMMON + extra + dev) == 0
            assert dec.main([ivf, "-o", y4m]) == 0
            out[mode][name] = (_read(ivf), _read(y4m), y4m)
    return out


@pytest.mark.parametrize("mode", list(MODES))
def test_cli_ivf_matches_jax(runs, mode):
    jax_ivf, port_ivf = runs[mode]["jax"][0], runs[mode]["port"][0]
    assert len(port_ivf) > 32 + N * 12
    assert port_ivf == jax_ivf


@pytest.mark.parametrize("mode", list(MODES))
def test_cli_decoded_y4m_matches_jax(runs, mode):
    """Both apps.dec write the same y4m bytes, and it holds every frame at
    the clip's size."""
    assert runs[mode]["port"][1] == runs[mode]["jax"][1]
    frames, w, h, sub = read_y4m(runs[mode]["port"][2])
    assert (len(frames), w, h, sub) == (N, W, H, "420")


def test_cli_decoded_frames_are_close_to_the_source(runs):
    src = _clip()
    frames = read_y4m(runs["1-pass"]["port"][2])[0]
    for f, s in zip(frames, src):
        mse = np.mean((f[0].astype(np.float64) - s[0]) ** 2)
        assert 10 * np.log10(255.0 ** 2 / max(mse, 1e-9)) > 30.0


def test_cli_device_defaults_to_the_card(tmp_path, monkeypatch):
    """Without --device the encoder wants the card: with none it stops
    with the RuntimeError of resolve_device and writes nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src = str(tmp_path / "in.y4m")
    write_y4m(src, _clip()[:2], W, H)
    ivf = str(tmp_path / "out.ivf")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tenc.main([src, "-o", ivf] + COMMON)
    assert not os.path.exists(ivf)


def test_cli_has_the_jax_flags_and_device():
    """Every flag of the JAX package's encoder CLI, and --device."""
    def flags(mod):
        return {o for a in mod.build_parser()._actions
                for o in a.option_strings}
    assert flags(tenc) - flags(jenc) == {"--device"}
    assert flags(jenc) <= flags(tenc)
    assert flags(tdec) == flags(jdec)
