"""The port's first pass and two-pass schedule against the plain reference
(benchmark/plain_twopass.py: plain PyTorch, float32 and int64, no
kernel), on the CPU at 96x64 and 128x96, on the benchmark's seeded clips
(benchmark/clips.py), one with a scene cut and one bright enough that the
SSD's float32 expansion rounds (sum(s^2) + sum(w^2) >= 2^24).

Tolerances: each block's values and each frame's shares and mv_mag are
exact (integers, or one float32 operation on the same integers in both).
The frame sums intra_error and coded_error are float32 sums of B
non-negative terms in the port, exact in the reference: their limit is
the benchmark's, 2 * ceil(log2 B) * 2^-24 relative (torch sums as a tree
of about ceil(log2 B) levels, each rounding by at most 2^-24; the two-pass
driver's sums_rtol); the same sums taken in float16 or bfloat16 fall
outside it."""

import ast
import json
import os

import numpy as np
import pytest
import torch

from aom_av1_lavish_torch.encoder import firstpass as FT
from aom_av1_lavish_torch.encoder.gop import GopEncoder, encode_twopass_ivf
from aom_av1_lavish_torch.encoder.ratectrl import (MODE_VBR,
                                                   RateControlConfig)
from aom_av1_lavish_torch.ops.inter import PADR, _edge_pad
from benchmark import harness
from benchmark.clips import Clip, Video
from benchmark import plain_twopass as P

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = "benchmark/plain_twopass.py"
SEED = 3100000007
N = 10
SIZES = ((96, 64), (128, 96))
CLIPS = ("plain", "cut", "bright")
SUMMED = ("intra_error", "coded_error")
EXACT = ("frame", "pcnt_inter", "pcnt_motion", "mv_mag")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tests run in several worker processes on a few cores; torch's
    OpenMP pool as wide as the machine in each stalls them, so this file
    computes on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _video():
    with open(os.path.join(ROOT, "benchmark", "traffic",
                           "vod_gop120.json")) as f:
        return Video.from_mix(json.load(f))


def clip(kind: str, w: int, h: int, n: int = N):
    """The benchmark's clip of seed SEED; "cut": from frame 6 on the clip
    of another seed (a new scene); "bright": its luma mapped into
    192..255."""
    frames = Clip(SEED, n, w, h, _video(), device="cpu").frames()
    if kind == "cut":
        other = Clip(SEED + 1, n, w, h, _video(), device="cpu").frames()
        frames = frames[:6] + other[6:]
    if kind == "bright":
        frames = [(np.ascontiguousarray(192 + (f[0] >> 2)), f[1], f[2])
                  for f in frames]
    return frames


@pytest.fixture(scope="module")
def passes():
    """(frames, port stats, reference stats) of each clip and size."""
    out = {}
    for w, h in SIZES:
        for kind in CLIPS:
            frames = clip(kind, w, h)
            out[kind, w, h] = (frames, FT.first_pass(frames, device="cpu"),
                               P.first_pass(frames, rows_at_once=2))
    return out


def _rtol(w, h):
    return harness.load_plugin("drivers", "gop_twopass").sums_rtol(
        (w // 16) * (h // 16))


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("kind", CLIPS)
def test_block_values_equal_the_reference(passes, kind, size):
    frames = passes[(kind,) + size][0]
    ys = [torch.as_tensor(f[0]) for f in frames]
    for i in range(1, len(ys)):
        want = P.block_values(ys[i], ys[i - 1], rows_at_once=3)
        got = FT.fp_blocks(ys[i], _edge_pad(ys[i - 1], PADR))
        assert sorted(got) == sorted(want)
        for k in want:
            assert torch.equal(got[k].to(torch.float64),
                               want[k].to(torch.float64)), (i, k)


def test_the_bright_clip_reaches_the_rounding():
    """The bright clip's SSDs go through float32's rounding: sum(s^2) +
    sum(w^2) reaches 2^24 on some block."""
    y = torch.as_tensor(clip("bright", 96, 64)[1][0]).to(torch.int64)
    blk = y.reshape(4, 16, 6, 16).permute(0, 2, 1, 3).reshape(-1, 256)
    assert int(2 * (blk * blk).sum(1).max()) >= 2 ** 24


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("kind", CLIPS)
@pytest.mark.parametrize("field", SUMMED + EXACT)
def test_frame_stats_equal_the_reference(passes, kind, size, field):
    _, port, ref = passes[(kind,) + size]
    assert len(port) == len(ref) == N
    got = np.array([float(getattr(s, field)) for s in port])
    want = np.array([float(getattr(s, field)) for s in ref])
    if field in EXACT:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=_rtol(*size), atol=0)


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_the_sums_limit_rejects_a_lower_precision(passes, dtype):
    """The reference's frame sums taken in float16 (scaled into its range)
    or bfloat16 depart from the exact sums by more than the limit on some
    frame of every clip."""
    for (kind, w, h), (frames, _, ref) in passes.items():
        ys = [torch.as_tensor(f[0]) for f in frames]
        worst = 0.0
        for i in range(1, len(ys)):
            v = P.block_values(ys[i], ys[i - 1], rows_at_once=4)
            scale = 2.0 ** -16 if dtype == torch.float16 else 1.0
            low = float((v["intra"].to(torch.float32) * scale).to(dtype)
                        .sum(dtype=dtype)) / scale
            exact = ref[i].intra_error
            worst = max(worst, abs(low - exact) / exact)
        assert worst > _rtol(w, h), (kind, w, h, worst)


@pytest.mark.parametrize("gf", [8, 4])
@pytest.mark.parametrize("kind", CLIPS)
def test_schedule_equals_the_reference(passes, kind, gf):
    """GopEncoder._build_schedule from the port's stats is the plain
    schedule of the reference's stats, at kf_max 120 and at a kf_max of
    7, which forces a KEY inside the clip."""
    _, port, ref = passes[kind, 96, 64]
    for kf in (120, 7):
        enc = GopEncoder(96, 64, device="cpu", twopass_stats=port,
                         gf_length=gf, kf_interval=kf)
        assert enc._build_schedule(N) == P.schedule(ref, N, kf, gf)


def test_the_cut_places_a_key_frame(passes):
    _, _, ref = passes["cut", 96, 64]
    assert P.key_frames(ref, 120) == [0, 6]
    assert P.schedule(ref, N, 120, 8)[:2] == [("key", 0), ("gf", 1, 5)]


def test_vbr_twopass_stream_has_the_plain_layout(passes, tmp_path):
    """A small VBR two-pass encode on the device path of the clip with the
    cut: its stream's KEYs, hidden ARFs, P frames and show_existing_frame,
    as the benchmark's two-pass driver reads them from the frame headers,
    are the plain schedule's."""
    frames, _, ref = passes["cut", 96, 64]
    path = str(tmp_path / "vbr.ivf")
    encode_twopass_ivf(path, frames, 96, 64, device="cpu",
                       rc_cfg=RateControlConfig(mode=MODE_VBR,
                                                target_bps=60_000, fps=30.0),
                       gf_length=8, kf_interval=120, use_tpu=True,
                       enable_cdef=False, cpu_used=8)
    want = P.layout(P.schedule(ref, N, 120, 8))
    assert want[:2] == ["key", "arf+inter"] and want.count("key") == 2
    assert harness.load_plugin("drivers", "gop_twopass").stream_layout(
        path) == want


def test_the_reference_imports_neither_package_nor_a_kernel():
    with open(os.path.join(ROOT, REFERENCE)) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0
            names.add(node.module.split(".")[0])
    assert names == {"__future__", "dataclasses", "torch"}
