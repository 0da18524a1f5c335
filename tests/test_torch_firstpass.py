"""First pass and two-pass: the port's encoder/firstpass and
encode_twopass_ivf against the JAX package's on the same numpy clips of
96x64, pixels in 0..90 (where the reference's float32 SSD surface is exact;
the port's is an exact integer sum everywhere).

Tolerances: the stats are float32 sums over the frame's blocks, taken in
another order than XLA's: rtol 1e-5.  The shares (pcnt_inter, pcnt_motion)
are a count times the float32 reciprocal of the number of blocks in both
packages and must be equal.  The IVF files must be equal byte for byte."""

import os

import numpy as np
import pytest
import torch

from aom_av1_lavish_tpu.encoder import firstpass as FJ
from aom_av1_lavish_tpu.encoder.gop import encode_twopass_ivf as ref_twopass
from aom_av1_lavish_torch.decoder.decoder import decode_frame_obus
from aom_av1_lavish_torch.encoder import firstpass as FT
from aom_av1_lavish_torch.encoder.gop import GopEncoder, encode_twopass_ivf
from aom_av1_lavish_torch.encoder.ratectrl import (MODE_VBR,
                                                   RateControlConfig)
from aom_av1_lavish_torch.encoder.thirdpass import encode_threepass_ivf
from aom_av1_lavish_tpu.encoder.ratectrl import \
    RateControlConfig as RefRateControlConfig

W, H, N = 96, 64, 8
FIELDS = ("frame", "intra_error", "coded_error", "pcnt_inter",
          "pcnt_motion", "mv_mag", "count")
KW = dict(gf_length=8, use_tpu=True, enable_cdef=False, cpu_used=8)


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


def _clip(n=N, w=W, h=H, cut=None):
    """A textured pan with moving chroma, scaled into 0..90; from frame
    `cut` on another scene."""
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:h + n * 2, 0:w + n * 2]
    base = (128 + 70 * np.sin(yy / 9.0) * np.cos(xx / 13.0)
            + rng.normal(0, 4, yy.shape)).clip(0, 255)
    other = (128 + 90 * np.cos(yy / 4.0) * np.sin(xx / 5.0)
             + rng.normal(0, 9, yy.shape)).clip(0, 255)
    cb = rng.integers(100, 156, ((h + n * 2) // 2, (w + n * 2) // 2))

    def q(a):
        return np.ascontiguousarray((a * 90 // 255).astype(np.uint8))
    out = []
    for i in range(n):
        lum = other if cut is not None and i >= cut else base
        out.append((q(lum[i:i + h, 2 * i:2 * i + w].astype(np.int64)),
                    q(cb[i // 2:i // 2 + h // 2, i:i + w // 2]),
                    q(255 - cb[i // 2:i // 2 + h // 2, i:i + w // 2])))
    return out


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("firstpass")
    out = {}
    for name, cut in (("pan", None), ("cut", 5)):
        frames = _clip(cut=cut)
        out[name] = (FJ.first_pass(frames),
                     FT.first_pass(frames, device="cpu"))
    frames = _clip()
    a, b = str(d / "ref.ivf"), str(d / "port.ivf")
    ref_twopass(a, frames, W, H, qindex=120, **KW)
    encode_twopass_ivf(b, frames, W, H, qindex=120, device="cpu",
                       stats_path=str(d / "stats"), **KW)
    out["ivf_q"] = (_read(a), _read(b))
    a, b = str(d / "ref_vbr.ivf"), str(d / "port_vbr.ivf")
    rc = dict(mode=MODE_VBR, target_bps=60_000, fps=30.0)
    ref_twopass(a, frames, W, H, rc_cfg=RefRateControlConfig(**rc), **KW)
    encode_twopass_ivf(b, frames, W, H, device="cpu",
                       rc_cfg=RateControlConfig(**rc), **KW)
    out["ivf_vbr"] = (_read(a), _read(b))
    return out


@pytest.mark.parametrize("clip", ["pan", "cut"])
@pytest.mark.parametrize("field", FIELDS)
def test_first_pass_stats_match_the_reference(runs, clip, field):
    ref, port = runs[clip]
    assert len(port) == len(ref) == N
    got = np.array([getattr(s, field) for s in port])
    want = np.array([getattr(s, field) for s in ref])
    if field in ("frame", "count", "pcnt_inter", "pcnt_motion"):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5)


def test_first_pass_sees_the_motion_and_the_cut(runs):
    _, pan = runs["pan"]
    assert pan[0].pcnt_inter == 0.0 and pan[0].coded_error == \
        pan[0].intra_error
    assert all(s.pcnt_inter > 0.5 and s.mv_mag > 0 for s in pan[1:])
    _, cut = runs["cut"]
    assert cut[5].coded_error > 4 * cut[4].coded_error


def test_stats_round_trip_through_a_file(runs, tmp_path):
    _, port = runs["pan"]
    path = str(tmp_path / "fp")
    FT.save_stats(path, port)
    back = FT.load_stats(path)
    assert back == port
    ref_back = FJ.load_stats(path)
    assert [s.to_array().tolist() for s in ref_back] == \
        [s.to_array().tolist() for s in port]


@pytest.mark.parametrize("name", ["ivf_q", "ivf_vbr"])
def test_twopass_ivf_bytes_equal_the_reference(runs, name):
    ref_bytes, port_bytes = runs[name]
    assert len(port_bytes) > 200
    assert port_bytes == ref_bytes


def test_decoder_reproduces_the_twopass_recon():
    frames = _clip(cut=5)
    stats = FT.first_pass(frames, device="cpu")
    enc = GopEncoder(W, H, device="cpu", twopass_stats=stats, qindex=120,
                     **KW)
    payloads = enc.encode_sequence(frames)
    sh, state, shown = None, {"slots": [None] * 8}, []
    for p in payloads:
        if p:
            fr, sh = decode_frame_obus(p, sh, state)
            shown.extend(fr)
    assert len(shown) == N
    compared = 0
    for slot in range(8):
        if enc.slots[slot] is None:
            continue
        for pe, pd in zip(enc.slots[slot], state["slots"][slot]["planes"]):
            np.testing.assert_array_equal(pe, pd)
            compared += 1
    assert compared


def test_threepass_runs_on_the_cpu(tmp_path):
    path = str(tmp_path / "p3.ivf")
    encode_threepass_ivf(path, _clip(), W, H, device="cpu", qindex=120,
                         **KW)
    assert len(_read(path)) > 200


@pytest.mark.parametrize("name", ["first_pass", "encode_twopass_ivf"])
def test_entry_points_default_to_the_card_and_raise_without_one(
        monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    frames = _clip(2)
    call = {
        "first_pass": lambda: FT.first_pass(frames),
        "encode_twopass_ivf": lambda: encode_twopass_ivf(
            os.devnull, frames, W, H, **KW),
    }[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
