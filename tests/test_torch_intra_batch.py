"""The batched multi-frame all-intra entry: the port's
WavefrontEncoder.encode_frames_raw and encode_tpu_ivf against the JAX
package's on the same numpy frames (96x64 and 64x48).  The rows (modes,
eobs, coefficients) and the recon are integers and must be equal; float32
RD costs decide the mode, and no decision differs on these inputs (the
rows are equal); the IVF files must be equal byte for byte."""

import os

import numpy as np
import pytest
import torch

from aom_av1_lavish_tpu.encoder.tpu_intra import encode_tpu_ivf as ref_tpu_ivf
from aom_av1_lavish_tpu.ops.wavefront import WavefrontEncoder as RefWave
from aom_av1_lavish_torch.decoder import decode_ivf
from aom_av1_lavish_torch.encoder.tpu_intra import encode_tpu_ivf
from aom_av1_lavish_torch.ops import kernels as K
from aom_av1_lavish_torch.ops.wavefront import WavefrontEncoder

W, H, N = 96, 64, 3


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


def _frames(n=N, w=W, h=H, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for i in range(n):
        y = (128 + 80 * np.sin((yy + 5 * i) / 8.0) * np.cos((xx - 3 * i) / 12.0)
             + rng.normal(0, 5, yy.shape)).clip(0, 255).astype(np.uint8)
        u = (128 + 40 * np.sin(yy[::2, ::2] / 6.0 + i)).astype(np.uint8)
        v = rng.integers(100, 156, (h // 2, w // 2)).astype(np.uint8)
        out.append((y, u, v))
    return out


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("intra_batch")
    frames = _frames()
    out = {"frames": frames,
           "raw_ref": RefWave(100, 55.0).encode_frames_raw(frames)}
    K.reset_launches()
    out["raw_port"] = WavefrontEncoder(100, 55.0, device="cpu") \
        .encode_frames_raw(frames)
    a, b = str(d / "ref.ivf"), str(d / "port.ivf")
    ref_tpu_ivf(a, frames, W, H, qindex=100)
    encode_tpu_ivf(b, frames, W, H, qindex=100, device="cpu")
    out["ivf"] = (a, b)
    return out


@pytest.mark.parametrize("frame", range(N))
def test_batched_rows_equal_the_reference(runs, frame):
    _, want390, _ = runs["raw_ref"][frame]
    _, got390, _ = runs["raw_port"][frame]
    assert got390.shape == (H // 16 * (W // 16), 390)
    assert got390.dtype == np.int16
    np.testing.assert_array_equal(got390, want390)


@pytest.mark.parametrize("frame", range(N))
def test_batched_recon_equals_the_reference(runs, frame):
    for a, b in zip(runs["raw_port"][frame][2], runs["raw_ref"][frame][2]):
        assert a.dtype == np.uint8
        np.testing.assert_array_equal(a, np.asarray(b))


def test_batched_results_dicts_equal_the_reference(runs):
    for (got, _, _), (want, _, _) in zip(runs["raw_port"], runs["raw_ref"]):
        assert got.keys() == want.keys()
        for k in got:
            for f in ("y_mode", "eoby", "eobu", "eobv"):
                assert got[k][f] == want[k][f]
            for f in ("qy", "qu", "qv"):
                np.testing.assert_array_equal(got[k][f], want[k][f])


@pytest.mark.parametrize("frame", range(N))
def test_a_batch_equals_its_frames_coded_alone(runs, frame):
    """The batch axis changes nothing: frame i of the batch has the rows
    and recon of a one-frame encode of frame i."""
    enc = WavefrontEncoder(100, 55.0, device="cpu")
    _, r390, recon = enc.encode_frame_raw(runs["frames"][frame])
    np.testing.assert_array_equal(r390, runs["raw_port"][frame][1])
    for a, b in zip(recon, runs["raw_port"][frame][2]):
        np.testing.assert_array_equal(a, b)


def test_a_wave_quantizes_all_frames_in_one_call(monkeypatch):
    """One quantizer call per wave and plane whatever the batch: 3 planes
    x (4 + 6 - 1) waves for a 96x64 frame, each on N times a wave's blocks
    (7 luma modes a block)."""
    from aom_av1_lavish_torch.ops import wavefront as WF
    calls = []
    orig = WF.quantize_b_vec

    def spy(coeff, *a):
        calls.append(tuple(coeff.shape))
        return orig(coeff, *a)

    monkeypatch.setattr(WF, "quantize_b_vec", spy)
    WavefrontEncoder(100, 55.0, device="cpu").encode_frames_raw(_frames())
    assert len(calls) == 3 * 9
    assert calls[:3] == [(N * 7, 256), (N, 64), (N, 64)]
    assert max(c[0] for c in calls) == N * 7 * 4


def test_ivf_bytes_equal_the_reference(runs):
    a, b = runs["ivf"]
    assert len(_read(b)) > 200
    assert _read(b) == _read(a)


def test_decoder_reproduces_the_batched_recon(runs):
    """Each decoded frame equals the wavefront recon of that frame (the
    stream is coded at a size whose KEY filter is the host's)."""
    _, b = runs["ivf"]
    dec = decode_ivf(b)
    assert len(dec) == N
    for f, d in zip(runs["frames"], dec):
        mse = np.mean((np.asarray(d[0], np.float64) - f[0]) ** 2)
        assert 10 * np.log10(255.0 ** 2 / mse) > 30.0


def test_other_geometry_and_single_frame_batch(tmp_path):
    frames = _frames(2, 64, 48, seed=7)
    a, b = str(tmp_path / "ref.ivf"), str(tmp_path / "port.ivf")
    ref_tpu_ivf(a, frames[:1], 64, 48, qindex=60)
    encode_tpu_ivf(b, frames[:1], 64, 48, qindex=60, device="cpu")
    assert _read(b) == _read(a)


def test_entry_point_defaults_to_the_card_and_raises_without_one(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        encode_tpu_ivf(os.devnull, _frames(1), W, H)
