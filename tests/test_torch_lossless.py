"""Lossless: the port's ops/lossless and the lossless encoder entries
against the JAX package's on the same numpy inputs (planes of 96x64 or
less).  Everything here is integer (adds and shifts): WHT coefficients,
qcoeff and zero flags must be equal, the IVF files equal byte for byte,
and the port's decoder must return the source planes."""

import os

import numpy as np
import pytest
import torch

from aom_av1_lavish_tpu.encoder import encode_lossless_ivf as ref_lossless_ivf
from aom_av1_lavish_tpu.ops import lossless as LJ
from aom_av1_lavish_torch.common.txfm import fwht4x4
from aom_av1_lavish_torch.decoder import decode_ivf
from aom_av1_lavish_torch.decoder.decoder import decode_frame_obus
from aom_av1_lavish_torch.encoder import (LosslessEncoder,
                                          encode_lossless_ivf,
                                          make_lossless_frame_header,
                                          make_sequence_header)
from aom_av1_lavish_torch.ops import lossless as LT

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
        y = (128 + 90 * np.sin((yy + 3 * i) / 7.0) * np.cos(xx / 11.0)
             + rng.normal(0, 12, yy.shape)).clip(0, 255).astype(np.uint8)
        u = rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8)
        v = rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8)
        out.append((y, u, v))
    return out


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def ivfs(tmp_path_factory):
    d = tmp_path_factory.mktemp("lossless")
    frames = _frames()
    a, b = str(d / "ref.ivf"), str(d / "port.ivf")
    ref_lossless_ivf(a, frames, W, H)
    encode_lossless_ivf(b, frames, W, H, device="cpu")
    return frames, a, b


@pytest.mark.parametrize("seed", range(3))
def test_wht_equals_the_reference_and_the_scalar_transform(seed):
    rng = np.random.default_rng(seed)
    resid = rng.integers(-255, 256, (5, 7, 4, 4)).astype(np.int32)
    got = LT.fwht4x4_batched(torch.as_tensor(resid)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(LJ.fwht4x4_batched(resid)))
    for i in range(5):
        np.testing.assert_array_equal(got[i, 0], fwht4x4(resid[i, 0]))


@pytest.mark.parametrize("shape", [(64, 96), (32, 48), (4, 4), (8, 52)])
def test_plane_analyze_equals_the_reference(shape):
    rng = np.random.default_rng(shape[0])
    src = rng.integers(0, 256, shape).astype(np.uint8)
    q, z = LT.lossless_plane_analyze(torch.as_tensor(src))
    qr, zr = LJ.lossless_plane_analyze(src)
    assert q.dtype == torch.int32 and z.dtype == torch.bool
    np.testing.assert_array_equal(q.numpy(), np.asarray(qr))
    np.testing.assert_array_equal(z.numpy(), np.asarray(zr))


def test_plane_analyze_flags_flat_blocks_zero():
    src = np.full((16, 16), 77, np.uint8)
    src[4:8, 4:8] = 3
    q, z = LT.lossless_plane_analyze(torch.as_tensor(src))
    qr, zr = LJ.lossless_plane_analyze(src)
    np.testing.assert_array_equal(z.numpy(), np.asarray(zr))
    assert not z.numpy().all() and z.numpy().any()


def test_analyze_for_encoder_equals_the_reference():
    planes = _frames(1)[0]
    got = LT.analyze_for_encoder(planes, device="cpu")
    want = LJ.analyze_for_encoder(planes)
    assert len(got) == 3
    for (q, z), (qr, zr) in zip(got, want):
        assert q.dtype == qr.dtype and z.dtype == zr.dtype
        np.testing.assert_array_equal(q, qr)
        np.testing.assert_array_equal(z, zr)


def test_analyze_frames_for_encoder_equals_the_reference():
    frames = _frames()
    got = LT.analyze_frames_for_encoder(frames, device="cpu")
    want = LJ.analyze_frames_for_encoder(frames)
    assert len(got) == N
    for fg, fw in zip(got, want):
        for (q, z), (qr, zr) in zip(fg, fw):
            assert z is None and zr is None
            assert q.dtype == np.int16 and np.asarray(qr).dtype == np.int16
            np.testing.assert_array_equal(q, np.asarray(qr))


def test_analyze_tiled_for_encoder_equals_the_reference():
    planes = _frames(1, 128, 64)[0]
    rows, cols = [(0, 64)], [(0, 64), (64, 128)]
    got = LT.analyze_tiled_for_encoder(planes, rows, cols, device="cpu")
    want = LJ.analyze_tiled_for_encoder(planes, rows, cols)
    for (q, z), (qr, zr) in zip(got, want):
        assert z is None and zr is None and q.dtype == qr.dtype
        np.testing.assert_array_equal(q, qr)
    # availability resets at the tile edge: the second tile's first column
    # differs from the single-tile analyze
    whole = LT.analyze_for_encoder(planes, device="cpu")[0][0]
    assert not np.array_equal(got[0][0][:, 16], whole[:, 16])
    np.testing.assert_array_equal(got[0][0][:, :16], whole[:, :16])


def test_lossless_ivf_bytes_equal_the_reference(ivfs):
    _, a, b = ivfs
    assert len(_read(b)) > 1000
    assert _read(b) == _read(a)


def test_decoder_returns_the_source_planes(ivfs):
    frames, _, b = ivfs
    dec = decode_ivf(b)
    assert len(dec) == N
    for f, d in zip(frames, dec):
        for ps, pd in zip(f, d[:3]):
            np.testing.assert_array_equal(np.asarray(pd), ps)


@pytest.mark.parametrize("tiles", [(0, 0), (1, 0)])
def test_single_frame_encoder_analyzes_on_the_device(tiles):
    """LosslessEncoder.encode_frame with its batched analyze on (the
    default), single tile and two tile columns: the stream decodes to the
    source."""
    w = 128
    (frame,) = _frames(1, w, 64, seed=1)
    sh = make_sequence_header(w, 64)
    enc = LosslessEncoder(sh, make_lossless_frame_header(sh, *tiles))
    enc.device = "cpu"
    payload = enc.encode_frame(frame)
    assert enc.analysis is not None
    shown, _ = decode_frame_obus(payload, None, {"slots": [None] * 8})
    for ps, pd in zip(frame, shown[0][:3]):
        np.testing.assert_array_equal(np.asarray(pd), ps)


@pytest.mark.parametrize("name", ["analyze_for_encoder",
                                  "analyze_frames_for_encoder",
                                  "analyze_tiled_for_encoder",
                                  "encode_lossless_ivf", "LosslessEncoder"])
def test_entry_points_default_to_the_card_and_raise_without_one(
        monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    frames = _frames(1, 64, 64)
    sh = make_sequence_header(64, 64)
    call = {
        "analyze_for_encoder": lambda: LT.analyze_for_encoder(frames[0]),
        "analyze_frames_for_encoder":
            lambda: LT.analyze_frames_for_encoder(frames),
        "analyze_tiled_for_encoder": lambda: LT.analyze_tiled_for_encoder(
            frames[0], [(0, 64)], [(0, 64)]),
        "encode_lossless_ivf": lambda: encode_lossless_ivf(
            os.devnull, frames, 64, 64),
        "LosslessEncoder": lambda: LosslessEncoder(
            sh, make_lossless_frame_header(sh)).encode_frame(frames[0]),
    }[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
