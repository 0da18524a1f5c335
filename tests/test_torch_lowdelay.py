"""Single P frames outside a chain, low delay and realtime: the port's
DeviceInterEncoder, DeviceRtEncoder, encode_tpu_lowdelay_ivf,
encode_realtime_tpu_ivf and the GOP's short groups (gf_length=2,
use_arf=False) against the JAX package's, on 96x64 clips with pixels in
0..90 (where the reference's float32 SSD is exact).

Tolerances: the raw result rows, the partition maps and the recon are
integers and must be equal; the IVF files must be equal byte for byte; the
port's decoder must reproduce the encoder's recon.  The JAX reference runs
once per module (its XLA compiles dominate the file's time)."""

import os

import numpy as np
import pytest
import torch

from aom_av1_lavish_tpu.encoder.gop import encode_gop_ivf as ref_gop_ivf
from aom_av1_lavish_tpu.encoder.nonrd import \
    encode_realtime_tpu_ivf as ref_realtime_ivf
from aom_av1_lavish_tpu.encoder.tpu_inter import \
    encode_tpu_lowdelay_ivf as ref_lowdelay_ivf
from aom_av1_lavish_tpu.ops import inter_tpu as IJ
from aom_av1_lavish_torch.bitstream.ivf import read_ivf
from aom_av1_lavish_torch.decoder.decoder import decode_frame_obus
from aom_av1_lavish_torch.encoder.gop import GopEncoder, encode_gop_ivf
from aom_av1_lavish_torch.encoder.nonrd import encode_realtime_tpu_ivf
from aom_av1_lavish_torch.encoder.tpu_inter import (TpuLowDelayEncoder,
                                                    encode_tpu_lowdelay_ivf)
from aom_av1_lavish_torch.ops import inter as IT

W, H, N = 96, 64, 4
KW_GOP = dict(qindex=120, use_tpu=True, enable_cdef=False, cpu_used=8)
SHORT = {"gf2": dict(gf_length=2), "no_arf": dict(gf_length=4,
                                                  use_arf=False)}


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


def _clip(n=N, w=W, h=H):
    """A textured pan with moving chroma, scaled into 0..90."""
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:h + n * 2, 0:w + n * 2]
    base = (128 + 70 * np.sin(yy / 9.0) * np.cos(xx / 13.0)
            + rng.normal(0, 4, yy.shape)).clip(0, 255)
    cb = rng.integers(100, 156, ((h + n * 2) // 2, (w + n * 2) // 2))

    def q(a):
        return np.ascontiguousarray((a * 90 // 255).astype(np.uint8))
    return [(q(base[i:i + h, 2 * i:2 * i + w].astype(np.int64)),
             q(cb[i // 2:i // 2 + h // 2, i:i + w // 2]),
             q(255 - cb[i // 2:i // 2 + h // 2, i:i + w // 2]))
            for i in range(n)]


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _stream(enc_cls, qindex, frames):
    """The realtime encoder fed frames[1:] with frames[0] as its first
    reference: each frame's rows and recon."""
    kw = {} if enc_cls is IJ.DeviceRtEncoder else {"device": "cpu"}
    enc = enc_cls(qindex, **kw)
    enc.reset_ref(frames[0])
    out = []
    for f in frames[1:]:
        rows = enc.encode_frame(f)
        out.append((np.asarray(rows), [np.asarray(p) for p in
                                       enc.fetch_recon(H, W)]))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages over the same inputs: one reference encode of each
    kind per module."""
    d = tmp_path_factory.mktemp("lowdelay")
    frames = _clip()
    out = {"frames": frames}
    ref = IJ.DeviceInterEncoder(100)
    out["inter_ref"] = (ref.encode_frame_raw(frames[1], [frames[0]]),
                        ref.recon)
    port = IT.DeviceInterEncoder(100, device="cpu")
    out["inter_port"] = (port.encode_frame_raw(frames[1], [frames[0]]),
                         port.recon)
    out["rt_ref"] = _stream(IJ.DeviceRtEncoder, 90, frames)
    out["rt_port"] = _stream(IT.DeviceRtEncoder, 90, frames)
    for name, ref_fn, port_fn, kw in (
            ("lowdelay", ref_lowdelay_ivf, encode_tpu_lowdelay_ivf,
             dict(qindex=80)),
            ("realtime", ref_realtime_ivf, encode_realtime_tpu_ivf,
             dict(qindex=90)),
            ("gf2", ref_gop_ivf, encode_gop_ivf, dict(KW_GOP, **SHORT["gf2"])),
            ("no_arf", ref_gop_ivf, encode_gop_ivf,
             dict(KW_GOP, **SHORT["no_arf"]))):
        a, b = str(d / f"{name}_ref.ivf"), str(d / f"{name}_port.ivf")
        ref_fn(a, frames, W, H, **kw)
        port_fn(b, frames, W, H, device="cpu", **kw)
        out[name] = (_read(a), _read(b), b)
    return out


@pytest.mark.parametrize("key", ["r16", "r32", "r64", "lvl"])
def test_device_inter_encoder_rows_equal_the_reference(runs, key):
    (ref_raw, _), (port_raw, _) = runs["inter_ref"], runs["inter_port"]
    assert port_raw[key].dtype == np.asarray(ref_raw[key]).dtype
    np.testing.assert_array_equal(port_raw[key], np.asarray(ref_raw[key]))


def test_device_inter_encoder_recon_equals_the_reference(runs):
    (_, ref_rec), (_, port_rec) = runs["inter_ref"], runs["inter_port"]
    for a, b in zip(port_rec, ref_rec):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_device_inter_encoder_merges_and_dict_view(runs):
    """The frame carries merged leaves (the DP ran), and the per-block
    dict view of the rows equals the reference's."""
    port_raw, _ = runs["inter_port"]
    assert port_raw["lvl"].shape == (H // 16, W // 16)
    assert port_raw["r32"].shape == (6, 1542)
    assert port_raw["r64"].shape == (1, 3078)
    got = IT.pack_frame_results(port_raw["r16"], W)
    want = IJ.pack_frame_results(np.asarray(runs["inter_ref"][0]["r16"]), W)
    assert got.keys() == want.keys()
    for k in got:
        for f in ("mv", "ref_idx", "eoby", "eobu", "eobv"):
            assert got[k][f] == want[k][f]
        for f in ("qy", "qu", "qv"):
            np.testing.assert_array_equal(got[k][f], want[k][f])


@pytest.mark.parametrize("frame", range(N - 1))
def test_device_rt_encoder_rows_and_recon_equal_the_reference(runs, frame):
    """Each streamed frame: (B, 390) rows and the device-resident recon,
    which is the next frame's reference, so equality holds down the
    stream."""
    (ref_rows, ref_rec), (rows, rec) = (runs["rt_ref"][frame],
                                        runs["rt_port"][frame])
    assert rows.shape == (H // 16 * (W // 16), 390) and rows.dtype == np.int16
    np.testing.assert_array_equal(rows, ref_rows)
    for a, b in zip(rec, ref_rec):
        np.testing.assert_array_equal(a, b)


def test_p_frame_without_merge_keeps_the_16x16_rows(runs):
    """merge=False codes the same 16x16 leaves as merge=True (the DP only
    adds levels on top): the realtime step's rows equal the r16 rows of a
    DeviceInterEncoder at the same q on the same frame."""
    frames = runs["frames"]
    enc = IT.DeviceInterEncoder(90, device="cpu")
    raw = enc.encode_frame_raw(frames[1], [frames[0]])
    np.testing.assert_array_equal(raw["r16"], runs["rt_port"][0][0])


@pytest.mark.parametrize("name", ["lowdelay", "realtime", "gf2", "no_arf"])
def test_ivf_bytes_equal_the_reference(runs, name):
    ref_bytes, port_bytes, _ = runs[name]
    assert len(port_bytes) > 32 * N
    assert port_bytes == ref_bytes


def _decode(payloads):
    sh, state, shown = None, {"slots": [None] * 8}, []
    for p in payloads:
        fr, sh = decode_frame_obus(p, sh, state)
        shown.extend(fr)
    return shown, state


def test_decoder_reproduces_the_lowdelay_recon(runs):
    frames = runs["frames"]
    enc = TpuLowDelayEncoder(W, H, qindex=80, device="cpu")
    payloads = [enc.encode_frame(f) for f in frames]
    shown, state = _decode(payloads)
    assert len(shown) == N
    for pe, pd in zip(enc.slots[0], state["slots"][0]["planes"]):
        np.testing.assert_array_equal(pe, pd)


@pytest.mark.parametrize("name", ["gf2", "no_arf"])
def test_decoder_reproduces_the_short_group_recon(runs, name):
    enc = GopEncoder(W, H, device="cpu", **dict(KW_GOP, **SHORT[name]))
    payloads = enc.encode_sequence(runs["frames"])
    assert len(payloads) == N and all(payloads)
    shown, state = _decode(payloads)
    assert len(shown) == N
    compared = 0
    for slot in range(8):
        if enc.slots[slot] is None:
            continue
        for pe, pd in zip(enc.slots[slot], state["slots"][slot]["planes"]):
            np.testing.assert_array_equal(pe, pd)
            compared += 1
    assert compared


def test_decoder_reproduces_the_realtime_recon(runs):
    """The realtime stream's last decoded frame equals the recon that the
    device kept (the stream is coded without deblock, CDEF or LR)."""
    _, _, path = runs["realtime"]
    payloads = [p for p, _ in read_ivf(path)]
    shown, _ = _decode(payloads)
    assert len(shown) == N
    enc = IT.DeviceRtEncoder(90, device="cpu")
    enc.reset_ref([np.asarray(p) for p in shown[0][:3]])
    for f, dec in zip(runs["frames"][1:], shown[1:]):
        enc.encode_frame(f)
        for a, b in zip(enc.fetch_recon(H, W), dec[:3]):
            np.testing.assert_array_equal(a, np.asarray(b)[:a.shape[0],
                                                           :a.shape[1]])


@pytest.mark.parametrize("name", ["DeviceInterEncoder", "DeviceRtEncoder",
                                  "TpuLowDelayEncoder",
                                  "encode_tpu_lowdelay_ivf",
                                  "encode_realtime_tpu_ivf"])
def test_entry_points_default_to_the_card_and_raise_without_one(
        monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    frames = _clip(2)
    make = {
        "DeviceInterEncoder": lambda **d: IT.DeviceInterEncoder(100, **d),
        "DeviceRtEncoder": lambda **d: IT.DeviceRtEncoder(90, **d),
        "TpuLowDelayEncoder": lambda **d: TpuLowDelayEncoder(W, H, **d),
        "encode_tpu_lowdelay_ivf": lambda **d: encode_tpu_lowdelay_ivf(
            os.devnull, frames, W, H, **d),
        "encode_realtime_tpu_ivf": lambda **d: encode_realtime_tpu_ivf(
            os.devnull, frames, W, H, **d),
    }[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()
    obj = make(device="cpu")
    if obj is not None:
        assert obj.device == torch.device("cpu")
