"""The device-RDO KEY: the port's ops/rdo_intra, TpuRdoAllIntraEncoder and
the default-configuration GOP at a size where the KEY takes the device RDO,
against the JAX package's on the same numpy inputs (clips of 96x64 or
less).

Tolerances: mode_matrix and the predictions are integers and must be equal;
trial costs are float32 sse + lam * bits whose bits are a float32 sum taken
in another order than XLA's, so they agree to rtol 1e-6 (measured: at most
3.2e-7 relative on these inputs, no argmin over the modes changed); the IVF
files must be equal byte for byte."""

import os

import numpy as np
import pytest
import torch

from aom_av1_lavish_tpu.common import intra as I
from aom_av1_lavish_tpu.encoder.gop import encode_gop_ivf as ref_gop_ivf
from aom_av1_lavish_tpu.encoder.tpu_rdo import \
    encode_tpu_rdo_ivf as ref_rdo_ivf
from aom_av1_lavish_tpu.ops import rdo_intra as RJ
from aom_av1_lavish_torch.bitstream import constants as c
from aom_av1_lavish_torch.decoder.decoder import decode_frame_obus
from aom_av1_lavish_torch.encoder.encoder import make_sequence_header
from aom_av1_lavish_torch.encoder.gop import GopEncoder, encode_gop_ivf
from aom_av1_lavish_torch.encoder.lossy import make_lossy_frame_header
from aom_av1_lavish_torch.encoder.tpu_rdo import (TpuRdoAllIntraEncoder,
                                                  encode_tpu_rdo_ivf)
from aom_av1_lavish_torch.ops import rdo_intra as RT

W, H = 96, 64
SIZES = [(4, 4), (8, 8), (16, 16), (32, 32), (64, 64), (16, 8), (8, 16),
         (32, 16), (16, 32), (64, 32), (32, 64)]
KW_GOP = dict(qindex=120, gf_length=8, use_tpu=True, enable_cdef=False)


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


def _plane(h=64, w=128, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    return (128 + 70 * np.sin(yy / 9.0) * np.cos(xx / 13.0)
            + rng.normal(0, 6, yy.shape)).clip(0, 255).astype(np.uint8)


def _frames(w, h, n=1, seed=0):
    """Blocky luma with noise (the JAX package's own device-RDO test
    clip)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        base = rng.integers(0, 255, (h // 16 + 1, w // 16 + 1))
        y = np.kron(base, np.ones((16, 16)))[:h, :w]
        y = (y + rng.integers(-8, 9, (h, w))).clip(0, 255).astype(np.uint8)
        u = rng.integers(90, 170, ((h + 1) // 2, (w + 1) // 2)) \
            .astype(np.uint8)
        v = rng.integers(90, 170, ((h + 1) // 2, (w + 1) // 2)) \
            .astype(np.uint8)
        out.append((y, u, v))
    return out


def _pan(n=8, w=W, h=H):
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


def _lam_of(y, x, bh, bw):
    return 30.0 + 0.1 * (y + x)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One reference run of each kind per module: the trial sweep of every
    geometry, the chroma DC sweep, and the two encodes."""
    d = tmp_path_factory.mktemp("rdo")
    src = _plane()
    ej = RJ.IntraTrialEngine(60)
    et = RT.IntraTrialEngine(60, device="cpu")
    out = {"full": (ej.trial_plane(src, SIZES, _lam_of),
                    et.trial_plane(src, SIZES, _lam_of))}
    csz = [s for s in SIZES if s[0] <= 32 and s[1] <= 32]
    out["dc"] = (ej.trial_plane(src[:32, :64], csz, _lam_of, dc_only=True),
                 et.trial_plane(src[:32, :64], csz, _lam_of, dc_only=True))
    frames = _frames(W, H, n=2)
    a, b = str(d / "rdo_ref.ivf"), str(d / "rdo_port.ivf")
    ref_rdo_ivf(a, frames, W, H, qindex=80)
    encode_tpu_rdo_ivf(b, frames, W, H, qindex=80, device="cpu")
    out["rdo_ivf"] = (_read(a), _read(b))
    a, b = str(d / "gop_ref.ivf"), str(d / "gop_port.ivf")
    ref_gop_ivf(a, _pan(), W, H, **KW_GOP)
    encode_gop_ivf(b, _pan(), W, H, device="cpu", **KW_GOP)
    out["gop_ivf"] = (_read(a), _read(b))
    return out


def test_trial_mode_lists_equal_the_reference():
    assert RT.trial_mode_list() == RJ.trial_mode_list()
    assert RT.trial_modes_full() == RJ.trial_modes_full()
    assert len(RT.trial_modes_full()) == 61
    assert (RT.DEN, RT.MAX_ANGLE_DELTA, RT.DIR_MODES) == (
        RJ.DEN, RJ.MAX_ANGLE_DELTA, RJ.DIR_MODES)


@pytest.mark.parametrize("bw,bh", [(4, 4), (8, 8), (16, 16), (16, 8),
                                   (8, 16), (32, 16), (16, 32), (32, 32)])
def test_mode_matrix_equals_the_reference(bw, bh):
    got, want = RT.mode_matrix(bw, bh), RJ.mode_matrix(bw, bh)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_edge_helpers_equal_the_reference():
    src = _plane(32, 64, seed=2)
    for bw, bh in ((8, 8), (16, 8), (4, 4)):
        nbr, nbc = 32 // bh, 64 // bw
        reach = bw + bh + 1
        sp = np.pad(np.pad(src, ((1, 0), (1, 0)), mode="edge"),
                    ((0, reach), (0, reach)), mode="edge")
        E = RT._gather_edges(sp, bw, bh, nbr, nbc)
        np.testing.assert_array_equal(E, RJ._gather_edges(sp, bw, bh, nbr,
                                                          nbc))
        ys = np.repeat(np.arange(nbr) * bh, nbc)
        xs = np.tile(np.arange(nbc) * bw, nbr)
        np.testing.assert_array_equal(
            RT._fill_edges_np(E, bw, bh, ys > 0, xs > 0),
            RJ._fill_edges_np(E, bw, bh, ys > 0, xs > 0))


@pytest.mark.parametrize("bw,bh", [(8, 8), (16, 16), (16, 8), (32, 16),
                                   (4, 4)])
def test_predictions_equal_the_host_predictors(bw, bh):
    """predict_trial_modes over random edges: every linear mode equals the
    host's normative, filter-free predictor, DC equals the reference's
    _dc_jnp under every availability, PAETH equals the host's."""
    rng = np.random.default_rng(bw * 100 + bh)
    reach = bw + bh + 1
    n = 6
    E = rng.integers(0, 256, (n, 2 * reach + 1)).astype(np.int32)
    top = np.array([1, 1, 0, 0, 1, 1], bool)
    left = np.array([1, 0, 1, 0, 1, 1], bool)
    geom = RT._geometry(torch.device("cpu"), bw, bh)
    preds = RT.predict_trial_modes(torch.as_tensor(E), torch.as_tensor(top),
                                   torch.as_tensor(left), geom).numpy()
    assert preds.shape == (n, 61, bh * bw) and preds.dtype == np.int32
    want_dc = np.asarray(RJ._dc_jnp(E, bw, bh, top, left))
    np.testing.assert_array_equal(preds[:, 0], np.broadcast_to(
        want_dc[:, None], (n, bh * bw)))
    modes = RT.trial_modes_full()
    for i in range(n):
        tl = int(E[i, 0])
        above, lf = E[i, 1:1 + reach], E[i, 1 + reach:]
        for mi, (m, d) in enumerate(modes):
            if m == c.DC_PRED:
                continue
            if m == c.PAETH_PRED:
                ref = I._paeth(bw, bh, above, lf, tl, np.int32)
            elif m == c.SMOOTH_PRED:
                ref = I._smooth(bw, bh, above, lf, np.int32)
            elif m == c.SMOOTH_V_PRED:
                ref = I._smooth_v(bw, bh, above, lf, np.int32)
            elif m == c.SMOOTH_H_PRED:
                ref = I._smooth_h(bw, bh, above, lf, np.int32)
            else:
                ang = I.MODE_TO_ANGLE[m] + d * I.ANGLE_STEP
                if ang == 90:
                    ref = np.broadcast_to(above[:bw], (bh, bw))
                elif ang == 180:
                    ref = np.broadcast_to(lf[:bh, None], (bh, bw))
                elif ang < 90:
                    ref = I._dr_z1(bw, bh, above, 0, I.get_dx(ang), np.int32)
                elif ang > 180:
                    ref = I._dr_z3(bw, bh, lf, 0, I.get_dy(ang), np.int32)
                else:
                    ad = np.concatenate([[lf[0], tl], above])
                    ld = np.concatenate([[above[0], tl], lf])
                    ref = I._dr_z2(bw, bh, ad, ld, 2, 0, 0, I.get_dx(ang),
                                   I.get_dy(ang), np.int32)
            np.testing.assert_array_equal(preds[i, mi].reshape(bh, bw), ref,
                                          err_msg=f"{(bw, bh, m, d)}")


@pytest.mark.parametrize("bw,bh", SIZES)
def test_trial_plane_costs_match_the_reference(runs, bw, bh):
    """IntraTrialEngine.trial_plane per geometry: 61 costs per block to
    rtol 1e-6, and the same best mode for every block."""
    want, got = (r[(bw, bh)] for r in runs["full"])
    assert got.shape == want.shape == (64 // bh, 128 // bw, 61)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_array_equal(got.argmin(-1), want.argmin(-1))


@pytest.mark.parametrize("tx,n", [(c.TX_4X4, 16), (c.TX_16X16, 256),
                                  (c.TX_32X32, 1024)])
def test_cost_differences_lie_in_the_bits_sum(tx, n):
    """Where a trial cost differs from the reference's, it is the float32
    sum of the level bits (another order than XLA's): the bit estimates
    agree to rtol 1e-6 with equal eobs, and from equal bits sse + lam *
    bits comes out equal in both frameworks (no multiply-add contraction
    on either side)."""
    import jax.numpy as jnp

    from aom_av1_lavish_torch.bitstream import tables
    from aom_av1_lavish_torch.ops.wavefront import est_bits
    rng = np.random.default_rng(n)
    scan = np.asarray(tables.scan(tx, c.DCT_DCT), np.int32)
    q = (rng.integers(-40, 41, (4000, n))
         * (rng.random((4000, n)) < 0.15)).astype(np.int32)
    bj, ej = RJ._est_bits_jnp(jnp.asarray(q), scan)
    bt, et = est_bits(torch.as_tensor(q),
                      torch.as_tensor(scan.astype(np.int64)))
    np.testing.assert_array_equal(et.numpy(), np.asarray(ej))
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=1e-6)
    lam = np.float32(37.3)
    sse = rng.integers(0, 100000, 4000).astype(np.float32)
    cj = np.asarray(jnp.asarray(sse) + lam * jnp.asarray(bt.numpy()))
    ct = (torch.as_tensor(sse) + float(lam) * bt).numpy()
    np.testing.assert_array_equal(ct, cj)


def test_trial_plane_dc_only_costs_match_the_reference(runs):
    want, got = runs["dc"]
    assert got.keys() == want.keys() and len(got) == 8
    for k in want:
        assert got[k].shape == want[k].shape and got[k].shape[-1] == 1
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6)


def test_trial_plane_chunks_agree(monkeypatch):
    """Chunked dispatch (the last chunk shorter than the others, none
    padded) gives the costs of one dispatch."""
    src = _plane(32, 64, seed=5)
    eng = RT.IntraTrialEngine(60, device="cpu")
    whole = eng.trial_plane(src, [(4, 4), (8, 8)], _lam_of)
    monkeypatch.setattr(RT.IntraTrialEngine, "CHUNK", 3)   # 48 and 32 blocks
    parts = eng.trial_plane(src, [(4, 4), (8, 8)], _lam_of)
    for k in whole:
        np.testing.assert_array_equal(parts[k], whole[k])


def test_rdo_ivf_bytes_equal_the_reference(runs):
    ref_bytes, port_bytes = runs["rdo_ivf"]
    assert len(port_bytes) > 200
    assert port_bytes == ref_bytes


def test_default_gop_ivf_bytes_equal_the_reference(runs):
    """The repo's default configuration (cpu_used unset: device-RDO KEY,
    TPL and the temporal filter on) at 96x64."""
    ref_bytes, port_bytes = runs["gop_ivf"]
    assert len(port_bytes) > 200
    assert port_bytes == ref_bytes


def test_default_gop_takes_the_device_rdo_key_and_decodes(monkeypatch):
    """GopEncoder with cpu_used unset at 96x64 builds the device-RDO KEY
    encoder, and the port's decoder reproduces every recon slot."""
    built = []
    orig = TpuRdoAllIntraEncoder._run_device_rdo

    def spy(self):
        built.append(self.device)
        return orig(self)

    monkeypatch.setattr(TpuRdoAllIntraEncoder, "_run_device_rdo", spy)
    enc = GopEncoder(W, H, device="cpu", **KW_GOP)
    payloads = enc.encode_sequence(_pan())
    assert built == [torch.device("cpu")]
    sh, state, shown = None, {"slots": [None] * 8}, []
    for p in payloads:
        fr, sh = decode_frame_obus(p, sh, state)
        shown.extend(fr)
    assert len(shown) == 8
    compared = 0
    for slot in range(8):
        if enc.slots[slot] is None:
            continue
        for pe, pd in zip(enc.slots[slot], state["slots"][slot]["planes"]):
            np.testing.assert_array_equal(pe, pd)
            compared += 1
    assert compared


def test_rdo_encoder_recon_matches_the_decoder():
    (frame,) = _frames(80, 48, seed=4)
    sh = make_sequence_header(80, 48)
    enc = TpuRdoAllIntraEncoder(sh, make_lossy_frame_header(sh, 100),
                                device="cpu")
    payload = enc.encode_frame(frame)
    shown, _ = decode_frame_obus(payload, None, {"slots": [None] * 8})
    for pe, pd in zip(enc.recon, shown[0][:3]):
        pd = np.asarray(pd)
        np.testing.assert_array_equal(pe[:pd.shape[0], :pd.shape[1]], pd)


@pytest.mark.parametrize("name", ["IntraTrialEngine",
                                  "TpuRdoAllIntraEncoder",
                                  "encode_tpu_rdo_ivf"])
def test_entry_points_default_to_the_card_and_raise_without_one(
        monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sh = make_sequence_header(64, 64)
    make = {
        "IntraTrialEngine": lambda **d: RT.IntraTrialEngine(60, **d),
        "TpuRdoAllIntraEncoder": lambda **d: TpuRdoAllIntraEncoder(
            sh, make_lossy_frame_header(sh, 100), **d),
        "encode_tpu_rdo_ivf": lambda **d: encode_tpu_rdo_ivf(
            os.devnull, _frames(64, 64), 64, 64, **d),
    }[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()
    obj = make(device="cpu")
    if obj is not None:
        assert obj.device == torch.device("cpu")
