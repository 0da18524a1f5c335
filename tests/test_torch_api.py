"""The port's public API (aom_av1_lavish_torch/api.py) against the JAX
package's on the CPU: every flush route of Encoder writes the same payload
bytes from the same EncoderConfig keywords (the port's with
device="cpu"), both Decoders return the same frames from them, and the
configuration and control surface (validate, set_option, control,
get_control) behaves alike.  The JAX encodes run once per module (their
XLA compiles are the file's time)."""

import numpy as np
import pytest
import torch

from aom_av1_lavish_tpu import api as JA
from aom_av1_lavish_torch import api as TA

W, H, N = 96, 64, 4
#: flush route -> EncoderConfig keywords (the same for both packages)
ROUTES = {
    "lossless": dict(lossless=True),
    "lossless_tiles": dict(lossless=True, tile_cols_log2=1),
    "realtime": dict(usage=TA.USAGE_REALTIME, qindex=90),
    "svc": dict(temporal_layers=2, qindex=90),
    "superres": dict(enable_superres=True, superres_denom=12, qindex=90),
    "allintra": dict(usage=TA.USAGE_ALL_INTRA, qindex=100),
    "gop_host": dict(qindex=80, gf_length=4),
    # the device GOP at cpu_used 8 (wavefront KEY, no TPL or filter): the
    # cheapest JAX compile of the device route; tests/test_torch_sharding.py
    # holds the default configuration's frame-parallel GOP
    "gop_tpu": dict(qindex=80, gf_length=4, use_tpu=True,
                    enable_cdef=False, cpu_used=8),
    "gop_fpmt": dict(qindex=80, gf_length=4, use_tpu=True,
                     enable_cdef=False, cpu_used=8, fp_mt=True),
}
#: frames each route encodes (the host routes are slow in Python)
FRAMES = {"lossless": 2, "lossless_tiles": 2, "realtime": 3, "svc": 3,
          "superres": 2, "allintra": 2}


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


def _clip(n=N):
    """The moving clip of tests/test_controls.py: smooth gradients,
    texture and a hard edge, flat chroma."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:H + 64, 0:W + 64]
    base = (128 + 60 * np.sin(yy / 17.0) * np.cos(xx / 23.0)
            + 40 * (xx % 97 < 40)).astype(np.float64)
    base += rng.normal(0, 3, base.shape)
    base = base.clip(0, 255).astype(np.uint8)
    return [(np.ascontiguousarray(base[i:i + H, 2 * i:2 * i + W]),
             np.full((H // 2, W // 2), 110, np.uint8),
             np.full((H // 2, W // 2), 124, np.uint8))
            for i in range(n)]


def _encode(A, route, **dev):
    enc = A.Encoder(A.EncoderConfig(width=W, height=H, **ROUTES[route],
                                    **dev))
    for f in _clip(FRAMES.get(route, N)):
        enc.encode(f)
    return enc.flush()


def _decode(A, payloads):
    dec = A.Decoder()
    out = []
    for p in payloads:
        out.extend(dec.decode(p))
    return out


@pytest.fixture(scope="module")
def ref():
    return {r: _encode(JA, r) for r in ROUTES}


@pytest.fixture(scope="module")
def port():
    return {r: _encode(TA, r, device="cpu") for r in ROUTES}


@pytest.mark.parametrize("route", list(ROUTES))
def test_route_payloads_match_jax(ref, port, route):
    assert len(port[route]) > 0
    assert [len(p) for p in port[route]] == [len(p) for p in ref[route]]
    assert port[route] == ref[route]


@pytest.mark.parametrize("route", list(ROUTES))
def test_decoder_output_matches_jax(ref, port, route):
    """Both Decoders show the same frames, plane for plane, from the
    route's payloads; lossless routes decode to the source."""
    got, want = _decode(TA, port[route]), _decode(JA, ref[route])
    assert len(got) == len(want) == FRAMES.get(route, N)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if a is None or b is None:
                assert a is b
            else:
                np.testing.assert_array_equal(a, b)
    if ROUTES[route].get("lossless"):
        for g, f in zip(got, _clip()):
            for a, b in zip(g, f):
                np.testing.assert_array_equal(a, b)


def test_fpmt_route_runs_the_frame_parallel_group(monkeypatch):
    """fp_mt with use_tpu builds a frame-parallel GopEncoder on the
    config's device; without use_tpu the flag is dropped, as in the JAX
    package."""
    from aom_av1_lavish_torch.encoder import gop

    built = []
    orig = gop.GopEncoder.__init__

    def spy(self, *a, **k):
        orig(self, *a, **k)
        built.append(self)
    monkeypatch.setattr(gop.GopEncoder, "__init__", spy)
    for use_tpu in (True, False):
        cfg = TA.EncoderConfig(width=64, height=64, use_tpu=use_tpu,
                               fp_mt=True, device="cpu")
        TA.Encoder(cfg).flush()
        assert built[-1].frame_parallel is use_tpu
        assert built[-1].device == torch.device("cpu")


def _outcome(fn, A, dev):
    """What fn(A, dev) returns, or the name of the exception it raises."""
    try:
        return ("ok", fn(A, dev))
    except Exception as e:   # the type is what the two packages share
        return ("raises", type(e).__name__)


def _set_options(A, dev):
    cfg = A.EncoderConfig(width=64, height=64, **dev)
    cfg.set_option("qindex", "90")
    cfg.set_option("enable_cdef", "false")
    cfg.set_option("enable-qm", "1")
    cfg.set_option("qm-min", "6")
    return cfg.qindex, cfg.enable_cdef, cfg.enable_qm, cfg.qm_min


def _set_bad_option(A, dev):
    A.EncoderConfig(width=64, height=64, **dev).set_option("nope", "1")


def _control(A, dev):
    enc = A.Encoder(A.EncoderConfig(width=64, height=64, **dev))
    enc.control("AOME_SET_QUANT_SHARPNESS", 3)
    enc.control("aq-mode", 1)
    return enc.cfg.quant_sharpness, enc.cfg.aq_mode


def _control_out_of_range(A, dev):
    A.Encoder(A.EncoderConfig(width=64, height=64, **dev)).control(
        "AV1E_SET_QM_MIN", 99)


def _get_controls(A, dev):
    enc = A.Encoder(A.EncoderConfig(width=128, height=96, qindex=120, **dev))
    return [enc.get_control(n) for n in A.Encoder._GET_CONTROLS]


def _validate(**kw):
    def fn(A, dev):
        cfg = A.EncoderConfig(**dict(dict(width=64, height=64), **kw), **dev)
        cfg.validate()
        return cfg.level
    return fn


def _qm_range(A, dev):
    cfg = A.EncoderConfig(width=64, height=64, **dev)
    cfg.qm_min, cfg.qm_max = 9, 5
    cfg.validate()


def _decoder_controls(A, dev):
    dec = A.Decoder()
    dec.control("AV1D_SET_OPERATING_POINT", 1)
    return dec.get_control("AOMD_GET_FRAME_CORRUPTED")


def _decoder_unknown_control(A, dev):
    A.Decoder().control("AV1D_SET_NOTHING", 1)


def _decoder_get_before_decode(A, dev):
    A.Decoder().get_control("AOMD_GET_BASE_Q_IDX")


SURFACE = {
    "set_option": _set_options,
    "set_option unknown key": _set_bad_option,
    "control": _control,
    "control out of range": _control_out_of_range,
    "get_control": _get_controls,
    "validate ok": _validate(),
    "validate width 0": _validate(width=0),
    "validate qindex 500": _validate(qindex=500),
    "validate CBR without a target": _validate(rc_mode=1, target_bps=0),
    "validate level too low": _validate(width=3840, height=2160, fps=60.0,
                                        level=0),
    "validate qm range": _qm_range,
    "decoder control": _decoder_controls,
    "decoder unknown control": _decoder_unknown_control,
    "decoder get before decode": _decoder_get_before_decode,
}


@pytest.mark.parametrize("what", list(SURFACE))
def test_config_and_control_surface_matches_jax(what):
    """The same calls on both packages return the same values or raise
    the same exception type (tests/test_api_cli.py and
    tests/test_controls.py hold the JAX package's to its reference)."""
    fn = SURFACE[what]
    got = _outcome(fn, TA, dict(device="cpu"))
    assert got == _outcome(fn, JA, {})
    if what.startswith(("validate ", "control out", "set_option unknown",
                        "decoder unknown", "decoder get")) \
            and what != "validate ok":
        assert got[0] == "raises"


def test_encoder_config_without_a_card_raises(monkeypatch):
    """device=None is the card: without one, validating the configuration
    (which building an Encoder does) raises, and nothing runs on the
    CPU; the other checks come first."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TA.EncoderConfig(width=96, height=64)
    assert cfg.device is None
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cfg.validate()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TA.Encoder(TA.EncoderConfig(width=96, height=64, lossless=True))
    with pytest.raises(ValueError):
        TA.EncoderConfig(width=0, height=64).validate()
    TA.EncoderConfig(width=96, height=64, device="cpu").validate()


def test_encoder_config_keeps_the_jax_fields():
    """The port's EncoderConfig has every field of the JAX package's, with
    the same defaults, and one more: device."""
    from dataclasses import fields
    jf = {f.name: f.default for f in fields(JA.EncoderConfig)}
    tf = {f.name: f.default for f in fields(TA.EncoderConfig)}
    assert set(tf) - set(jf) == {"device"} and tf["device"] is None
    assert all(tf[k] == v for k, v in jf.items()
               if not callable(v) and k in tf)
