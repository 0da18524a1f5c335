"""The port's slice end to end: the inter-GOP encode (wavefront KEY +
hidden ARF + chained P frames) of aom_av1_lavish_torch against
GopEncoder(use_tpu=True) of the JAX package, on an 8-frame 96x64 clip
with pixels in 0..90 (where the reference's float32 SSD is exact).

The IVF bytes, the chain's raw result rows and its recon must be
identical; the repo's decoder must reproduce the port's recon; and the
port must run with JAX blocked from import.  The JAX reference is run
once per module (its XLA compile dominates the file's time)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from aom_av1_lavish_tpu.bitstream.ivf import write_ivf
from aom_av1_lavish_tpu.decoder import decode_ivf
from aom_av1_lavish_tpu.decoder.decoder import decode_frame_obus
from aom_av1_lavish_tpu.encoder.gop import GopEncoder
from aom_av1_lavish_tpu.ops import inter_tpu as IJ
from aom_av1_lavish_torch.encoder.gop import TorchGopEncoder, encode_gop_ivf
from aom_av1_lavish_torch.ops import inter as IT

W, H, N = 96, 64, 8
KW = dict(qindex=120, gf_length=8, use_tpu=True, enable_cdef=False,
          cpu_used=8)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def _clip(n=N, w=W, h=H, peak=90):
    """A textured pan with moving chroma, scaled into 0..peak."""
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:h + n * 2, 0:w + n * 2]
    base = (128 + 70 * np.sin(yy / 9.0) * np.cos(xx / 13.0)
            + rng.normal(0, 4, yy.shape)).clip(0, 255)
    cb = rng.integers(100, 156, ((h + n * 2) // 2, (w + n * 2) // 2))

    def q(a):
        return np.ascontiguousarray((a * peak // 255).astype(np.uint8))
    return [(q(base[i:i + h, 2 * i:2 * i + w].astype(np.int64)),
             q(cb[i // 2:i // 2 + h // 2, i:i + w // 2]),
             q(255 - cb[i // 2:i // 2 + h // 2, i:i + w // 2]))
            for i in range(n)]


def _encode_with_spy(monkeypatch, cls, enc_cls, **kw):
    """Encode the clip, capturing every chain call's raws and recons."""
    calls = []
    orig = cls.encode_chain

    def spy(self, *a, recon="last", **k):
        out = orig(self, *a, recon="all", **k)
        calls.append(out)
        return out

    monkeypatch.setattr(cls, "encode_chain", spy)
    enc = enc_cls(W, H, **KW, **kw)
    payloads = enc.encode_sequence(_clip())
    monkeypatch.undo()
    return enc, payloads, calls


@pytest.fixture(scope="module")
def runs():
    mp = pytest.MonkeyPatch()
    ref = _encode_with_spy(mp, IJ.DeviceChainEncoder, GopEncoder)
    port = _encode_with_spy(mp, IT.DeviceChainEncoder, TorchGopEncoder,
                            device="cpu")
    return ref, port


def test_ivf_bytes_match_reference(runs, tmp_path):
    (_, ref_payloads, _), _ = runs
    want = str(tmp_path / "ref.ivf")
    write_ivf(want, [(p, i) for i, p in enumerate(ref_payloads) if p],
              W, H, 30, 1)
    got = str(tmp_path / "port.ivf")
    encode_gop_ivf(got, _clip(), W, H, device="cpu", **KW)
    with open(got, "rb") as a, open(want, "rb") as b:
        assert a.read() == b.read()


def test_payloads_match_per_frame(runs):
    (_, ref_payloads, _), (_, port_payloads, _) = runs
    assert len(port_payloads) == N
    for i, (a, b) in enumerate(zip(port_payloads, ref_payloads)):
        assert a == b, f"TU {i} differs"


@pytest.mark.parametrize("key", ["r16", "r32", "r64", "lvl", "filt"])
def test_chain_raws_match_reference(runs, key):
    (_, _, ref_calls), (_, _, port_calls) = runs
    # one 1-frame chain for the hidden ARF, one 6-frame chain for the Ps
    assert [len(c[0]) for c in port_calls] == [1, N - 2]
    assert [len(c[0]) for c in ref_calls] == [1, N - 2]
    for (raws, _), (rraws, _) in zip(port_calls, ref_calls):
        for j, (a, b) in enumerate(zip(raws, rraws)):
            np.testing.assert_array_equal(np.asarray(a[key]),
                                          np.asarray(b[key]),
                                          err_msg=f"frame {j} {key}")


def test_chain_recons_match_reference(runs):
    (_, _, ref_calls), (_, _, port_calls) = runs
    for (_, recs), (_, rrecs) in zip(port_calls, ref_calls):
        for j, (a, b) in enumerate(zip(recs, rrecs)):
            for pi in range(3):
                np.testing.assert_array_equal(a[pi], np.asarray(b[pi]),
                                              err_msg=f"frame {j} plane {pi}")


def test_recon_slots_match_reference(runs):
    (ref_enc, _, _), (port_enc, _, _) = runs
    for slot in range(8):
        if ref_enc.slots[slot] is None:
            assert port_enc.slots[slot] is None
            continue
        for a, b in zip(port_enc.slots[slot], ref_enc.slots[slot]):
            np.testing.assert_array_equal(a, b)


def test_decoder_reproduces_port_recon(runs, tmp_path):
    """Every chained P recon, and every reference slot, equals what the
    repo's decoder reconstructs from the port's stream."""
    _, (port_enc, payloads, calls) = runs
    path = str(tmp_path / "port.ivf")
    write_ivf(path, [(p, i) for i, p in enumerate(payloads) if p], W, H,
              30, 1)
    dec = decode_ivf(path)
    assert len(dec) == N
    # display frames 1..6 are the chained P frames
    for j, rec in enumerate(calls[1][1]):
        for pi in range(3):
            np.testing.assert_array_equal(np.asarray(dec[1 + j][pi]),
                                          rec[pi], err_msg=f"P frame {j}")
    sh, state = None, {"slots": [None] * 8}
    for p in payloads:
        _, sh = decode_frame_obus(p, sh, state)
    for slot in range(8):
        if port_enc.slots[slot] is None:
            continue
        for pe, pd in zip(port_enc.slots[slot],
                          state["slots"][slot]["planes"]):
            np.testing.assert_array_equal(pe, pd)


def test_port_runs_with_jax_blocked(runs, tmp_path):
    """A fresh interpreter that can import neither jax nor the JAX
    package runs the port's encode to the end and writes the same
    stream."""
    _, (_, payloads, _) = runs
    out = str(tmp_path / "nojax.ivf")
    src = str(tmp_path / "clip.npz")
    np.savez(src, *[p for f in _clip() for p in f])
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "sys.modules['aom_av1_lavish_tpu'] = None\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "import numpy as np\n"
        "from aom_av1_lavish_torch.encoder.gop import encode_gop_ivf\n"
        f"z = np.load({src!r})\n"
        "p = [z[f'arr_{i}'] for i in range(len(z.files))]\n"
        "frames = [tuple(p[i:i + 3]) for i in range(0, len(p), 3)]\n"
        f"encode_gop_ivf({out!r}, frames, {W}, {H}, device='cpu', "
        f"**{KW!r})\n"
        "assert not any(m.split('.')[0] in ('jax', 'aom_av1_lavish_tpu')\n"
        "               for m, v in sys.modules.items() if v is not None)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = str(tmp_path / "want.ivf")
    write_ivf(want, [(p, i) for i, p in enumerate(payloads) if p], W, H,
              30, 1)
    with open(out, "rb") as a, open(want, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("kw,exc,what", [
    pytest.param(dict(cpu_used=8, width=88), ValueError, "multiples of 16",
                 id="kw2-ValueError-multiples of 16"),
    pytest.param(dict(cpu_used=None, height=56), ValueError,
                 "multiples of 16", id="kw3-ValueError-multiples of 16"),
])
def test_unported_configurations_raise(kw, exc, what):
    """The device path refuses frames whose sides are no multiples of 16
    (frame-parallel groups, which raised here, are ported: they construct
    in test_ported_configurations_construct)."""
    args = dict(KW, **kw)
    w, h = args.pop("width", W), args.pop("height", H)
    with pytest.raises(exc, match=what):
        TorchGopEncoder(w, h, device="cpu", **args)


@pytest.mark.parametrize("kw", [dict(cpu_used=None), dict(cpu_used=7),
                                dict(cpu_used=8, use_tpu=False),
                                dict(cpu_used=None, use_tpu=False,
                                     width=88, height=56),
                                dict(cpu_used=None, frame_parallel=True),
                                dict(cpu_used=8, frame_parallel=True)])
def test_ported_configurations_construct(kw):
    """TPL, the temporal filter and frame-parallel groups are ported: the
    default configuration (cpu_used unset, both on), the presets that turn
    them on, the host GOP path and FPMT are built, and keep what the
    arguments and presets say."""
    args = dict(KW, **kw)
    w, h = args.pop("width", W), args.pop("height", H)
    enc = TorchGopEncoder(w, h, device="cpu", **args)
    assert enc.enable_tf == (kw["cpu_used"] != 8)
    assert enc.enable_tpl == (kw["cpu_used"] is None)
    assert enc.frame_parallel == kw.get("frame_parallel", False)
    assert enc.device.type == "cpu"


def _decodes_to_the_recon(enc, payloads, n):
    sh, state, shown = None, {"slots": [None] * 8}, []
    for p in payloads:
        fr, sh = decode_frame_obus(p, sh, state)
        shown.extend(fr)
    assert len(shown) == n
    compared = 0
    for slot in range(8):
        if enc.slots[slot] is None:
            continue
        for pe, pd in zip(enc.slots[slot], state["slots"][slot]["planes"]):
            np.testing.assert_array_equal(pe, pd)
            compared += 1
    assert compared


def test_short_gf_group_raises():
    """A 10-frame clip leaves a 1-frame group after the 8-frame one; the
    reference codes it as a single P frame outside the chain.  The port
    raised here until DeviceInterEncoder was ported; now it codes it the
    same way (through TpuInterFrameEncoder's own device encode) and
    the decoder reproduces the recon."""
    calls = []
    orig = IT.DeviceInterEncoder.encode_frame_raw

    def spy(self, *a, **k):
        calls.append(self.device)
        return orig(self, *a, **k)

    mp = pytest.MonkeyPatch()
    mp.setattr(IT.DeviceInterEncoder, "encode_frame_raw", spy)
    try:
        enc = TorchGopEncoder(W, H, device="cpu", **KW)
        payloads = enc.encode_sequence(_clip(n=10))
    finally:
        mp.undo()
    assert len(calls) == 1 and calls[0].type == "cpu"
    assert len(payloads) == 10 and all(payloads)
    _decodes_to_the_recon(enc, payloads, 10)


def test_device_rdo_key_raises():
    """At <= 720x576 without a cpu_used above 6 the reference codes the
    KEY with the device RDO.  The port raised here until ops/rdo_intra was
    ported; now it builds TpuRdoAllIntraEncoder and the decoder reproduces
    the KEY's recon."""
    from aom_av1_lavish_torch.encoder.tpu_rdo import TpuRdoAllIntraEncoder
    built = []
    orig = TpuRdoAllIntraEncoder.encode_frame

    def spy(self, *a, **k):
        built.append(self.device)
        return orig(self, *a, **k)

    mp = pytest.MonkeyPatch()
    mp.setattr(TpuRdoAllIntraEncoder, "encode_frame", spy)
    try:
        enc = TorchGopEncoder(W, H, device="cpu",
                              **dict(KW, cpu_used=None, enable_tpl=False,
                                     enable_tf=False))
        payloads = enc.encode_sequence(_clip(n=1))
    finally:
        mp.undo()
    assert len(built) == 1 and built[0].type == "cpu"
    _decodes_to_the_recon(enc, payloads, 1)


# --- TPL and the ARF temporal filter through the GOP encoder --------------
#
# At 96x64 a configuration with cpu_used unset or <= 6 sends the KEY to the
# device-RDO intra path (frames up to 720x576; tests/test_torch_rdo.py holds
# that configuration against the reference), so with the wavefront KEY of
# the 1080p slice the two tools are reached like this:
#   tf       cpu_used=7: wavefront KEY, temporal filter on, TPL off;
#   tpl      cpu_used=8 (both off), then enable_tpl set on the encoder (the
#            constructor lets a preset override the argument);
#   both     cpu_used=8, then both set on the encoder;
#   default  cpu_used unset, as the 1080p slice is built (TPL and the filter
#            on, motion modes on in the sequence header), then the speed
#            features of cpu_used=7 attached, which on the device path are
#            read for one thing only: they send the KEY to the wavefront
#            path, where a 1080p KEY goes by its size.
#   default_full_range  the same on the clip at its full range (luma up to
#            255), where the reference's SSD surface rounds S2 + W2 past
#            2^24 (ROADMAP F1) in the full-pel search, TPL and the filter.
# Each is applied to both packages alike.


def _attach_cpu7(enc):
    speed = type(enc).__module__.rsplit(".", 1)[0] + ".speed"
    enc.sf = __import__(speed, fromlist=["x"]).speed_features_for(7)


def _set(**attrs):
    def post(enc):
        for k, v in attrs.items():
            setattr(enc, k, v)
    return post


TPL_TF = {
    "tf": (dict(cpu_used=7), _set()),
    "tpl": (dict(cpu_used=8), _set(enable_tpl=True)),
    "both": (dict(cpu_used=8), _set(enable_tpl=True, enable_tf=True)),
    "default": (dict(), _attach_cpu7),
    "default_full_range": (dict(), _attach_cpu7),
}
#: the clip's peak by configuration (else 90)
PEAK = {"default_full_range": 255}
BASE = {k: v for k, v in KW.items() if k != "cpu_used"}


def _encode_tools(mp, cls, enc_cls, mod, name, **kw):
    """Encode the clip in configuration `name`; returns the encoder, its
    payloads, every chain call's (raws, recons), and the filtered ARF
    sources and TPL results it saw."""
    cfg, post = TPL_TF[name]
    calls, seen = [], {"tf": [], "tpl": []}
    chain = cls.encode_chain

    def spy(self, *a, recon="last", **k):
        out = chain(self, *a, recon="all", **k)
        calls.append(out)
        return out

    def spy_on(module, fn, key):
        orig = getattr(module, fn)

        def wrapped(*a, **k):
            out = orig(*a, **k)
            seen[key].append(out)
            return out
        mp.setattr(module, fn, wrapped)

    mp.setattr(cls, "encode_chain", spy)
    spy_on(mod[0], "temporal_filter", "tf")
    spy_on(mod[1], "tpl_gf_group", "tpl")
    enc = enc_cls(W, H, **BASE, **cfg, **kw)
    post(enc)
    payloads = enc.encode_sequence(_clip(peak=PEAK.get(name, 90)))
    mp.undo()
    return enc, payloads, calls, seen


@pytest.fixture(scope="module")
def tool_runs():
    from aom_av1_lavish_tpu.encoder import temporal_filter as FJ
    from aom_av1_lavish_tpu.encoder import tpl as TJ
    from aom_av1_lavish_torch.encoder import temporal_filter as FT
    from aom_av1_lavish_torch.encoder import tpl as TT
    mp = pytest.MonkeyPatch()
    out = {}
    for name in TPL_TF:
        out[name] = (
            _encode_tools(mp, IJ.DeviceChainEncoder, GopEncoder, (FJ, TJ),
                          name),
            _encode_tools(mp, IT.DeviceChainEncoder, TorchGopEncoder,
                          (FT, TT), name, device="cpu"))
    return out


def _ivf(tmp_path, name, payloads):
    path = str(tmp_path / name)
    write_ivf(path, [(p, i) for i, p in enumerate(payloads) if p], W, H, 30,
              1)
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("name", list(TPL_TF))
def test_tpl_tf_ivf_bytes_match_reference(tool_runs, tmp_path, name):
    """With TPL, the temporal filter or both on, the port writes the JAX
    package's stream, TU for TU (the filter's blend came out exact on this
    clip, so the filtered ARF source and all that follows are equal)."""
    (ref_enc, ref_p, _, _), (enc, port_p, _, _) = tool_runs[name]
    assert (enc.enable_tpl, enc.enable_tf) \
        == (ref_enc.enable_tpl, ref_enc.enable_tf) \
        == (name != "tf", name != "tpl")
    assert enc.motion_modes == ref_enc.motion_modes \
        == name.startswith("default")
    assert len(port_p) == N
    for i, (a, b) in enumerate(zip(port_p, ref_p)):
        assert a == b, f"TU {i} differs"
    assert _ivf(tmp_path, "port.ivf", port_p) \
        == _ivf(tmp_path, "ref.ivf", ref_p)


@pytest.mark.parametrize("name", list(TPL_TF))
def test_tpl_tf_results_reach_the_chain_as_in_the_reference(tool_runs, name):
    """What the two tools hand the encoder, and what the chain makes of it:
    the filtered ARF source pixel for pixel, TPL's importances to 1e-6,
    and the raw rows and recons of both chains equal."""
    (_, _, ref_calls, ref_seen), (_, _, calls, seen) = tool_runs[name]
    assert len(seen["tf"]) == len(ref_seen["tf"]) == int(name != "tpl")
    for got, want in zip(seen["tf"], ref_seen["tf"]):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))
    assert len(seen["tpl"]) == len(ref_seen["tpl"]) == int(name != "tf")
    for (gi, gm), (wi, wm) in zip(seen["tpl"], ref_seen["tpl"]):
        np.testing.assert_allclose(gi, wi, rtol=1e-6)
        for g, w in zip(gm, wm):
            np.testing.assert_allclose(g, w, rtol=1e-6)
    assert [len(c[0]) for c in calls] == [1, N - 2]
    for (raws, recs), (rraws, rrecs) in zip(calls, ref_calls):
        for j, (a, b) in enumerate(zip(raws, rraws)):
            for key in ("r16", "r32", "r64", "lvl", "filt"):
                np.testing.assert_array_equal(
                    np.asarray(a[key]), np.asarray(b[key]),
                    err_msg=f"frame {j} {key}")
        for j, (a, b) in enumerate(zip(recs, rrecs)):
            for pi in range(3):
                np.testing.assert_array_equal(a[pi], np.asarray(b[pi]),
                                              err_msg=f"frame {j}")


def test_tpl_and_tf_change_the_stream(tool_runs):
    """The four configurations exercise what they claim: each tool moves
    the stream away from the plain cpu_used=8 one."""
    streams = {name: b"".join(r[1][1]) for name, r in tool_runs.items()}
    assert len({streams["tf"], streams["tpl"], streams["both"]}) == 3


@pytest.mark.parametrize("name", ["both", "default",
                                  "default_full_range"])
def test_decoder_reproduces_recon_with_tpl_and_tf(tool_runs, name):
    """The port's own decoder rebuilds every reference slot of the encoder
    from the stream written with TPL and the temporal filter on."""
    from aom_av1_lavish_torch.decoder.decoder import \
        decode_frame_obus as port_decode
    _, (enc, payloads, calls, _) = tool_runs[name]
    sh, state, shown = None, {"slots": [None] * 8}, []
    for p in payloads:
        fr, sh = port_decode(p, sh, state)
        shown.extend(fr)
    assert len(shown) == N
    for j, rec in enumerate(calls[1][1]):
        for pi in range(3):
            np.testing.assert_array_equal(np.asarray(shown[1 + j][pi]),
                                          rec[pi], err_msg=f"P frame {j}")
    n = 0
    for slot in range(8):
        if enc.slots[slot] is None:
            continue
        for pe, pd in zip(enc.slots[slot], state["slots"][slot]["planes"]):
            np.testing.assert_array_equal(pe, pd)
            n += 1
    assert n >= 6


@pytest.mark.parametrize("kw,w,h,n", [
    (dict(cpu_used=8), 96, 64, 10),       # a 1-frame group after the first
    (dict(), 96, 64, 8),                  # TPL maps and the filter on
    (dict(), 88, 56, 8),                  # no multiple of 16
])
def test_host_gop_path_matches_reference(kw, w, h, n):
    """use_tpu=False: the host RD encoders are the port's own copies, and
    TPL (whose rdmult maps they read) and the temporal filter run on the
    port's device; the payloads equal the JAX package's."""
    clip = [(y[:h, :w].copy(), u[:(h + 1) // 2, :(w + 1) // 2].copy(),
             v[:(h + 1) // 2, :(w + 1) // 2].copy()) for y, u, v in _clip(n=n)]
    args = dict(BASE, use_tpu=False, **kw)
    want = GopEncoder(w, h, **args).encode_sequence(clip)
    got = TorchGopEncoder(w, h, device="cpu", **args).encode_sequence(clip)
    assert len(got) == n and all(got)
    assert got == want
