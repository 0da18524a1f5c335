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
    (dict(cpu_used=None), NotImplementedError, "item 8"),
    (dict(cpu_used=None, enable_tpl=False, enable_tf=True),
     NotImplementedError, "item 8"),
    (dict(cpu_used=8, frame_parallel=True), NotImplementedError, "item 16"),
    (dict(cpu_used=8, use_tpu=False), ValueError, "use_tpu"),
])
def test_unported_configurations_raise(kw, exc, what):
    args = dict(KW, **kw)
    with pytest.raises(exc, match=what):
        TorchGopEncoder(W, H, device="cpu", **args)


def test_short_gf_group_raises():
    """A 10-frame clip leaves a 1-frame group after the 8-frame one; the
    reference codes it as a single P frame outside the chain."""
    enc = TorchGopEncoder(W, H, device="cpu", **KW)
    with pytest.raises(NotImplementedError, match="item 5"):
        enc.encode_sequence(_clip(n=10))


def test_device_rdo_key_raises():
    """At <= 720x576 without a cpu_used above 6 the reference codes the
    KEY with the device RDO, which is not ported yet."""
    enc = TorchGopEncoder(W, H, device="cpu",
                          **dict(KW, cpu_used=None, enable_tpl=False,
                                 enable_tf=False))
    with pytest.raises(NotImplementedError, match="item 11"):
        enc.encode_sequence(_clip(n=1))
