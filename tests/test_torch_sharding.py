"""The port's parallel/sharding.py against the JAX package's, on the CPU:
the frame-parallel GF group (FPMT) inside the GopEncoder and alone, the
flat-GOP ShardedInterGopEncoder, the tiled ShardedLosslessEncoder and the
batched analyze.  The JAX side shards over tests/conftest.py's virtual CPU
devices; the port runs each mesh axis as a batch axis on one device, so
`mesh=None` and `make_mesh(4, 1)` must write the same bytes.  Every
comparison is exact except the float32 bit proxy (1e-6 relative).  The
JAX reference runs once per module (its XLA compiles are the file's
time)."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from jax.sharding import Mesh  # noqa: E402

from aom_av1_lavish_tpu.encoder.gop import GopEncoder as JGop  # noqa: E402
from aom_av1_lavish_tpu.parallel import sharding as JS  # noqa: E402
from aom_av1_lavish_torch.decoder.decoder import (  # noqa: E402
    decode_frame_obus)
from aom_av1_lavish_torch.encoder.gop import GopEncoder  # noqa: E402
from aom_av1_lavish_torch.parallel import sharding as TS  # noqa: E402

W, H = 96, 64
GOP_KW = dict(qindex=80, use_tpu=True, enable_cdef=False,
              frame_parallel=True)
#: the fixed group of fpmt_encode_group alone: per-frame q (hp flips at
#: 128) and deblock levels (a triple, an int, none, a triple)
GROUP_Q = [80, 96, 130, 110]
GROUP_LF = [(10, 4, 4), 12, 0, (20, 8, 6)]


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


def _gop_frames(n=6):
    """The FPMT clip of tests/test_sharding.py: a textured pan whose chroma
    planes are moving crops of the same texture."""
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:H + 32, 0:W + 32]
    base = (128 + 60 * np.sin(yy / 9.0) * np.cos(xx / 13.0)
            + rng.normal(0, 2, yy.shape)).clip(0, 255).astype(np.uint8)
    return [(np.ascontiguousarray(base[i:i + H, 2 * i:2 * i + W]),
             np.ascontiguousarray(base[:H // 2, i:i + W // 2]),
             np.ascontiguousarray(base[1:1 + H // 2, i:i + W // 2]))
            for i in range(n)]


def _inter_frames(w=64, h=48, n=5):
    """The flat-GOP clip of tests/test_sharding.py (flat chroma)."""
    rng = np.random.default_rng(8)
    yy, xx = np.mgrid[0:h + 16, 0:w + 16]
    base = (128 + 60 * np.sin(yy / 7.0) * np.cos(xx / 9.0)
            + rng.normal(0, 3, yy.shape)).clip(0, 255).astype(np.uint8)
    return [(np.ascontiguousarray(base[i:i + h, 2 * i:2 * i + w]),
             np.full((h // 2, w // 2), 120, np.uint8),
             np.full((h // 2, w // 2), 133, np.uint8))
            for i in range(n)]


def _noise_frames(n, w, h, seed):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (h, w), dtype=np.uint8),
             rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8),
             rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8))
            for _ in range(n)]


def _group_args(frames):
    """fpmt_encode_group's inputs: four P frames between a LAST and an
    ARF frame of the clip."""
    return frames[1:5], GROUP_Q, frames[0], frames[5]


@pytest.fixture(scope="module")
def ref():
    """Every JAX output of the file, on a 4-device 'frame' mesh (and the
    (2, 2) mesh for the lossless encoder)."""
    mesh = Mesh(np.array(jax.devices()[:4]), ("frame",))
    frames = _gop_frames()
    out = {}
    enc = JGop(W, H, gf_length=len(frames) - 1, mesh=mesh, **GOP_KW)
    out["gop"] = enc.encode_sequence(frames)
    out["group"] = JS.fpmt_encode_group(
        mesh, *_group_args(frames), lf_levels=GROUP_LF)
    out["inter"] = JS.ShardedInterGopEncoder(
        64, 48, mesh, qindex=80).encode_frames(_inter_frames())
    out["lossless"] = JS.ShardedLosslessEncoder(
        128, 64, JS.make_mesh(2, 2)).encode_frames(
        _noise_frames(4, 128, 64, 3))
    y = np.stack([f[0] for f in _noise_frames(4, 64, 32, 5)])
    out["analyze"] = [np.asarray(a) for a in JS.make_sharded_analyze(
        JS.make_mesh(2, 2))(y)]
    return out


@pytest.fixture(scope="module")
def port():
    """The port's GOP on both meshes and its group alone, on the CPU."""
    frames = _gop_frames()
    out = {}
    for name, mesh in (("none", None),
                       ("4x1", TS.make_mesh(4, 1, device="cpu"))):
        enc = GopEncoder(W, H, device="cpu", gf_length=len(frames) - 1,
                         mesh=mesh, **GOP_KW)
        out[name] = (enc, enc.encode_sequence(frames))
    out["group"] = TS.fpmt_encode_group(
        None, *_group_args(frames), lf_levels=GROUP_LF, device="cpu")
    out["group_4x1"] = TS.fpmt_encode_group(
        TS.make_mesh(4, 1, device="cpu"), *_group_args(frames),
        lf_levels=GROUP_LF)
    return out


@pytest.mark.parametrize("mesh", ["none", "4x1"])
def test_fpmt_gop_matches_jax(ref, port, mesh):
    """The frame-parallel GOP writes the JAX package's 4-device stream,
    TU for TU, whether the port runs it with mesh=None or on a mesh."""
    got = port[mesh][1]
    assert [len(p) for p in got] == [len(p) for p in ref["gop"]]
    assert got == ref["gop"]


def test_fpmt_gop_decodes_to_the_encoder_recon(port):
    """The port's decoder shows every frame, and each reference slot it
    keeps equals the encoder's recon."""
    enc, payloads = port["none"]
    sh, state, shown = None, {"slots": [None] * 8}, []
    for p in payloads:
        fr, sh = decode_frame_obus(p, sh, state)
        shown.extend(fr)
    assert len(shown) == len(_gop_frames())
    n = 0
    for slot in range(8):
        if enc.slots[slot] is not None:
            for pe, pd in zip(enc.slots[slot],
                              state["slots"][slot]["planes"]):
                np.testing.assert_array_equal(pe, pd)
                n += 1
    assert n > 0


@pytest.mark.parametrize("key", ["r16", "r32", "r64", "lvl", "filt"])
def test_fpmt_group_raws_match_jax(ref, port, key):
    """fpmt_encode_group alone (per-frame q and deblock levels): each
    frame's result rows, partition map and filter pick equal JAX's, with
    and without a mesh."""
    for got in (port["group"], port["group_4x1"]):
        assert len(got[0]) == len(ref["group"][0]) == len(GROUP_Q)
        for g, r in zip(got[0], ref["group"][0]):
            np.testing.assert_array_equal(np.asarray(g[key]),
                                          np.asarray(r[key]))


def test_fpmt_group_recons_match_jax(ref, port):
    """A deblocked recon for every frame of the group (none is chained),
    equal to JAX's plane for plane."""
    for got in (port["group"], port["group_4x1"]):
        for g, r in zip(got[1], ref["group"][1]):
            assert g is not None
            for a, b in zip(g, r):
                np.testing.assert_array_equal(a, np.asarray(b))


def test_fpmt_group_uses_both_references_and_merges(port):
    raws = port["group"][0]
    assert any((r["r16"][:, 2] == 1).any() for r in raws)
    assert any(r["lvl"].any() for r in raws)


@pytest.fixture(scope="module")
def inter_port():
    return TS.ShardedInterGopEncoder(
        64, 48, TS.make_mesh(4, 1, device="cpu"),
        qindex=80).encode_frames(_inter_frames())


@pytest.mark.parametrize("i", range(5))
def test_sharded_inter_gop_payloads_match_jax(ref, inter_port, i):
    """ShardedInterGopEncoder (a wavefront anchor, then 4 P frames over
    it alone): each TU equals JAX's."""
    assert len(inter_port) == len(ref["inter"]) == 5
    assert inter_port[i] == ref["inter"][i]


def test_sharded_inter_gop_decodes(inter_port):
    sh, state, shown = None, {"slots": [None] * 8}, []
    for p in inter_port:
        fr, sh = decode_frame_obus(p, sh, state)
        shown.extend(fr)
    assert len(shown) == 5


@pytest.fixture(scope="module")
def lossless_port():
    frames = _noise_frames(4, 128, 64, 3)
    enc = TS.ShardedLosslessEncoder(128, 64, TS.make_mesh(2, 2,
                                                          device="cpu"))
    return frames, enc.encode_frames(frames)


@pytest.mark.parametrize("i", range(4))
def test_sharded_lossless_matches_jax_and_decodes_to_the_source(
        ref, lossless_port, i):
    """Two frames a batch, two tile columns: each payload equals JAX's and
    decodes to its source exactly."""
    frames, payloads = lossless_port
    assert payloads[i] == ref["lossless"][i]
    sh, state = None, {"slots": [None] * 8}
    for p in payloads[:i + 1]:
        out, sh = decode_frame_obus(p, sh, state)
    for plane in range(3):
        np.testing.assert_array_equal(out[0][plane], frames[i][plane])


def test_sharded_lossless_equals_the_single_device_encoder(lossless_port):
    """The same bytes as LosslessEncoder with tile_cols_log2=1."""
    from aom_av1_lavish_torch.encoder.encoder import (
        LosslessEncoder, make_lossless_frame_header, make_sequence_header)
    frames, payloads = lossless_port
    sh = make_sequence_header(128, 64)
    for f, p in zip(frames, payloads):
        e = LosslessEncoder(sh, make_lossless_frame_header(
            sh, tile_cols_log2=1))
        e.device = torch.device("cpu")
        assert e.encode_frame(f) == p


@pytest.mark.parametrize("what", ["q", "zero", "bits_proxy"])
def test_batched_analyze_step_matches_jax(ref, what):
    y = np.stack([f[0] for f in _noise_frames(4, 64, 32, 5)])
    got = TS.make_sharded_analyze(TS.make_mesh(2, 2, device="cpu"))(y)
    i = ["q", "zero", "bits_proxy"].index(what)
    g, r = got[i].numpy(), ref["analyze"][i]
    if what == "bits_proxy":
        assert g.dtype == r.dtype == np.float32
        assert abs(float(g) - float(r)) <= 1e-6 * abs(float(r))
    else:
        assert g.shape == r.shape
        np.testing.assert_array_equal(g, r)


def test_make_mesh_is_a_batch_layout_on_one_device():
    mesh = TS.make_mesh(2, 3, device="cpu")
    assert mesh.devices.shape == (2, 3)
    assert mesh.axis_names == ("frame", "tile")
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    with pytest.raises(ValueError, match="not the mesh's"):
        TS.fpmt_encode_group(mesh, *_group_args(_gop_frames()),
                             device="meta")
