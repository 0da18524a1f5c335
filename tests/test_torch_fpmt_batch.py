"""The frame axis of the port's P-frame program, on the CPU: the
frame-parallel GF group (FPMT) runs as one program over its frames, as the
JAX package vmaps _p_frame_core, and each frame's results equal those of
the same frame run alone.

The frame-axis forms of K1, K2 and K4 (their plain versions, which the CPU
runs) equal a stack of their single-frame forms; p_frame and the leaf-mask
deblock over a batch equal one call a frame, tensor for tensor; and
fpmt_encode_group calls each kernel wrapper as often for a group as a
single frame does.  Every comparison is exact.  This file imports no JAX
(the JAX package's FPMT is held against the port in
test_torch_sharding.py); run it alone with

    python -m pytest tests/test_torch_fpmt_batch.py -q
"""

import numpy as np
import pytest
import torch

from aom_av1_lavish_torch.ops import inter as IT
from aom_av1_lavish_torch.ops import kernels as K
from aom_av1_lavish_torch.ops import wavefront as WF
from aom_av1_lavish_torch.ops.deblock import deblock_leafmask
from aom_av1_lavish_torch.parallel import sharding as TS

W, H = 96, 64
#: per-frame q of the group (hp flips at 128) and its deblock levels (a
#: triple, an int, none, a triple), as in test_torch_sharding.py
GROUP_Q = [80, 96, 130, 110]
GROUP_LF = [(10, 4, 4), 12, 0, (20, 8, 6)]
N_FRAMES = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several worker processes share a few cores: torch's OpenMP pool, as
    wide as the machine in each, would stall at every barrier."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gop_frames(n=6):
    """test_torch_sharding.py's FPMT clip: a textured pan whose chroma
    planes are moving crops of the same texture."""
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:H + 32, 0:W + 32]
    base = (128 + 60 * np.sin(yy / 9.0) * np.cos(xx / 13.0)
            + rng.normal(0, 2, yy.shape)).clip(0, 255).astype(np.uint8)
    return [(np.ascontiguousarray(base[i:i + H, 2 * i:2 * i + W]),
             np.ascontiguousarray(base[:H // 2, i:i + W // 2]),
             np.ascontiguousarray(base[1:1 + H // 2, i:i + W // 2]))
            for i in range(n)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# the kernels' frame-axis forms


@pytest.mark.parametrize("dtype,bsz,radius,hi", [
    (np.uint8, 16, 16, 256), (np.int32, 8, 16, 1021), (np.uint8, 8, 5, 256),
    (np.int32, 16, 3, 1021)])
def test_ssd_surface_plane_frames_equal_single_frames(dtype, bsz, radius,
                                                      hi):
    """K2 from planes: (F, h, w) sources against one reference give the
    stack of each source's surfaces."""
    rng = np.random.default_rng(bsz + radius)
    nby, nbx, oy, ox = 3, 5, 1, 2
    Wn = 2 * radius + bsz
    src = _t(rng.integers(0, hi, (N_FRAMES, nby * bsz + 3, nbx * bsz + 1))
             .astype(dtype))
    ref = _t(rng.integers(0, hi, (oy + (nby - 1) * bsz + Wn,
                                  ox + (nbx - 1) * bsz + Wn)).astype(dtype))
    got = K.ssd_surface_plane(src, ref, nby, nbx, bsz, radius, oy, ox)
    S = 2 * radius + 1
    assert got.shape == (N_FRAMES, nby * nbx, S, S)
    want = torch.stack([K.ssd_surface_plane(s, ref, nby, nbx, bsz, radius,
                                            oy, ox) for s in src])
    assert torch.equal(got, want)


@pytest.mark.parametrize("bsz,n_cand", [(16, 9), (8, 5)])
def test_block_ssd_at_frames_equal_single_frames(bsz, n_cand):
    """K1's fused form: (F, h, w) sources with (F, B, C) origins, some off
    the reference, give the stack of each frame's sums."""
    rng = np.random.default_rng(bsz * n_cand)
    nby, nbx = 3, 4
    B = nby * nbx
    src = _t(rng.integers(0, 256, (N_FRAMES, nby * bsz, nbx * bsz + 2))
             .astype(np.uint8))
    ref = _t(rng.integers(0, 256, (70, 90)).astype(np.uint8))
    br = _t(rng.integers(-bsz - 4, 74, (N_FRAMES, B, n_cand))
            .astype(np.int32))
    bc = _t(rng.integers(-bsz - 4, 94, (N_FRAMES, B, n_cand))
            .astype(np.int32))
    got = K.block_ssd_at(src, ref, br, bc, nby, nbx, bsz)
    assert got.shape == (N_FRAMES, B, n_cand) and got.dtype == torch.int32
    want = torch.stack([K.block_ssd_at(src[f], ref, br[f], bc[f], nby, nbx,
                                       bsz) for f in range(N_FRAMES)])
    assert torch.equal(got, want)


@pytest.mark.parametrize("n,log_scale", [(256, 0), (64, 0), (1024, 1),
                                         (1024, 2)])
def test_quantize_b_vec_frame_rows_equal_single_frames(n, log_scale):
    """K4 with a parameter row a frame ((F, n), here with params that make
    the int32 products wrap) equals each frame's coefficients quantized
    with its own row."""
    rng = np.random.default_rng(n + log_scale)
    coeff = _t(rng.integers(-(1 << 20), 1 << 20, (N_FRAMES, 7, n))
               .astype(np.int32))
    par = [_t(rng.integers(a, b, (N_FRAMES, n)).astype(np.int32))
           for a, b in ((20, 1000), (10, 500), (1 << 12, 1 << 16),
                        (1 << 14, 1 << 16), (4, 7000))]
    q, dq = K.quantize_b_vec(coeff, *par, log_scale)
    for f in range(N_FRAMES):
        qf, dqf = K.quantize_b_vec(coeff[f], *(p[f] for p in par),
                                   log_scale)
        assert torch.equal(q[f], qf) and torch.equal(dq[f], dqf)


def test_quantize_takes_a_quantizer_per_frame():
    """ops/wavefront.quantize with pq (F, 5, 2) quantizes each frame's
    blocks at its own qindex."""
    from aom_av1_lavish_torch.common import quant as Q
    rng = np.random.default_rng(7)
    pq = _t(np.stack([WF.pq_array(Q.build_plane_quant(q, 0, 0))
                      for q in GROUP_Q[:N_FRAMES]]))
    coeff = _t(rng.integers(-3000, 3000, (N_FRAMES, 5, 256))
               .astype(np.int32))
    dc = torch.arange(256) == 0
    q, dq = WF.quantize(coeff, pq, 0, dc)
    for f in range(N_FRAMES):
        qf, dqf = WF.quantize(coeff[f], pq[f], 0, dc)
        assert torch.equal(q[f], qf) and torch.equal(dq[f], dqf)
    assert not torch.equal(q[0], q[2])


def test_frame_axis_wrappers_check_shapes():
    z = torch.zeros
    with pytest.raises(ValueError, match=r"int32 \(2, 6, C\)"):
        K.block_ssd_at(z((2, 32, 48), dtype=torch.uint8),
                       z((40, 60), dtype=torch.uint8),
                       z((6, 9), dtype=torch.int32),
                       z((6, 9), dtype=torch.int32), 2, 3, 16)
    with pytest.raises(ValueError, match=r"\(3, 4\) for a row a frame"):
        K.quantize_b_vec(z((3, 5, 4), dtype=torch.int32),
                         *(z((2, 4), dtype=torch.int32) for _ in range(5)),
                         0)
    with pytest.raises(ValueError, match="both uint8 or both int32"):
        K.ssd_surface_plane(z((2, 2, 16, 16), dtype=torch.uint8),
                            z((48, 48), dtype=torch.uint8), 1, 1, 16, 16, 0,
                            0)


# ---------------------------------------------------------------------------
# p_frame and the deblock over a batch


@pytest.fixture(scope="module")
def group():
    """The 4-frame group of test_torch_sharding.py on the CPU: sources,
    LAST and ARF references, quantizer state, and p_frame over the batch."""
    frames = _gop_frames()
    srcs, (last, arf), q = IT.upload_group(frames[1:5], [frames[0],
                                                         frames[5]],
                                           GROUP_Q, "cpu")
    refs = [IT.pad_ref(*last), IT.pad_ref(*arf)]
    ry, ru, rv, ry2 = (list(t) for t in zip(*refs))
    out = IT.p_frame(*srcs, ry, ru, rv, ry2, *q["pq"], q["lam"], q["hp"])
    return dict(srcs=srcs, refs=(ry, ru, rv, ry2), q=q, out=out)


def _one(group, f, **kw):
    q = group["q"]
    return IT.p_frame(*(p[f] for p in group["srcs"]), *group["refs"],
                      *(p[f] for p in q["pq"]), q["lam"][f], q["hp"][f],
                      **kw)


@pytest.mark.parametrize("f", range(len(GROUP_Q)))
def test_p_frame_batch_equals_single_frames(group, f):
    """Frame f of the batch equals frame f run alone: every tensor of the
    result, the filter pick among them."""
    got, want = group["out"], _one(group, f)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape[1:] == want[k].shape, k
        assert torch.equal(got[k][f], want[k]), k


def test_p_frame_batch_exercises_what_it_claims(group):
    """The group's frames differ in hp and quantizer, and merge leaves."""
    out = group["out"]
    assert group["q"]["hp"] == [1, 1, 0, 1]
    assert out["rec"].shape == (len(GROUP_Q), H + H // 2, W)
    assert out["lvl"].any()
    assert not torch.equal(out["r16"][0], out["r16"][2])


@pytest.mark.parametrize("merge", [False, True])
def test_p_frame_batch_without_interp_equals_single_frames(group, merge):
    """interp=False (the ShardedInterGopEncoder and the chain's other
    callers) and merge=False (the realtime step), each over the batch."""
    q = group["q"]
    got = IT.p_frame(*group["srcs"], *group["refs"], *q["pq"], q["lam"],
                     q["hp"], interp=False, merge=merge)
    for f in range(len(GROUP_Q)):
        want = _one(group, f, interp=False, merge=merge)
        for k in want:
            assert torch.equal(got[k][f], want[k]), (f, k)


def test_deblock_leafmask_batch_equals_single_frames(group):
    """Each frame at its own levels (level 0 unfiltered) and with its own
    leaf ids, as one call a frame."""
    out = group["out"]
    planes = IT.split_recon(out["rec"], H, W)
    leaf = IT._leaf_ids(out["lvl"])
    lfs = IT.deblock_levels(GROUP_LF, len(GROUP_LF), "cpu")
    got = deblock_leafmask(*planes, *lfs.unbind(1), leaf)
    for f, lv in enumerate(lfs.tolist()):
        want = deblock_leafmask(*(p[f] for p in planes), *lv, leaf[f])
        for g, w in zip(got, want):
            assert torch.equal(g[f], w)
    # the level-0 frame is left as it was; the others are filtered
    assert all(torch.equal(g[2], p[2]) for g, p in zip(got, planes))
    assert not torch.equal(got[0][0], planes[0][0])


def test_make_sharded_p_frame_fn_batch_equals_single_frames(group):
    """One call for the batch, one frame's quantizer shared by all."""
    q = group["q"]
    ry, ru, rv, ry2 = (torch.stack(r[:1]) for r in group["refs"])
    fn = TS.make_sharded_p_frame_fn(None, H, W, 1)
    got = fn(*group["srcs"], ry, ru, rv, ry2, *(p[0] for p in q["pq"]),
             q["lam"][0], q["hp"][0])
    for f in range(len(GROUP_Q)):
        want = IT.p_frame(*(p[f] for p in group["srcs"]),
                          *([r[0]] for r in group["refs"]),
                          *(p[0] for p in q["pq"]), q["lam"][0], q["hp"][0],
                          interp=False)
        for k in want:
            assert torch.equal(got[k][f], want[k]), (f, k)


# ---------------------------------------------------------------------------
# fpmt_encode_group: one call of each wrapper a group


@pytest.mark.parametrize("n", [1, 4])
def test_fpmt_group_calls_each_kernel_wrapper_as_one_frame_does(
        monkeypatch, n):
    """The K1, K2, K3 and K4 wrappers are called as often for a group of 4
    frames as for 1 (per reference two K2 surfaces and one K1 refine; K3
    90 times with 1/8-pel MVs; K4 once per plane and merge level), with
    the group's frames in each call."""
    calls = {}

    def spy(module, attr, key, arg=0):
        """Records the shape of each call's argument `arg`."""
        orig = getattr(module, attr)

        def wrapped(*a, **k):
            calls.setdefault(key, []).append(a[arg].shape)
            return orig(*a, **k)
        monkeypatch.setattr(module, attr, wrapped)

    spy(IT, "ssd_surface_plane", "K2")
    spy(IT, "block_ssd_at", "K1")
    spy(IT, "convolve_8tap_plane", "K3", 1)       # the blocks' origins
    spy(WF, "quantize_b_vec", "K4")
    frames = _gop_frames()
    TS.fpmt_encode_group(None, frames[1:1 + n], GROUP_Q[:n], frames[0],
                         frames[5], lf_levels=GROUP_LF[:n], device="cpu")
    assert {k: len(v) for k, v in calls.items()} == \
        {"K2": 4, "K1": 2, "K3": 90, "K4": 9}
    # K1 and K2 take the (n, h, w) source stack, K4 n frames' rows
    assert all(s[0] == n for k in ("K1", "K2", "K4") for s in calls[k])
    B = (H // 16) * (W // 16)
    assert calls["K3"][0] == (n * B,)


def test_fpmt_group_results_equal_single_frame_groups():
    """The group's host results equal those of each frame run as a group
    of one (raws, filter picks and deblocked recons)."""
    frames = _gop_frames()
    raws, recs = TS.fpmt_encode_group(None, frames[1:5], GROUP_Q, frames[0],
                                      frames[5], lf_levels=GROUP_LF,
                                      device="cpu")
    assert len(raws) == len(recs) == len(GROUP_Q)
    for f in range(len(GROUP_Q)):
        (raw,), (rec,) = TS.fpmt_encode_group(
            None, frames[1 + f:2 + f], GROUP_Q[f:f + 1], frames[0],
            frames[5], lf_levels=GROUP_LF[f:f + 1], device="cpu")
        assert raws[f]["filt"] == raw["filt"]
        for k in ("r16", "r32", "r64", "lvl"):
            np.testing.assert_array_equal(raws[f][k], raw[k])
        for a, b in zip(recs[f], rec):
            np.testing.assert_array_equal(a, b)
