"""The port's TPL pass and ARF temporal filter
(aom_av1_lavish_torch/encoder/tpl.py, temporal_filter.py, and
ops.inter.block_cost_volume under both) against the JAX package's, on
seeded numpy clips of at most 96x64 pushed through both.

Integer results (SSD surfaces, inter costs, motion vectors, aligned
pixels) must be equal.  Float32 results are held to 1e-6 relative: both
sides sum the same float32 terms, in an order of their own.  The filtered
planes are rounded float32 quotients, so they are held to 1 LSB and the
number of pixels that differ is asserted at what was measured: none.

Clips keep their pixels in 0..90, and one clip at full range is compared
too: there the JAX package's float32 SSD identity rounds S2 + W2 past
2^24 (ROADMAP F1), and the port's surface rounds as it does."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aom_av1_lavish_tpu.encoder import temporal_filter as FJ
from aom_av1_lavish_tpu.encoder import tpl as TJ
from aom_av1_lavish_tpu.ops import inter_tpu as IJ
from aom_av1_lavish_torch.encoder import temporal_filter as FT
from aom_av1_lavish_torch.encoder import tpl as TT
from aom_av1_lavish_torch.ops import inter as IT

RTOL = 1e-6


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


def _clip(n=7, w=96, h=64, peak=90, pan=2, seed=3, sub=2):
    """A textured clip panning `pan` pixels a frame (0: static content
    under fresh noise), pixels in 0..peak; chroma subsampled by `sub`."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h + 2 * n, 0:w + 2 * n * max(pan, 1)]
    base = 128 + 70 * np.sin(yy / 9.0) * np.cos(xx / 13.0)
    ch, cw = (h + sub - 1) // sub, (w + sub - 1) // sub
    cb = rng.integers(100, 156, (ch + n, cw + n * max(pan, 1)))

    def q(a):
        a = np.clip(a, 0, 255).astype(np.int64)
        return np.ascontiguousarray((a * peak // 255).astype(np.uint8))
    out = []
    for i in range(n):
        noise = rng.normal(0, 4, (h, w))
        x = i * pan
        out.append((q(base[i:i + h, x:x + w] + noise),
                    q(cb[i // 2:i // 2 + ch, x // sub:x // sub + cw]),
                    q(255 - cb[i // 2:i // 2 + ch, x // sub:x // sub + cw])))
    return out


def _oracle_cost_volume(cur, ref, block, radius):
    """Every tile against the edge-padded reference, rounded as the JAX
    package's surface rounds (ROADMAP F1): with S2, W2 and C summed in
    int64, R(S2 + W2) - 2C in float32 where all three lie below 2^24
    (always, for uint8 tiles of 16), else the exact SSD."""
    H, W = cur.shape
    Hb, Wb = H // block, W // block
    pad = np.pad(ref.astype(np.int64), radius, mode="edge")
    S = 2 * radius + 1
    out = np.empty((Hb * Wb, S, S), np.float32)
    for by in range(Hb):
        for bx in range(Wb):
            blk = cur[by * block:(by + 1) * block,
                      bx * block:(bx + 1) * block].astype(np.int64)
            s2 = int((blk * blk).sum())
            for dy in range(S):
                for dx in range(S):
                    win = pad[by * block + dy:by * block + dy + block,
                              bx * block + dx:bx * block + dx + block]
                    w2, c = int((win * win).sum()), int((blk * win).sum())
                    if max(s2, w2, c) < 1 << 24:
                        v = np.float32(s2 + w2) - np.float32(2 * c)
                    else:
                        v = np.float32(s2 + w2 - 2 * c)
                    out[by * Wb + bx, dy, dx] = v
    return out


@pytest.mark.parametrize("block,radius", [(16, 8), (8, 4)])
def test_block_cost_volume_matches_jax(block, radius):
    frames = _clip(n=3)
    cur, ref = frames[2][0], frames[0][0]
    got = IT.block_cost_volume(torch.from_numpy(cur), torch.from_numpy(ref),
                               block, radius)
    want = np.asarray(IJ.block_cost_volume(jnp.asarray(cur),
                                           jnp.asarray(ref), block, radius))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("block,radius", [(16, 8), (8, 4)])
def test_block_cost_volume_matches_jax_bright(block, radius):
    """Pixels 240..255, where S2 + W2 passes 2^24 and the reference rounds
    it (ROADMAP F1), at the shapes of test_block_cost_volume_matches_jax:
    equal bit for bit."""
    rng = np.random.default_rng(block)
    cur = rng.integers(240, 256, (64, 96)).astype(np.uint8)
    ref = rng.integers(240, 256, (64, 96)).astype(np.uint8)
    got = IT.block_cost_volume(torch.from_numpy(cur), torch.from_numpy(ref),
                               block, radius)
    want = np.asarray(IJ.block_cost_volume(jnp.asarray(cur),
                                           jnp.asarray(ref), block, radius))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("lo,hi", [(0, 256), (240, 256)])
def test_block_cost_volume_matches_int64_oracle_full_range(lo, hi):
    rng = np.random.default_rng(hi - lo)
    cur = rng.integers(lo, hi, (32, 48)).astype(np.uint8)
    ref = rng.integers(lo, hi, (32, 48)).astype(np.uint8)
    got = IT.block_cost_volume(torch.from_numpy(cur), torch.from_numpy(ref),
                               16, 8)
    np.testing.assert_array_equal(got.numpy(),
                                  _oracle_cost_volume(cur, ref, 16, 8))


@pytest.mark.parametrize("peak,w,h", [(90, 96, 64), (255, 96, 64),
                                      (90, 88, 56)])
def test_group_costs_match_jax(peak, w, h):
    """Motion vectors and inter costs equal, the float32 intra cost to
    1e-6; a plane that several pairs share is deduplicated by identity in
    both.  88x56 leaves a strip that no 16x16 block covers.  At full range
    the reference's float32 SSD identity rounds (ROADMAP F1; block (2, 2)
    of the first two pairs has 6258 and 8106 where the exact SSDs are 6259
    and 8105): the port's inter costs equal the reference's all the same,
    and both equal the oracle of that rounding."""
    luma = [f[0] for f in _clip(n=4, w=w, h=h, peak=peak)]
    pairs = [(luma[0], luma[3]), (luma[1], luma[0]), (luma[2], luma[3]),
             (luma[3], luma[3])]
    want = TJ._group_costs(pairs)
    got = TT._group_costs(pairs, device="cpu")
    assert len(got) == len(want) == 4
    for (cur, ref), (gi, ge, gm), (wi, we, wm) in zip(pairs, got, want):
        assert gi.dtype == ge.dtype == np.float64
        assert gm.shape == (h // 16, w // 16, 2)
        np.testing.assert_array_equal(gm, np.asarray(wm))
        hc, wc = (h // 16) * 16, (w // 16) * 16
        oracle = _oracle_cost_volume(cur[:hc, :wc], ref[:hc, :wc], 16, 8)
        np.testing.assert_array_equal(ge.reshape(-1),
                                      oracle.reshape(len(oracle), -1).min(1))
        np.testing.assert_array_equal(ge, np.asarray(we))
        np.testing.assert_allclose(gi, wi, rtol=RTOL)
    # a frame against itself costs nothing at the zero vector
    assert not got[3][1].any() and not got[3][2].any()
    one = TT._frame_costs(luma[0], luma[3], device="cpu")
    for a, b in zip(one, got[0]):
        np.testing.assert_array_equal(a, b)


def test_group_costs_take_device_tensors():
    luma = [f[0] for f in _clip(n=3)]
    dev = [torch.from_numpy(p) for p in luma]
    a = TT._group_costs([(luma[0], luma[2]), (luma[1], luma[2])], "cpu")
    b = TT._group_costs([(dev[0], dev[2]), (dev[1], dev[2])], "cpu")
    for x, y in zip(a, b):
        for p, q in zip(x, y):
            np.testing.assert_array_equal(p, q)
    assert TT._group_costs([], "cpu") == []


@pytest.mark.parametrize("peak,pan", [(90, 2), (90, 0), (255, 2)])
def test_tpl_gf_group_matches_jax(peak, pan):
    group = _clip(n=7, peak=peak, pan=pan)
    imp_w, maps_w = TJ.tpl_gf_group(group, 6)
    imp_g, maps_g = TT.tpl_gf_group(group, 6, device="cpu")
    np.testing.assert_allclose(imp_g, imp_w, rtol=RTOL)
    assert len(maps_g) == len(maps_w) == 7
    for g, w in zip(maps_g, maps_w):
        assert g.shape == (4, 6)
        np.testing.assert_allclose(g, w, rtol=RTOL)
    # the q offsets the GOP encoder derives from them
    for q in (40, 120, 200):
        assert [TT.tpl_q_offset(i, q) for i in imp_g] \
            == [TJ.tpl_q_offset(i, q) for i in imp_w]
    assert max(imp_g) > 1.0


def test_tpl_host_helpers_match_jax_package():
    rng = np.random.default_rng(5)
    intra = rng.uniform(0, 5000, (4, 6))
    inter = rng.uniform(0, 5000, (4, 6))
    mv = rng.integers(-8, 9, (4, 6, 2))
    dep_cur = rng.uniform(0, 900, (4, 6))
    a, b = np.zeros((4, 6)), np.zeros((4, 6))
    TT._propagate(a, intra, inter, mv, dep_cur)
    TJ._propagate(b, intra, inter, mv, dep_cur)
    np.testing.assert_array_equal(a, b)
    assert a.any()
    for imp in (0.5, 1.0, 1.3, 2.0, 9.0, 1e6):
        assert TT.tpl_q_offset(imp, 100) == TJ.tpl_q_offset(imp, 100)
    for q in (0, 60, 120, 255):
        assert FT.tf_sigma2(q) == FJ.tf_sigma2(q)


def test_align_matches_jax():
    """K1's gather of RADIUS-padded planes against the reference's
    clipped index gather, luma blocks of 16 and chroma blocks of 8, with
    vectors up to the search radius in every direction."""
    rng = np.random.default_rng(9)
    for blk, (H, W) in ((16, (64, 96)), (8, (32, 48))):
        Hb, Wb = H // blk, W // blk
        planes = rng.integers(0, 256, (2, H, W)).astype(np.uint8)
        mvs = rng.integers(-FT.RADIUS, FT.RADIUS + 1, (2, Hb, Wb, 2)) \
            .astype(np.int32)
        want = np.asarray(FJ._align(jnp, jax,
                                    jnp.asarray(planes, jnp.float32),
                                    jnp.asarray(mvs), blk))
        got = FT._align([torch.from_numpy(p) for p in planes],
                        torch.from_numpy(mvs.reshape(2, Hb * Wb, 2)), blk)
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), want.astype(np.uint8))


def test_blend_matches_jax():
    """The float32 blend on random planes: weights and quotient to 1e-6,
    and the rounded pixels all equal."""
    rng = np.random.default_rng(11)
    center = rng.integers(0, 256, (32, 48)).astype(np.float32)
    aligned = np.clip(center[None] + rng.normal(0, 6, (3, 32, 48)), 0,
                      255).round().astype(np.float32)
    for s2 in (1.0, 30.25, 400.0):
        want = np.asarray(FJ._blend_fn((32, 48))(center, aligned,
                                                 np.float32(s2)))
        got = FT._blend(torch.from_numpy(center), torch.from_numpy(aligned),
                        np.float32(s2)).numpy()
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=RTOL)
        assert int((np.round(got) != np.round(want)).sum()) == 0


def _tf_mvs_jax(frames, center_idx, neigh):
    """The reference's luma MVs (its jitted search, cropped as it crops)."""
    y = frames[center_idx][0]
    Hc, Wc = (y.shape[0] // 16) * 16, (y.shape[1] // 16) * 16
    nb = np.stack([frames[i][0][:Hc, :Wc] for i in neigh]).astype(np.float32)
    mvs, _ = FJ._tf_fn((Hc, Wc, len(neigh)))(y[:Hc, :Wc].astype(np.float32),
                                             nb)
    return np.asarray(mvs)


@pytest.mark.parametrize("peak,pan,w,h,sub,center", [
    (90, 2, 96, 64, 2, 6),      # moving content, the GOP's case
    (90, 0, 96, 64, 2, 6),      # static content under noise
    (90, 2, 88, 56, 2, 3),      # no multiple of 16; neighbours on both sides
    (90, 2, 96, 64, 1, 6),      # 4:4:4: the generic per-plane branch
    (90, 2, 88, 56, 1, 6),      # generic branch, no multiple of 16
    (255, 2, 96, 64, 2, 6),     # full range
])
def test_temporal_filter_matches_jax(peak, pan, w, h, sub, center):
    frames = _clip(n=7, w=w, h=h, peak=peak, pan=pan, sub=sub)
    lo, hi = max(0, center - 2), min(7, center + 3)
    neigh = [i for i in range(lo, hi) if i != center]
    # motion vectors: exact
    Hc, Wc = (h // 16) * 16, (w // 16) * 16
    got_mv = FT._block_mvs(
        torch.from_numpy(frames[center][0][:Hc, :Wc]),
        [torch.from_numpy(frames[i][0][:Hc, :Wc]) for i in neigh]).numpy()
    want_mv = _tf_mvs_jax(frames, center, neigh)
    np.testing.assert_array_equal(
        got_mv.reshape(want_mv.shape), want_mv)
    if pan:
        assert (got_mv[..., 1] != 0).any()
    for q in (120, 40):
        want = FJ.temporal_filter(frames, center, q)
        got = FT.temporal_filter(frames, center, q, device="cpu")
        changed = 0
        for g, wnt, src in zip(got, want, frames[center]):
            wnt = np.asarray(wnt)
            assert g.dtype == np.uint8 and g.shape == src.shape
            d = np.abs(g.astype(np.int32) - wnt.astype(np.int32))
            assert d.max() <= 1
            # measured: no pixel differs on any of these clips
            assert int((d > 0).sum()) == 0
            changed += int((g != src).sum())
        assert changed > 0          # the filter did something


def test_temporal_filter_takes_device_tensors_and_keeps_the_strip():
    frames = _clip(n=5, w=88, h=56)
    dev = [tuple(torch.from_numpy(p) for p in f) for f in frames]
    a = FT.temporal_filter(frames, 4, 120, device="cpu")
    b = FT.temporal_filter(dev, 4, 120, device="cpu")
    # 88x56 holds a 80x48 grid of 16x16 blocks (40x24 in chroma); rows and
    # columns outside it are the source's
    for x, y, src, (hc, wc) in zip(a, b, frames[4],
                                   ((48, 80), (24, 40), (24, 40))):
        assert isinstance(y, np.ndarray)
        np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(x[hc:], src[hc:])
        np.testing.assert_array_equal(x[:, wc:], src[:, wc:])
        assert (x[:hc, :wc] != src[:hc, :wc]).any()
    # without neighbours the frame comes back as it is
    assert FT.temporal_filter(frames[:1], 0, 120, device="cpu") is frames[0]
