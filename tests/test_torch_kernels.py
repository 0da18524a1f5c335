"""The port's kernels (aom_av1_lavish_torch/ops/kernels.py) against the
JAX package's Pallas kernels and their XLA fallbacks, and against numpy
oracles.  All outputs are integers or exact-integer float32, so every
comparison is exact (tolerance 0).

On the CPU each wrapper runs its plain PyTorch version; the CUDA kernels
themselves are compared with the plain versions on a card by
tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aom_av1_lavish_tpu.ops.pallas_kernels as PK
from aom_av1_lavish_tpu.common import interpred as IP
from aom_av1_lavish_tpu.common import quant as Q
from aom_av1_lavish_tpu.ops import inter_tpu as IJ
from aom_av1_lavish_tpu.ops import wavefront as WJ
from aom_av1_lavish_torch.ops import inter as IT
from aom_av1_lavish_torch.ops import kernels as K
from aom_av1_lavish_torch.ops import wavefront as WT


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


@pytest.fixture
def xla_path(monkeypatch):
    """The JAX functions' XLA fallbacks (no Pallas)."""
    monkeypatch.delenv("AVL_FORCE_PALLAS", raising=False)
    monkeypatch.setenv("AVL_NO_PALLAS", "1")


@pytest.fixture
def pallas_interpret(monkeypatch):
    """The JAX functions' Pallas kernels in interpret mode."""
    monkeypatch.setenv("AVL_FORCE_PALLAS", "1")
    monkeypatch.delenv("AVL_NO_PALLAS", raising=False)


def _ssd_oracle(src, win, bsz, radius):
    """The JAX package's surface as its rounding makes it (ROADMAP F1),
    from S2 = sum(s^2), W2 = sum(w^2) and C = sum(s*w) summed in int64:
    R(S2 + W2) - 2C in float32 where all three lie below 2^24 (there every
    float32 partial sum of the reference is an exact integer, whatever its
    order, and the add S2 + W2 is its one rounding), else the exact SSD
    converted once (there the reference's value depends on XLA's order of
    summation)."""
    S = 2 * radius + 1
    B = src.shape[0]
    out = np.empty((B, S, S), np.float32)
    s64 = src.astype(np.int64)
    s2 = (s64 * s64).sum((1, 2))
    for dy in range(S):
        for dx in range(S):
            w = win[:, dy:dy + bsz, dx:dx + bsz].astype(np.int64)
            w2 = (w * w).sum((1, 2))
            c = (s64 * w).sum((1, 2))
            order_free = np.maximum(np.maximum(s2, w2), c) < (1 << 24)
            out[:, dy, dx] = np.where(
                order_free,
                (s2 + w2).astype(np.float32) - (2 * c).astype(np.float32),
                (s2 + w2 - 2 * c).astype(np.float32))
    return out


def _ssd_inputs(bsz, radius, lo, hi, B=5, seed=7):
    rng = np.random.default_rng(seed)
    W = 2 * radius + bsz
    src = rng.integers(lo, hi, (B, bsz, bsz)).astype(np.int32)
    win = rng.integers(lo, hi, (B, W, W)).astype(np.int32)
    return src, win


SSD_SHAPES = [(16, 16), (16, 8), (8, 8), (8, 16)]


@pytest.mark.parametrize("bsz,radius", SSD_SHAPES)
def test_ssd_surface_matches_int64_oracle_full_range(bsz, radius):
    """0..255 content, including the bright 240..255 band where
    S2 + W2 passes 2^24 and the reference's float32 identity rounds
    (ROADMAP F1): the port rounds as the oracle says it does."""
    for lo, hi in ((0, 256), (240, 256)):
        src, win = _ssd_inputs(bsz, radius, lo, hi)
        got = K.ssd_surface(torch.from_numpy(src), torch.from_numpy(win),
                            bsz, radius)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(),
                                      _ssd_oracle(src, win, bsz, radius))


@pytest.mark.parametrize("bsz,radius", SSD_SHAPES)
def test_ssd_surface_matches_jax_xla(xla_path, bsz, radius):
    """Pixels <= 90: every float32 partial sum of the reference is an
    exact integer there."""
    src, win = _ssd_inputs(bsz, radius, 0, 91)
    got = K.ssd_surface(torch.from_numpy(src), torch.from_numpy(win), bsz,
                        radius)
    want = np.asarray(PK.ssd_surface(jnp.asarray(src), jnp.asarray(win),
                                     bsz, radius))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bsz,radius,lo,hi", [(16, 16, 240, 256),
                                               (16, 8, 240, 256),
                                               (8, 16, 350, 511)])
def test_ssd_surface_matches_jax_xla_bright(xla_path, bsz, radius, lo, hi):
    """Bright content, where S2 + W2 passes 2^24 and the reference rounds
    its float32 sum (ROADMAP F1): full-resolution uint8 pixels 240..255
    and half-resolution 2x2 sums 350..510, whose S2, W2 and C all stay
    below 2^24, so the reference's value is order-free and the port's
    equals it bit for bit."""
    src, win = _ssd_inputs(bsz, radius, lo, hi)
    got = K.ssd_surface(torch.from_numpy(src), torch.from_numpy(win), bsz,
                        radius).numpy()
    want = np.asarray(PK.ssd_surface(jnp.asarray(src), jnp.asarray(win),
                                     bsz, radius))
    np.testing.assert_array_equal(got, want)
    # the exact SSD would not do: the rounding shows on these inputs
    assert (got != _exact_ssd(src, win, bsz, radius)).any()


def _exact_ssd(src, win, bsz, radius):
    S = 2 * radius + 1
    out = np.empty((src.shape[0], S, S), np.int64)
    s64 = src.astype(np.int64)
    for dy in range(S):
        for dx in range(S):
            d = s64 - win[:, dy:dy + bsz, dx:dx + bsz].astype(np.int64)
            out[:, dy, dx] = (d * d).sum((1, 2))
    return out.astype(np.float32)


@pytest.mark.parametrize("bsz,radius", [(16, 8), (8, 8)])
def test_ssd_surface_matches_pallas_interpret(pallas_interpret, bsz,
                                              radius):
    """Both TPU kernels (lane-major and per-block grid) in interpret mode."""
    src, win = _ssd_inputs(bsz, radius, 0, 91, B=3)
    got = K.ssd_surface(torch.from_numpy(src), torch.from_numpy(win), bsz,
                        radius).numpy()
    lanes = np.asarray(PK._ssd_lanes_fn(bsz, radius)(jnp.asarray(src),
                                                     jnp.asarray(win)))
    grid = np.asarray(PK._ssd_pallas_fn(bsz, radius)(jnp.asarray(src),
                                                     jnp.asarray(win)))
    np.testing.assert_array_equal(got, lanes)
    np.testing.assert_array_equal(got, grid)


def _ssd_planes(bsz, radius, nby, nbx, lo, hi, dtype, seed=13):
    """A source plane and a reference plane padded by `radius` + 3 on
    every side (window origin of block (0, 0) at (3, 3))."""
    rng = np.random.default_rng(seed)
    src = rng.integers(lo, hi, (nby * bsz, nbx * bsz)).astype(dtype)
    ref = rng.integers(lo, hi, (nby * bsz + 2 * radius + 6,
                                nbx * bsz + 2 * radius + 6)).astype(dtype)
    return src, ref


@pytest.mark.parametrize("bsz,dtype,hi", [(16, np.uint8, 91),
                                          (8, np.int32, 321)])
def test_ssd_surface_plane_matches_jax_on_reference_windows(xla_path, bsz,
                                                            dtype, hi):
    """The plane form against the JAX ssd_surface fed with windows cut by
    the reference's _stride_windows and tiles cut as its caller cuts them,
    at the search's radius 16: full res (uint8 pixels <= 90) and half res
    (int32 2x2 sums <= 320), where the reference's float32 sums are exact
    integers."""
    _plane_matches_jax(bsz, dtype, 0, hi)


def _plane_matches_jax(bsz, dtype, lo, hi):
    r, nby, nbx = 16, 3, 5
    src, ref = _ssd_planes(bsz, r, nby, nbx, lo, hi, dtype)
    got = K.ssd_surface_plane(torch.from_numpy(src), torch.from_numpy(ref),
                              nby, nbx, bsz, r, 3, 3)
    assert got.dtype == torch.float32
    win = IJ._stride_windows(jnp.asarray(ref), 3, 3, nby, nbx, bsz,
                             2 * r + bsz).astype(jnp.int32)
    blk = jnp.asarray(src).reshape(nby, bsz, nbx, bsz) \
        .transpose(0, 2, 1, 3).reshape(nby * nbx, bsz, bsz) \
        .astype(jnp.int32)
    want = np.asarray(PK.ssd_surface(blk, win, bsz, r))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bsz,dtype,lo,hi", [(16, np.uint8, 240, 256),
                                             (8, np.int32, 350, 511)])
def test_ssd_surface_plane_matches_jax_on_bright_reference_windows(
        xla_path, bsz, dtype, lo, hi):
    """The plane form against the JAX ssd_surface on bright content, as
    test_ssd_surface_plane_matches_jax_on_reference_windows cuts it: the
    reference rounds S2 + W2 there, order-free, and the port rounds as it
    does (ROADMAP F1)."""
    _plane_matches_jax(bsz, dtype, lo, hi)


@pytest.mark.parametrize("bsz,dtype,lo,hi", [(16, np.uint8, 0, 256),
                                             (16, np.uint8, 240, 256),
                                             (8, np.int32, 0, 1021),
                                             (8, np.int32, 960, 1021),
                                             (8, np.uint8, 0, 256),
                                             (16, np.int32, 0, 1021)])
def test_ssd_surface_plane_matches_int64_oracle_full_range(bsz, dtype, lo,
                                                           hi):
    """Full-range and bright content (0..255 at full res, 0..1020 at half
    res) against the oracle of the reference's rounding on windows cut
    with numpy (ROADMAP F1).  At 960..1020 every S2 and W2 of a bsz-8
    block is at least 64 * 960^2 > 2^24, so each entry there is the exact
    SSD: the reference's own value depends on XLA's order of summation."""
    r, nby, nbx = 16, 2, 3
    src, ref = _ssd_planes(bsz, r, nby, nbx, lo, hi, dtype)
    got = K.ssd_surface_plane(torch.from_numpy(src), torch.from_numpy(ref),
                              nby, nbx, bsz, r, 3, 3)
    Wn = 2 * r + bsz
    blk = np.stack([src[by * bsz:(by + 1) * bsz, bx * bsz:(bx + 1) * bsz]
                    for by in range(nby) for bx in range(nbx)])
    win = np.stack([ref[3 + by * bsz:3 + by * bsz + Wn,
                        3 + bx * bsz:3 + bx * bsz + Wn]
                    for by in range(nby) for bx in range(nbx)])
    np.testing.assert_array_equal(got.numpy(),
                                  _ssd_oracle(blk, win, bsz, r))


def test_ssd_surface_plane_equals_the_window_form():
    """Both entries of K2 compute one function."""
    r, bsz, nby, nbx = 8, 16, 2, 4
    src, ref = _ssd_planes(bsz, r, nby, nbx, 0, 256, np.uint8)
    src, ref = torch.from_numpy(src), torch.from_numpy(ref)
    a = K.ssd_surface_plane(src, ref, nby, nbx, bsz, r, 3, 3)
    win = K.stride_windows(ref, 3, 3, nby, nbx, bsz, 2 * r + bsz)
    blk = K.stride_windows(src, 0, 0, nby, nbx, bsz, bsz)
    b = K.ssd_surface(blk.to(torch.int32), win.to(torch.int32), bsz, r)
    assert torch.equal(a, b)


def _quant_params(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(a, b, (n,)).astype(np.int32)
            for a, b in ((20, 1000), (10, 500), (1 << 12, 1 << 16),
                         (1 << 14, 1 << 16), (4, 7000))]


@pytest.mark.parametrize("n,log_scale", [(16, 0), (64, 0), (256, 1),
                                         (1024, 2)])
def test_quantize_matches_jax_xla_and_pallas(monkeypatch, n, log_scale):
    """Random parameters (tests/test_pallas.py's ranges) make the int32
    products wrap; the port must wrap the same way."""
    rng = np.random.default_rng(3 + n)
    coeff = rng.integers(-(1 << 20), 1 << 20, (23, n)).astype(np.int32)
    params = _quant_params(n, 5 + n)
    q, dq = K.quantize_b_vec(torch.from_numpy(coeff),
                             *map(torch.from_numpy, params), log_scale)
    jargs = [jnp.asarray(a) for a in (coeff, *params)]
    for env in ("AVL_NO_PALLAS", "AVL_FORCE_PALLAS"):
        monkeypatch.delenv("AVL_NO_PALLAS", raising=False)
        monkeypatch.delenv("AVL_FORCE_PALLAS", raising=False)
        monkeypatch.setenv(env, "1")
        wq, wdq = PK.quantize_b_vec(*jargs, log_scale)
        np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
        np.testing.assert_array_equal(dq.numpy(), np.asarray(wdq))


@pytest.mark.parametrize("qindex,tx_n,log_scale", [(120, 64, 0),
                                                   (120, 256, 0),
                                                   (60, 1024, 1),
                                                   (200, 1024, 2)])
def test_quantize_site_matches_inline_twin(qindex, tx_n, log_scale):
    """The production quantize site: wavefront.quantize (through K4)
    against the reference's inline _quantize_jnp with real parameters."""
    rng = np.random.default_rng(qindex + tx_n)
    coeff = rng.integers(-3000, 3001, (40, tx_n)).astype(np.int32)
    pq = Q.build_plane_quant(qindex, 0, 0)
    arr = WT.pq_array(pq)
    np.testing.assert_array_equal(arr, WJ._pq_array(pq))
    dc = np.arange(tx_n) == 0
    q, dq = WT.quantize(torch.from_numpy(coeff), torch.from_numpy(arr),
                        log_scale, torch.from_numpy(dc))
    wq, wdq = WJ._quantize_jnp(jnp.asarray(coeff), WJ._PQ(arr), log_scale,
                               dc)
    np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(dq.numpy(), np.asarray(wdq))


@pytest.mark.parametrize("bh,bw", [(8, 8), (16, 16), (8, 16), (32, 32),
                                   (64, 64)])
def test_convolve_8tap_matches_jax(monkeypatch, bh, bw):
    rng = np.random.default_rng(11 + bh + bw)
    B = 7
    region = rng.integers(0, 256, (B, bh + 7, bw + 7)).astype(np.int32)
    filt = np.concatenate([np.asarray(IP.SUBPEL_FILTERS_8),
                           np.asarray(IP.SUBPEL_FILTERS_8SHARP)])
    kx = filt[rng.integers(0, len(filt), B)].astype(np.int32)
    ky = filt[rng.integers(0, len(filt), B)].astype(np.int32)
    got = K.convolve_8tap(*map(torch.from_numpy, (region, kx, ky)), bh, bw)
    assert got.dtype == torch.uint8
    for env in ("AVL_NO_PALLAS", "AVL_FORCE_PALLAS"):
        monkeypatch.delenv("AVL_NO_PALLAS", raising=False)
        monkeypatch.delenv("AVL_FORCE_PALLAS", raising=False)
        monkeypatch.setenv(env, "1")
        want = np.asarray(PK.convolve_8tap(jnp.asarray(region),
                                           jnp.asarray(kx), jnp.asarray(ky),
                                           bh, bw))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [8, 16, 32, 64])
def test_convolve_8tap_plane_matches_jax_gather_and_convolve(
        pallas_interpret, n):
    """The plane form against the JAX package's own chain: gather_windows
    cuts the (n+7, n+7) regions from the uint8 plane, convolve_8tap
    filters their int32 copy (both Pallas kernels in interpret mode)."""
    rng = np.random.default_rng(17 + n)
    H, W, B = 160, 256, 9
    plane = rng.integers(0, 256, (H, W)).astype(np.uint8)
    br = rng.integers(0, H - n - 8, B).astype(np.int32)
    bc = rng.integers(0, W - n - 8, B).astype(np.int32)
    filt = np.concatenate([np.asarray(IP.SUBPEL_FILTERS_8),
                           np.asarray(IP.SUBPEL_FILTERS_8SMOOTH),
                           np.asarray(IP.SUBPEL_FILTERS_8SHARP)])
    kx = filt[rng.integers(0, len(filt), B)].astype(np.int32)
    ky = filt[rng.integers(0, len(filt), B)].astype(np.int32)
    got = K.convolve_8tap_plane(*map(torch.from_numpy,
                                     (plane, br, bc, kx, ky)), n, n)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (B, n, n)
    region = PK.gather_windows(jnp.asarray(plane), jnp.asarray(br),
                               jnp.asarray(bc), n + 7, n + 7)
    want = np.asarray(PK.convolve_8tap(region.astype(jnp.int32),
                                       jnp.asarray(kx), jnp.asarray(ky),
                                       n, n))
    np.testing.assert_array_equal(got.numpy(), want)


def test_convolve_8tap_plane_clamps_origins_like_the_gather():
    """Origins off the plane read its edge, as gather_windows does."""
    rng = np.random.default_rng(5)
    plane = torch.from_numpy(rng.integers(0, 256, (40, 50))
                             .astype(np.uint8))
    br = torch.tensor([-9, 30, 0, 39], dtype=torch.int32)
    bc = torch.tensor([44, -5, 0, 49], dtype=torch.int32)
    taps = torch.from_numpy(np.asarray(IP.SUBPEL_FILTERS_8)[[3, 8, 0, 15]]
                            .astype(np.int32))
    got = K.convolve_8tap_plane(plane, br, bc, taps, taps.flip(0), 16, 16)
    region = K.gather_windows(plane, br, bc, 23, 23).to(torch.int32)
    want = K.convolve_8tap(region, taps, taps.flip(0), 16, 16)
    assert torch.equal(got, want)


@pytest.mark.parametrize("wr,wc,dtype", [(23, 23, "uint8"),
                                         (39, 39, "uint8"),
                                         (15, 23, "uint8"),
                                         (25, 25, "int32")])
def test_gather_windows_matches_numpy_and_pallas(pallas_interpret, wr, wc,
                                                 dtype):
    rng = np.random.default_rng(3)
    H, W = 192, 256
    plane = rng.integers(0, 255, (H, W)).astype(dtype)
    B = 37
    fr = rng.integers(0, H - wr - 1, B).astype(np.int32)
    fc = rng.integers(0, W - wc - 1, B).astype(np.int32)
    got = K.gather_windows(*map(torch.from_numpy, (plane, fr, fc)), wr, wc)
    want = plane[fr[:, None, None] + np.arange(wr)[None, :, None],
                 fc[:, None, None] + np.arange(wc)[None, None, :]]
    np.testing.assert_array_equal(got.numpy(), want)
    pallas = np.asarray(PK.gather_windows(jnp.asarray(plane),
                                          jnp.asarray(fr), jnp.asarray(fc),
                                          wr, wc))
    np.testing.assert_array_equal(got.numpy(), pallas)


def test_gather_windows_clamps_origins_to_the_plane():
    """Rows and columns outside the plane read its edge (callers keep
    windows inside the padded plane; the clamp keeps a stray origin from
    reading outside the allocation)."""
    plane = np.arange(20 * 30, dtype=np.int32).reshape(20, 30) % 251
    fr = np.array([-3, 15, 0], np.int32)
    fc = np.array([25, -2, 0], np.int32)
    got = K.gather_windows(*map(torch.from_numpy, (plane, fr, fc)), 8, 9)
    rr = np.clip(fr[:, None, None] + np.arange(8)[None, :, None], 0, 19)
    cc = np.clip(fc[:, None, None] + np.arange(9)[None, None, :], 0, 29)
    np.testing.assert_array_equal(got.numpy(), plane[rr, cc])


def _ssd_at_inputs(bsz, nby, nbx, n_cand, lo, hi, seed, off_plane):
    """A source plane of (nby, nbx) blocks, a reference plane, and n_cand
    origins per block: near the block's own position, or (off_plane)
    anywhere up to two blocks outside the reference."""
    rng = np.random.default_rng(seed)
    src = rng.integers(lo, hi, (nby * bsz + 3, nbx * bsz + 5)).astype(np.uint8)
    Hr, Wr = nby * bsz + 24, nbx * bsz + 40
    ref = rng.integers(lo, hi, (Hr, Wr)).astype(np.uint8)
    B = nby * nbx
    if off_plane:
        br = rng.integers(-2 * bsz, Hr + bsz, (B, n_cand))
        bc = rng.integers(-2 * bsz, Wr + bsz, (B, n_cand))
    else:
        y0 = np.repeat(np.arange(nby), nbx) * bsz
        x0 = np.tile(np.arange(nbx), nby) * bsz
        br = y0[:, None] + rng.integers(0, 24, (B, n_cand))
        bc = x0[:, None] + rng.integers(0, 40, (B, n_cand))
    return src, ref, br.astype(np.int32), bc.astype(np.int32)


@pytest.mark.parametrize("bsz,n_cand,lo,hi,off_plane", [
    (16, 9, 0, 256, False), (8, 9, 0, 256, False), (16, 9, 240, 256, False),
    (16, 5, 0, 256, True), (8, 35, 0, 256, True)])
def test_block_ssd_at_matches_numpy(bsz, n_cand, lo, hi, off_plane):
    """K1's fused form (its plain version on the CPU) against a direct
    int64 numpy SSD with clamped window indices; exact, full-range and
    bright pixels, origins on and off the plane."""
    nby, nbx = 3, 4
    src, ref, br, bc = _ssd_at_inputs(bsz, nby, nbx, n_cand, lo, hi,
                                      bsz + n_cand, off_plane)
    got = K.block_ssd_at(*map(torch.from_numpy, (src, ref, br, bc)), nby,
                         nbx, bsz)
    assert got.dtype == torch.int32 and tuple(got.shape) == (nby * nbx,
                                                             n_cand)
    Hr, Wr = ref.shape
    ar = np.arange(bsz)
    want = np.empty((nby * nbx, n_cand), np.int64)
    for b in range(nby * nbx):
        by, bx = divmod(b, nbx)
        blk = src[by * bsz:(by + 1) * bsz, bx * bsz:(bx + 1) * bsz] \
            .astype(np.int64)
        for k in range(n_cand):
            rr = np.clip(br[b, k] + ar, 0, Hr - 1)
            cc = np.clip(bc[b, k] + ar, 0, Wr - 1)
            d = blk - ref[rr[:, None], cc[None, :]].astype(np.int64)
            want[b, k] = (d * d).sum()
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bsz,off_plane", [(16, False), (8, False),
                                           (16, True)])
def test_block_ssd_at_equals_gathers_and_float_ssd(bsz, off_plane):
    """One fused call gives what the full-pel refine computed before it:
    per candidate a gather_windows and a float32 subtract, square and sum
    (exact integers below 2^24, so the float32 values are equal)."""
    nby, nbx, n_cand = 3, 5, 9
    src, ref, br, bc = map(torch.from_numpy, _ssd_at_inputs(
        bsz, nby, nbx, n_cand, 0, 256, 40 + bsz, off_plane))
    got = K.block_ssd_at(src, ref, br, bc, nby, nbx, bsz).to(torch.float32)
    blk = K.stride_windows(src, 0, 0, nby, nbx, bsz, bsz).to(torch.float32)
    for k in range(n_cand):
        win = K.gather_windows(ref, br[:, k].contiguous(),
                               bc[:, k].contiguous(), bsz, bsz)
        d = win.to(torch.float32) - blk
        assert torch.equal(got[:, k], (d * d).sum((1, 2)))


def test_block_ssd_at_checks_dtype_shape_and_device():
    def z(shape, dtype=torch.uint8):
        return torch.zeros(shape, dtype=dtype)
    o = z((6, 9), torch.int32)
    with pytest.raises(ValueError, match="uint8 planes"):
        K.block_ssd_at(z((32, 48), torch.int32), z((40, 60)), o, o, 2, 3, 16)
    with pytest.raises(ValueError, match="does not hold 2x3 blocks"):
        K.block_ssd_at(z((32, 47)), z((40, 60)), o, o, 2, 3, 16)
    with pytest.raises(ValueError, match=r"int32 \(6, C\)"):
        K.block_ssd_at(z((32, 48)), z((40, 60)), z((5, 9), torch.int32),
                       z((5, 9), torch.int32), 2, 3, 16)
    with pytest.raises(ValueError, match=r"int32 \(6, C\)"):
        K.block_ssd_at(z((32, 48)), z((40, 60)), o.long(), o.long(), 2, 3,
                       16)
    meta = torch.empty((40, 60), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="expected all on the CPU"):
        K.block_ssd_at(z((32, 48)), meta, o, o, 2, 3, 16)
    with pytest.raises(ValueError, match="positive"):
        K.gather_windows(z((8, 8)), z(2, torch.int32), z(2, torch.int32), 0,
                         4)


@pytest.mark.parametrize("ref_frame", [1, 13])
def test_fullpel_search_matches_jax(xla_path, ref_frame):
    """The two-scale full-pel search with its fused 3x3 refine against
    inter_tpu._fullpel_search on a 96x64 frame (pixels 0..90, where the
    reference's float32 SSD is exact) and each of two references: the
    previous frame, and one eleven frames on, whose pan of 22 pixels lies
    outside the full-resolution surface, so that only the half-resolution
    pass and its refine find it."""
    H, W, n = 64, 96, 14
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:H + 2 * n, 0:W + 2 * n]
    base = (45 + 30 * np.sin(yy / 9.0) * np.cos(xx / 13.0)
            + rng.normal(0, 3, yy.shape)).clip(0, 90).astype(np.uint8)
    frames = [np.ascontiguousarray(base[i:i + H, 2 * i:2 * i + W])
              for i in range(n)]
    src, ref = frames[2], frames[ref_frame]
    zc = np.zeros((H // 2, W // 2), np.uint8)
    nby, nbx = H // 16, W // 16
    y0 = np.repeat(np.arange(nby), nbx) * 16
    x0 = np.tile(np.arange(nbx), nby) * 16
    py, _, _, py2 = IJ._pad_ref_jnp(*map(jnp.asarray, (ref, zc, zc)))
    blk = jnp.asarray(src).reshape(nby, 16, nbx, 16).transpose(0, 2, 1, 3) \
        .reshape(nby * nbx, 16, 16).astype(jnp.int32)
    want = IJ._fullpel_search(blk, py, py2, jnp.asarray(y0), jnp.asarray(x0),
                              16, grid=(nby, nbx))
    ty, _, _, ty2 = IT.pad_ref(*map(torch.from_numpy, (ref, zc, zc)))
    got = IT._fullpel_search(torch.from_numpy(src), ty, ty2,
                             torch.from_numpy(y0), torch.from_numpy(x0), nby,
                             nbx)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if ref_frame == 13:
        # the refine's candidates won somewhere
        assert (got[1].abs() > IT.FULLPEL_RADIUS).any()


def test_wrappers_check_dtype_shape_and_device():
    z = torch.zeros
    with pytest.raises(ValueError, match="int32"):
        K.ssd_surface(z((2, 8, 8)), z((2, 24, 24), dtype=torch.int32), 8, 8)
    with pytest.raises(ValueError, match="expected src"):
        K.ssd_surface(z((2, 8, 8), dtype=torch.int32),
                      z((2, 23, 24), dtype=torch.int32), 8, 8)
    with pytest.raises(ValueError, match="2-D"):
        K.gather_windows(z((2, 4, 4), dtype=torch.uint8),
                         z(2, dtype=torch.int32), z(2, dtype=torch.int32),
                         2, 2)
    with pytest.raises(ValueError, match="taps"):
        K.convolve_8tap(z((2, 23, 23), dtype=torch.int32),
                        z((2, 7), dtype=torch.int32),
                        z((2, 8), dtype=torch.int32), 16, 16)
    with pytest.raises(ValueError, match="log_scale"):
        K.quantize_b_vec(*(z((3, 4), dtype=torch.int32),)
                         + tuple(z(4, dtype=torch.int32) for _ in range(5)),
                         3)
    # a tensor on another device never takes the CPU path
    meta = torch.empty((2, 8, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="expected all on the CPU"):
        K.ssd_surface(meta, z((2, 24, 24), dtype=torch.int32), 8, 8)


def test_plane_form_wrappers_check_dtype_and_extent():
    def z(shape, dtype=torch.uint8):
        return torch.zeros(shape, dtype=dtype)
    with pytest.raises(ValueError, match="both uint8 or both int32"):
        K.ssd_surface_plane(z((16, 16)), z((48, 48), dtype=torch.int32), 1,
                            1, 16, 16, 0, 0)
    with pytest.raises(ValueError, match="does not hold every"):
        K.ssd_surface_plane(z((16, 32)), z((48, 63)), 1, 2, 16, 16, 0, 0)
    with pytest.raises(ValueError, match="does not hold 2x1 blocks"):
        K.ssd_surface_plane(z((16, 16)), z((64, 48)), 2, 1, 16, 16, 0, 0)
    with pytest.raises(ValueError, match="uint8 plane"):
        K.convolve_8tap_plane(z((40, 40), dtype=torch.int32),
                              z(2, dtype=torch.int32),
                              z(2, dtype=torch.int32),
                              z((2, 8), dtype=torch.int32),
                              z((2, 8), dtype=torch.int32), 16, 16)
    with pytest.raises(ValueError, match=r"int32 \(B, 8\)"):
        K.convolve_8tap_plane(z((40, 40)), z(2, dtype=torch.int32),
                              z(2, dtype=torch.int32),
                              z((2, 7), dtype=torch.int32),
                              z((2, 8), dtype=torch.int32), 16, 16)
    meta = torch.empty((40, 40), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="expected all on the CPU"):
        K.ssd_surface_plane(z((16, 16)), meta, 1, 1, 16, 4, 0, 0)


def test_cpu_tensors_run_the_plain_versions_and_launch_nothing():
    K.reset_launches()
    rng = np.random.default_rng(1)
    src, win = _ssd_inputs(8, 8, 0, 256)
    a = K.ssd_surface(torch.from_numpy(src), torch.from_numpy(win), 8, 8)
    b = K.ssd_surface_plain(torch.from_numpy(src), torch.from_numpy(win), 8,
                            8)
    assert torch.equal(a, b)
    plane = torch.from_numpy(rng.integers(0, 256, (40, 40)).astype(np.uint8))
    base = torch.zeros(3, dtype=torch.int32)
    K.gather_windows(plane, base, base, 4, 4)
    assert all(v == 0 for v in K.LAUNCHES.values())


# ---------------------------------------------------------------------------
# K4's fused entry: the tables handed to the wave kernel, and a numpy model
# of the kernel's data path run from those tables alone


def _wave_table_part(key, size):
    o = K.WAVE_TABLE_OFFSETS[key]
    return K.wave_tables()[o:o + size]


@pytest.mark.parametrize("n,part,inverse", [
    (16, "fdct16_col", False), (16, "fdct16_row", False),
    (16, "idct16", True), (8, "fdct8_col", False), (8, "fdct8_row", False),
    (8, "idct8", True)])
def test_wave_stage_tables_equal_the_transform_stages(n, part, inverse):
    """The stage tables the wave kernel interprets are fdct_stages and
    idct_stages of the port's common/txfm1d.py (and of the JAX package's)
    at the cos bits of common/txfm2d.py, entry for entry."""
    from aom_av1_lavish_tpu.common import txfm1d as RT1
    from aom_av1_lavish_torch.common import txfm1d as T1
    from aom_av1_lavish_torch.common import txfm2d as T2
    idx = n.bit_length() - 3
    cos_bit = (T1.INV_COS_BIT if inverse else
               (T2._FWD_COS_BIT_ROW if part.endswith("row")
                else T2._FWD_COS_BIT_COL)[idx][idx])
    for mod in (T1, RT1):
        stages = (mod.idct_stages if inverse else mod.fdct_stages)(n, cos_bit)
        want = np.asarray(stages, np.int64)
        assert want.shape == (len(stages), n, 5)
        got = _wave_table_part(part, want.size).reshape(want.shape)
        np.testing.assert_array_equal(got, want)
    params = _wave_table_part(f"params{n}", 8)
    assert params[7] == len(stages)
    assert params[1 if part.endswith("row") else 0] == cos_bit or inverse


@pytest.mark.parametrize("n", [8, 16])
def test_wave_tables_scans_params_and_layout(n):
    """Scan positions (the kernel keeps flat coefficient c * n + r at
    position r * n + c), shifts, weights and modes; and the parts tile the
    array without overlap."""
    from aom_av1_lavish_torch.bitstream import constants as c
    from aom_av1_lavish_torch.bitstream import tables
    from aom_av1_lavish_torch.common import txfm2d as T2
    from aom_av1_lavish_torch.common.intra import SMOOTH_WEIGHTS
    tx = c.TX_16X16 if n == 16 else c.TX_8X8
    scan_p = _wave_table_part("scan_y" if n == 16 else "scan_c", n * n)
    flat = scan_p % n * n + scan_p // n             # the map is its inverse
    np.testing.assert_array_equal(flat, tables.scan(tx, c.DCT_DCT))
    assert sorted(scan_p) == list(range(n * n))
    params = _wave_table_part(f"params{n}", 8)
    assert tuple(params[2:5]) == T2.FWD_SHIFT[tx]
    assert tuple(params[5:7]) == T2.INV_SHIFT[tx]
    np.testing.assert_array_equal(_wave_table_part("smooth16", 16),
                                  SMOOTH_WEIGHTS[16])
    assert tuple(_wave_table_part("modes", 7)) == WT.WAVE_MODES \
        == WJ.WAVE_MODES
    off = K.WAVE_TABLE_OFFSETS
    sizes = {"fdct16_col": 560, "fdct16_row": 560, "idct16": 560,
             "fdct8_col": 200, "fdct8_row": 200, "idct8": 200,
             "scan_y": 256, "scan_c": 64, "smooth16": 16, "modes": 8,
             "params16": 8, "params8": 8}
    at = 0
    for key, size in sizes.items():
        assert off[key] == at
        at += size
    assert off["total"] == at == K.wave_tables().size
    assert K.wave_tables().dtype == np.int32


def _model_pass(x, tab, n, cos_bit, along_rows, inverse, post, clamp_out):
    """One 1-D pass of the wave kernel over one block held as positions
    p = hi * n + lo (csrc/wave_encode.cu txfm_pass), in int64 numpy."""
    def c16(v):
        return min(max(v, -32768), 32767)
    cur = [int(v) for v in x]
    for s in range(tab.shape[0]):
        out = [0] * (n * n)
        for p in range(n * n):
            hi, lo = divmod(p, n)
            i, line, es = (lo, hi * n, 1) if along_rows else (hi, lo, n)
            kind, s0, s1, w0, w1 = (int(v) for v in tab[s, i])
            a, b = cur[line + s0 * es], cur[line + s1 * es]
            if kind == 2:
                v = (a * w0 + b * w1 + (1 << (cos_bit - 1))) >> cos_bit
            elif kind == 1:
                v = a * w0 + b * w1
                v = c16(v) if inverse else v
            else:
                v = a * w0
            if s == tab.shape[0] - 1:
                v = (v + (1 << (post - 1))) >> post if post > 0 else v << -post
                v = c16(v) if clamp_out else v
            out[p] = v
        cur = out
    return cur


@pytest.mark.parametrize("n,qindex,spread", [(16, 100, 40), (16, 20, 255),
                                             (16, 200, 3), (8, 100, 40),
                                             (8, 20, 255), (8, 200, 3)])
def test_wave_kernel_data_path_model_matches_the_torch_ops(n, qindex, spread):
    """What the wave kernel does to one block, modelled in numpy from
    wave_tables() alone (its positions, passes, shifts, clamps, quantizer
    and scan), equals the torch ops of the plain version: coefficients,
    levels, eob and recon."""
    from aom_av1_lavish_torch.bitstream import constants as c
    from aom_av1_lavish_torch.bitstream import tables
    from aom_av1_lavish_torch.ops import txfm as TX
    tx = c.TX_16X16 if n == 16 else c.TX_8X8
    rng = np.random.default_rng(n + qindex)
    if spread == 40:      # a smooth residual: a few low-frequency levels
        pred = rng.integers(64, 192, (n, n))
        rr, cc = np.mgrid[0:n, 0:n]
        src = pred + np.rint(spread * np.cos(np.pi * (rr + 0.5) / n)
                             * np.cos(np.pi * (cc + 0.5) / n)).astype(int)
    else:                 # noise: no level (spread 3) or all of them
        pred = rng.integers(0, 256, (n, n))
        src = (pred + rng.integers(-spread, spread + 1, (n, n))).clip(0, 255)
    cb_col, cb_row, f0, f1, f2, i0, i1, st = (
        int(v) for v in _wave_table_part(f"params{n}", 8))
    tabs = {k: _wave_table_part(f"{k}{n}{sfx}", st * n * 5).reshape(st, n, 5)
            for k, sfx in (("fdct", "_col"), ("idct", ""))}
    tabs["row"] = _wave_table_part(f"fdct{n}_row", st * n * 5) \
        .reshape(st, n, 5)
    x = [int(v) << f0 for v in (src - pred).reshape(-1)]
    x = _model_pass(x, tabs["fdct"], n, cb_col, False, False, -f1, False)
    x = _model_pass(x, tabs["row"], n, cb_row, True, False, -f2, False)
    pq = WT.pq_array(Q.build_plane_quant(qindex, 0, 0)).astype(np.int64)
    q, dq = [], []
    for p, v in enumerate(x):
        zbin, rnd, quant, qshift, deq = pq[:, 0 if p == 0 else 1]
        tmp = min(max(abs(v) + rnd, -32768), 32767)
        t = (((tmp * quant) >> 16) + tmp) * qshift >> 16
        t = int(t) if abs(v) >= zbin else 0
        sign = -1 if v < 0 else 1
        q.append(sign * t)
        dq.append(min(max(sign * t * int(deq), -32768), 32767))
    scan_p = _wave_table_part("scan_y" if n == 16 else "scan_c", n * n)
    eob = max([j + 1 for j, p in enumerate(scan_p) if q[p]] + [0])
    y = _model_pass(dq, tabs["idct"], n, 12, True, True, -i0, True)
    y = _model_pass(y, tabs["idct"], n, 12, False, True, -i1, False)
    rec = (pred.reshape(-1) + np.asarray(y)).clip(0, 255) if eob \
        else pred.reshape(-1)
    pos = np.arange(n * n) % n * n + np.arange(n * n) // n   # flat -> position
    coeff = TX.fwd_txfm2d_batched(
        torch.from_numpy((src - pred)[None].astype(np.int32)), tx, c.DCT_DCT)
    np.testing.assert_array_equal(np.asarray(x)[pos], coeff[0].numpy())
    wq, wdq = WT.quantize(coeff, torch.from_numpy(pq.astype(np.int32)), 0,
                          torch.arange(n * n) == 0)
    np.testing.assert_array_equal(np.asarray(q)[pos], wq[0].numpy())
    _, weob = WT.est_bits(wq, torch.tensor(tables.scan(tx, c.DCT_DCT),
                                           dtype=torch.int64))
    assert eob == int(weob[0])
    if spread == 40:
        assert 0 < eob < n * n
    wrec = TX.inv_txfm2d_add_batched(
        wdq, torch.from_numpy(pred[None].astype(np.uint8)), tx, c.DCT_DCT)
    np.testing.assert_array_equal(rec.reshape(n, n), wrec[0].numpy())


def test_wave_encode_checks_dtype_shape_and_device():
    def planes(h=32, w=48, n=1):
        return ([torch.zeros((n, h, w), dtype=torch.uint8)]
                + [torch.zeros((n, h // 2, w // 2), dtype=torch.uint8)
                   for _ in range(2)])
    rows = torch.zeros((1, 6, 390), dtype=torch.int16)
    order = torch.arange(6, dtype=torch.int32)
    pq = torch.ones((3, 5, 2), dtype=torch.int32)
    ok = (rows, *planes(), *planes(), order, 0, 1, pq, 10.0)

    def call(**kw):
        names = ("rows", "ry", "ru", "rv", "src_y", "src_u", "src_v", "order",
                 "start", "count", "pq", "lam")
        return K.wave_encode(*[kw.get(k, v) for k, v in zip(names, ok)])

    assert tuple(call().shape) == (1, 1, 7)
    with pytest.raises(ValueError, match="contiguous .* uint8"):
        call(ry=planes()[0].int())
    with pytest.raises(ValueError, match="multiples of 16"):
        call(src_y=torch.zeros((1, 24, 48), dtype=torch.uint8))
    with pytest.raises(ValueError, match="one 4:2:0 geometry"):
        call(ru=torch.zeros((1, 16, 25), dtype=torch.uint8))
    with pytest.raises(ValueError, match=r"int16 \(1, 6, 390\)"):
        call(rows=torch.zeros((1, 6, 389), dtype=torch.int16))
    with pytest.raises(ValueError, match=r"int32 \(6,\)"):
        call(order=order.long())
    with pytest.raises(ValueError, match="inside order"):
        call(start=4, count=3)
    with pytest.raises(ValueError, match=r"\(3, 5, 2\)"):
        call(pq=pq[:2])
    meta = torch.empty((1, 6, 390), dtype=torch.int16, device="meta")
    with pytest.raises(ValueError, match="expected all on the CPU"):
        call(rows=meta)


def test_wave_encode_on_cpu_tensors_is_its_plain_version():
    """On CPU tensors the wrapper runs wave_encode_plain and launches
    nothing; rows outside the wave's blocks are left alone."""
    rng = np.random.default_rng(8)
    src = [torch.from_numpy(rng.integers(0, 256, s).astype(np.uint8))
           for s in ((2, 32, 48), (2, 16, 24), (2, 16, 24))]
    order_np, offsets = WT.wave_table(2, 3)
    order = torch.from_numpy(order_np)
    pq = torch.from_numpy(np.stack([WT.pq_array(Q.build_plane_quant(90, 0, 0))
                                    ] * 3))
    K.reset_launches()
    sides = []
    for fn in (K.wave_encode, K.wave_encode_plain):
        rows = torch.full((2, 6, 390), -7, dtype=torch.int16)
        recon = [torch.zeros_like(p) for p in src]
        costs = [fn(rows, *recon, *src, order, offsets[d],
                    offsets[d + 1] - offsets[d], pq, 30.0) for d in range(2)]
        sides.append((rows, recon, costs))
    assert all(v == 0 for v in K.LAUNCHES.values())
    assert torch.equal(sides[0][0], sides[1][0])
    for a, b in zip(sides[0][1] + sides[0][2], sides[1][1] + sides[1][2]):
        assert torch.equal(a, b)
    rows = sides[0][0]
    done = order[:offsets[2]].long()
    rest = order[offsets[2]:].long()
    assert (rows[:, rest] == -7).all() and (rows[:, done, 4:6] == 0).all()
    assert set(rows[:, done, 0].flatten().tolist()) <= set(WT.WAVE_MODES)


# ---------------------------------------------------------------------------
# K4's fused entry for the P frames: the tables handed to the residual
# kernel, a numpy model of the kernel's data path run from those tables
# alone, the plain version against the JAX package's composition, and the
# wrapper on the CPU

RESIDUAL_SIZES = ((8, 1), (16, 2), (32, 3), (64, 4))     # n, TX_NxN


def _residual_part(key, size):
    o = K.RESIDUAL_TABLE_OFFSETS[key]
    return K.residual_tables()[o:o + size]


def _residual_params(n):
    s = n.bit_length() - 4
    row = K.residual_tables()[16 * s:16 * s + len(K.RESIDUAL_PARAM_FIELDS)]
    return dict(zip(K.RESIDUAL_PARAM_FIELDS, (int(v) for v in row)))


@pytest.mark.parametrize("n,tx", RESIDUAL_SIZES)
def test_code_residual_tables_stages_scans_and_params(n, tx):
    """The residual kernel's tables: the stage tables of the port's
    common/txfm1d.py (and of the JAX package's) at the cos bits of
    common/txfm2d.py, the scan as positions of the kernel's layout (raster
    index c * s + r at position r * n + c, s = min(n, 32)), the shifts,
    stage counts and log scale, each size's parameter row pointing at its
    parts; and the parts tile the array without overlap."""
    from aom_av1_lavish_tpu.common import txfm1d as RT1
    from aom_av1_lavish_torch.bitstream import constants as c
    from aom_av1_lavish_torch.bitstream import tables
    from aom_av1_lavish_torch.common import coeffs as CF
    from aom_av1_lavish_torch.common import txfm1d as T1
    from aom_av1_lavish_torch.common import txfm2d as T2
    par = _residual_params(n)
    idx = n.bit_length() - 3
    for key, cos_bit, inverse in (
            ("col", T2._FWD_COS_BIT_COL[idx][idx], False),
            ("row", T2._FWD_COS_BIT_ROW[idx][idx], False),
            ("inv", T1.INV_COS_BIT, True)):
        part = f"idct{n}" if inverse else f"fdct{n}_{key}"
        assert par[{"col": "fdct_col", "row": "fdct_row",
                    "inv": "idct"}[key]] == K.RESIDUAL_TABLE_OFFSETS[part]
        for mod in (T1, RT1):
            stages = (mod.idct_stages if inverse
                      else mod.fdct_stages)(n, cos_bit)
            want = np.asarray(stages, np.int64)
            got = _residual_part(part, want.size).reshape(want.shape)
            np.testing.assert_array_equal(got, want)
        assert par["inv_stages" if inverse else "fwd_stages"] == len(stages)
        if not inverse:
            assert par[f"cos_{key}"] == cos_bit
    ns = min(n, 32)
    assert par["n_coef"] == ns * ns
    assert par["scan"] == K.RESIDUAL_TABLE_OFFSETS[f"scan{n}"]
    scan_p = _residual_part(f"scan{n}", ns * ns).astype(np.int64)
    r, cc = scan_p // n, scan_p % n
    assert r.max() < ns and cc.max() < ns
    np.testing.assert_array_equal(cc * ns + r, tables.scan(tx, c.DCT_DCT))
    assert (par["fwd_shift0"], par["fwd_shift1"],
            par["fwd_shift2"]) == T2.FWD_SHIFT[tx]
    assert (par["inv_shift0"], par["inv_shift1"]) == T2.INV_SHIFT[tx]
    assert par["log_scale"] == CF._tx_scale(tx)
    off = K.RESIDUAL_TABLE_OFFSETS
    at = 16 * len(RESIDUAL_SIZES)
    for m, _ in RESIDUAL_SIZES:
        st = _residual_params(m)["fwd_stages"]
        for key, size in ((f"fdct{m}_col", st * m * 5),
                          (f"fdct{m}_row", st * m * 5),
                          (f"idct{m}", st * m * 5),
                          (f"scan{m}", min(m, 32) ** 2)):
            assert off[key] == at
            at += size
    assert off["total"] == at == K.residual_tables().size
    assert K.residual_tables().dtype == np.int32


def _wrap32(v):
    return (np.asarray(v, np.int64) + (1 << 31)) % (1 << 32) - (1 << 31)


def _shift(v, bit):
    """ops/txfm.py _round_shift in int32."""
    if bit > 0:
        return _wrap32(v + (1 << (bit - 1))) >> bit
    return _wrap32(v << -bit) if bit < 0 else v


def _residual_pass(x, tab, cos_bit, along_rows, inverse, post, clamp_out,
                   lines):
    """One 1-D pass of the residual kernel (csrc/code_residual.cu
    txfm_pass) over blocks x (B, n, n) int64, position r * n + c at
    [r, c]; a pass along the rows computes rows < lines."""
    cur = x.copy()
    n = x.shape[-1]
    shape = (1, 1, n) if along_rows else (1, n, 1)
    for s in range(tab.shape[0]):
        kind, s0, s1, w0, w1 = (tab[s, :, k].astype(np.int64)
                                for k in range(5))
        if along_rows:
            a, b = cur[:, :lines][..., s0], cur[:, :lines][..., s1]
        else:
            a, b = cur[:, s0, :], cur[:, s1, :]
        kind, w0, w1 = (v.reshape(shape) for v in (kind, w0, w1))
        btf = _wrap32((a * w0 + b * w1 + (1 << (cos_bit - 1))) >> cos_bit)
        lin = _wrap32(_wrap32(a * w0) + _wrap32(b * w1))
        if inverse:
            lin = lin.clip(-32768, 32767)
        v = np.where(kind == 2, btf, np.where(kind == 1, lin,
                                              _wrap32(a * w0)))
        if s == tab.shape[0] - 1:
            v = _shift(v, post)
            if clamp_out:
                v = v.clip(-32768, 32767)
        if along_rows:
            cur = cur.copy()
            cur[:, :lines] = v
        else:
            cur = v
    return cur


def _residual_model(src, pred, n, pq, lam, dropout):
    """What the residual kernel does to B blocks of side n, from
    residual_tables() alone: int64 numpy for the integer path, numpy
    float32 scalars in the kernel's order for the float decisions (the
    header of csrc/code_residual.cu).  -> (q (B, n_coef) raster, eob,
    rec, bits)."""
    par = _residual_params(n)
    f32 = np.float32
    st, si = par["fwd_stages"], par["inv_stages"]
    tab = {k: _residual_part(f"{k}{n}{sfx}", s * n * 5).reshape(s, n, 5)
           for k, sfx, s in (("fdct", "_col", st), ("idct", "", si))}
    tab["row"] = _residual_part(f"fdct{n}_row", st * n * 5).reshape(st, n, 5)
    ns, ls = min(n, 32), par["log_scale"]
    B = src.shape[0]
    x = _shift(src.astype(np.int64) - pred, -par["fwd_shift0"])
    x = _residual_pass(x, tab["fdct"], par["cos_col"], False, False,
                       -par["fwd_shift1"], False, n)
    x = _residual_pass(x, tab["row"], par["cos_row"], True, False,
                       -par["fwd_shift2"], False, ns)
    per = B // pq.shape[0]
    q = np.zeros((B, n, n), np.int64)
    dq = np.zeros((B, n, n), np.int64)
    for b in range(B):
        p5 = pq[b // per].astype(np.int64)
        for j in (0, 1):                  # DC, then every AC position
            zbin, rnd, quant, qshift, deq = p5[:, j]
            zbin = (zbin + (1 << ls >> 1)) >> ls
            rnd = (rnd + (1 << ls >> 1)) >> ls
            co = x[b, :ns, :ns]
            ac = np.abs(co)
            tmp = _wrap32(ac + rnd).clip(-32768, 32767)
            t = _wrap32(_wrap32(tmp * quant) >> 16) + tmp
            t = np.where(ac >= zbin, _wrap32(_wrap32(t) * qshift)
                         >> (16 - ls), 0)
            sign = np.where(co < 0, -1, 1)
            sel = np.zeros((ns, ns), bool)
            sel[0, 0] = True
            sel = sel if j == 0 else ~sel
            q[b, :ns, :ns][sel] = (sign * t)[sel]
            dq[b, :ns, :ns][sel] = (sign * (_wrap32(t * deq) >> ls))[sel]
    scan = _residual_part(f"scan{n}", ns * ns).astype(np.int64)
    k_sse, inv_ln2 = f32(K.TX_SSE_K[n.bit_length() - 3]), f32(K.INV_LN2)
    eob = np.zeros(B, np.int64)
    bits = np.zeros(B, np.float32)
    for b in range(B):
        qf, dqf = q[b].reshape(-1), dq[b].reshape(-1)
        nz = [j for j in range(ns * ns) if qf[scan[j]]]
        net, lvl, prev = [], [], -1
        for j in nz:
            v = qf[scan[j]]
            l2 = f32(np.log(f32(f32(abs(v)) + f32(1.0)))) * inv_ln2
            lv = f32(f32(1.7) + f32(f32(2.0) * l2))
            ds = f32(dqf[scan[j]])
            save = f32(f32(f32(1.0) + lv) + f32(f32(0.55) * f32(j - prev - 1)))
            net.append(f32(f32(f32(k_sse * ds) * ds)
                           - f32(f32(lam[b]) * save)))
            lvl.append(lv)
            prev = j
        keep = len(nz)
        if dropout:
            s, best, at = f32(0.0), f32(0.0), len(nz)
            for k in range(len(nz) - 1, -1, -1):
                s = f32(s + net[k])
                if s <= best:
                    best, at = s, k
            keep = at if best < 0 else len(nz)
        for j in nz[keep:]:
            qf[scan[j]] = dqf[scan[j]] = 0
        lanes = [f32(0.0)] * 32
        for k in range(keep):
            lanes[k % 32] = f32(lanes[k % 32] + lvl[k])
        for d in (16, 8, 4, 2, 1):
            lanes = [f32(lanes[i] + lanes[i ^ d]) for i in range(32)]
        eob[b] = nz[keep - 1] + 1 if keep else 0
        l2 = f32(np.log(f32(f32(eob[b]) + f32(1.0)))) * inv_ln2
        bb = f32(f32(2.0) + f32(f32(0.9) * l2))
        bb = f32(bb + f32(f32(0.55) * f32(eob[b] - keep)))
        bits[b] = f32(0.6) if eob[b] == 0 else f32(bb + lanes[0])
    y = _residual_pass(dq.clip(-32768, 32767), tab["idct"], 12, True, True,
                       -par["inv_shift0"], True, ns)
    y = _residual_pass(y, tab["idct"], 12, False, True, -par["inv_shift1"],
                       False, n)
    rec = np.where(eob[:, None, None] > 0, (pred + y).clip(0, 255), pred)
    raster = q[:, :ns, :ns].transpose(0, 2, 1).reshape(B, ns * ns)
    return raster, eob, rec.astype(np.uint8), bits


def _residual_blocks(n, seed, B=4):
    """B blocks of side n: a smooth low-frequency residual, noise, a
    bright one (source near 255 over a dark prediction), none."""
    rng = np.random.default_rng(seed)
    rr, cc = np.mgrid[0:n, 0:n]
    pred = rng.integers(0, 256, (B, n, n))
    src = pred.copy()
    src[0] = (pred[0] + np.rint(40 * np.cos(np.pi * (rr + 0.5) / n)
                                * np.cos(np.pi * (cc + 0.5) / n))
              ).clip(0, 255)
    src[1] = (pred[1] + rng.integers(-60, 61, (n, n))).clip(0, 255)
    if B > 2:
        pred[2] = rng.integers(0, 40, (n, n))
        src[2] = rng.integers(215, 256, (n, n))
    return src.astype(np.int32), pred.astype(np.uint8)


def _two_frame_pq(qindex):
    return np.stack([WT.pq_array(Q.build_plane_quant(q, 0, 0))
                     for q in (qindex, qindex + 30)]).astype(np.int32)


@pytest.mark.parametrize("qindex", [20, 100, 200])
@pytest.mark.parametrize("n,tx", RESIDUAL_SIZES)
def test_code_residual_kernel_data_path_model_matches_the_plain_version(
        n, tx, qindex):
    """What the residual kernel does, modelled in numpy from
    residual_tables() alone (its layout, passes, shifts, clamps,
    quantizer with the log scale, dropout, rate estimate, inverse), equals
    code_residual_plain at every size (tx64 keeps its corner), with a
    quantizer a frame over two frames: levels, eob and recon exact, bits
    to 1e-6 relative (their float sums are taken in another order)."""
    src, pred = _residual_blocks(n, n + qindex)
    pq = _two_frame_pq(qindex)
    lam = np.repeat([IT.rd_lambda(qindex), IT.rd_lambda(qindex + 30)], 2) \
        .astype(np.float32)
    for dropout in (True, False):
        want = K.code_residual_plain(
            torch.from_numpy(src), torch.from_numpy(pred), tx,
            torch.from_numpy(pq), torch.from_numpy(lam), dropout)
        got = _residual_model(src, pred, n, pq, lam, dropout)
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(g, w.numpy())
        np.testing.assert_allclose(got[3], want[3].numpy(), rtol=1e-6,
                                   atol=0)
    if qindex == 100:
        assert 0 < got[1][0] < min(n, 32) ** 2   # a smooth block's tail
        assert got[1][3] == 0 and (got[2][3] == pred[3]).all()


@pytest.mark.parametrize("no_dropout", [False, True])
@pytest.mark.parametrize("n,tx", RESIDUAL_SIZES)
def test_code_residual_plain_matches_jax_composition(monkeypatch, n, tx,
                                                     no_dropout):
    """ops/inter._code_residual (kernels.code_residual on CPU tensors)
    against the JAX package's composition of inter_tpu.py:445-473 and
    :703-737 (fwd_txfm2d_batched, _quantize_jnp, _rd_dropout, _est_bits,
    inv_txfm2d_add_batched, the select), eagerly, one frame at a time: 8
    blocks over two frames with their own quantizer and lambda, with
    AVL_NO_DROPOUT unset and set (both read at the call).  Integers equal;
    bits to 2.9e-7 relative (ROADMAP Queue 3, float sums in another
    order)."""
    from aom_av1_lavish_tpu.bitstream import constants as jc
    from aom_av1_lavish_tpu.bitstream import tables
    from aom_av1_lavish_tpu.common import coeffs as JCF
    from aom_av1_lavish_tpu.ops import txfm_jax as TJ

    if no_dropout:
        monkeypatch.setenv("AVL_NO_DROPOUT", "1")
    else:
        monkeypatch.delenv("AVL_NO_DROPOUT", raising=False)
    src, pred = _residual_blocks(n, 3 * n, B=8)
    pred[3] = src[3]                                 # zero residuals
    src[6], pred[6] = 255, 0                         # the brightest
    pq = _two_frame_pq(60)
    lams = [IT.rd_lambda(60), IT.rd_lambda(90)]
    lam = np.repeat(lams, 4).astype(np.float32)
    got = IT._code_residual(torch.from_numpy(src), torch.from_numpy(pred),
                            tx, torch.from_numpy(pq), torch.from_numpy(lam))
    scan = np.asarray(tables.scan(tx, jc.DCT_DCT))
    ns = min(n, 32)
    dc = np.arange(ns * ns) == 0
    for f in range(2):
        sl = slice(4 * f, 4 * f + 4)
        s_, p_ = jnp.asarray(src[sl]), jnp.asarray(pred[sl])
        coeff = TJ.fwd_txfm2d_batched(s_ - p_.astype(jnp.int32), tx,
                                      jc.DCT_DCT)
        qc, dqc = WJ._quantize_jnp(coeff, WJ._PQ(pq[f]),
                                   JCF._tx_scale(tx), dc)
        qc, dqc = IJ._rd_dropout(qc, dqc, scan, np.argsort(scan), lams[f],
                                 tx)
        bits, eob = WJ._est_bits(qc, scan)
        rec = TJ.inv_txfm2d_add_batched(dqc, p_, tx, jc.DCT_DCT)
        rec = jnp.where((eob > 0)[:, None, None], rec, p_)
        for g, w in zip(got[:3], (qc, eob, rec)):
            np.testing.assert_array_equal(g[sl].numpy(), np.asarray(w))
        np.testing.assert_allclose(got[3][sl].numpy(), np.asarray(bits),
                                   rtol=2.9e-7, atol=0)
    eob = got[1].numpy()
    assert eob[3] == 0 and eob[6] > 0
    assert got[2].dtype == torch.uint8 and got[1].dtype == torch.int64


def test_code_residual_on_cpu_launches_nothing_and_checks_arguments():
    """CPU tensors run code_residual_plain and launch nothing; bad
    arguments raise before anything runs."""
    src, pred = _residual_blocks(16, 5)
    pq = torch.from_numpy(_two_frame_pq(80))
    lam = torch.full((4,), 30.0)
    s, p = torch.from_numpy(src), torch.from_numpy(pred)
    K.reset_launches()
    got = K.code_residual(s, p, 2, pq, lam)
    want = K.code_residual_plain(s, p, 2, pq, lam)
    assert all(v == 0 for v in K.LAUNCHES.values()) and not K.ENTRY_LAUNCHES
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    u8 = K.code_residual(s.to(torch.uint8), p, 2, pq, lam)
    for g, w in zip(u8, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="tx must be"):
        K.code_residual(s, p, 0, pq, lam)
    with pytest.raises(ValueError, match=r"src must be int32 or uint8"):
        K.code_residual(s[:, :8, :8], p, 2, pq, lam)
    with pytest.raises(ValueError, match="src must be int32 or uint8"):
        K.code_residual(s.long(), p, 2, pq, lam)
    with pytest.raises(ValueError, match="pred must be uint8"):
        K.code_residual(s, p.int(), 2, pq, lam)
    with pytest.raises(ValueError, match="F dividing B"):
        K.code_residual(s, p, 2, torch.cat([pq, pq[:1]]), lam)
    with pytest.raises(ValueError, match="pq must be int32"):
        K.code_residual(s, p, 2, pq.long(), lam)
    with pytest.raises(ValueError, match=r"lam must be float32 \(4,\)"):
        K.code_residual(s, p, 2, pq, lam[:3])
    meta = torch.empty((4, 16, 16), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="expected all on the CPU"):
        K.code_residual(s, meta, 2, pq, lam)
