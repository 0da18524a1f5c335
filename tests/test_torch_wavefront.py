"""Port wavefront KEY (aom_av1_lavish_torch/ops/wavefront.py and
encoder/tpu_intra.py) against the JAX wavefront, on inputs made with
numpy from a seed.  Integer outputs are compared exactly.  The float32
rate estimate sums its terms in torch's order, not XLA's, so it is held
to the bound of that reordering: n * 2^-24 relative for n terms."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aom_av1_lavish_tpu.bitstream import constants as c
from aom_av1_lavish_tpu.bitstream import tables
from aom_av1_lavish_tpu.encoder.encoder import make_sequence_header
from aom_av1_lavish_tpu.encoder.lossy import make_lossy_frame_header
from aom_av1_lavish_tpu.encoder.tpu_intra import TpuAllIntraEncoder
from aom_av1_lavish_tpu.ops import wavefront as WJ
from aom_av1_lavish_torch.encoder.tpu_intra import TorchAllIntraEncoder
from aom_av1_lavish_torch.ops import wavefront as WT

W, H = 96, 64


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


def _frame(w, h, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    y = (120 + 60 * np.sin(xx / 17) * np.cos(yy / 23)
         + rng.integers(-4, 5, (h, w))).clip(0, 255).astype(np.uint8)
    u = (128 + 40 * np.sin(xx[::2, ::2] / 31)).clip(0, 255).astype(np.uint8)
    v = rng.integers(100, 160, (h // 2, w // 2)).astype(np.uint8)
    return y, u, v


def test_log2_f32_matches_xla():
    """XLA evaluates log2(x) as log(x) * float32(1/log 2); the port does
    the same with torch.log.  They agree exactly on 1..178 (every level
    and eob below 179) and differ by at most two ulps above (ROADMAP
    Queue 3)."""
    x = np.arange(1, 70000, dtype=np.float32)
    want = np.asarray(jnp.log2(jnp.asarray(x)))
    got = WT.log2_f32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got[:178], want[:178])
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 2


@pytest.mark.parametrize("B", [8, 16])
def test_predict_modes_matches_jax(B):
    rng = np.random.default_rng(B)
    N = 40
    above = rng.integers(0, 256, (N, B)).astype(np.int32)
    left = rng.integers(0, 256, (N, B)).astype(np.int32)
    al = rng.integers(0, 256, N).astype(np.int32)
    top = rng.integers(0, 2, N).astype(bool)
    lft = rng.integers(0, 2, N).astype(bool)
    got = WT.predict_modes(*map(torch.from_numpy, (above, left, al, top,
                                                   lft)), B)
    want = WJ._predict_modes(*map(jnp.asarray, (above, left, al, top, lft)),
                             B)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("tx", [c.TX_8X8, c.TX_16X16])
def test_est_bits_matches_jax(tx):
    n = c.TX_WIDTH[tx] * c.TX_HEIGHT[tx]
    rng = np.random.default_rng(n)
    scan = np.asarray(tables.scan(tx, c.DCT_DCT), np.int64)
    q = np.zeros((300, n), np.int32)
    # nonzeros in the first 128 scan positions, levels up to 170
    for i in range(300):
        k = rng.integers(0, min(n, 128) + 1)
        pos = scan[rng.choice(min(n, 128), size=k, replace=False)]
        q[i, pos] = rng.integers(-170, 171, k)
    bits, eob = WT.est_bits(torch.from_numpy(q), torch.from_numpy(scan))
    wbits, weob = WJ._est_bits(jnp.asarray(q), scan)
    np.testing.assert_array_equal(eob.numpy(), np.asarray(weob))
    assert bits.dtype == torch.float32
    # same terms (log2 exact below 179), summed in another order
    np.testing.assert_allclose(bits.numpy(), np.asarray(wbits),
                               rtol=n * 2.0 ** -24, atol=0)
    # a block with at most one nonzero has nothing to reorder
    one = np.zeros((50, n), np.int32)
    one[np.arange(50), scan[rng.integers(0, n, 50)]] = \
        rng.integers(-170, 171, 50)
    b1, _ = WT.est_bits(torch.from_numpy(one), torch.from_numpy(scan))
    w1, _ = WJ._est_bits(jnp.asarray(one), scan)
    np.testing.assert_array_equal(b1.numpy(), np.asarray(w1))


def test_pq_array_matches_reference():
    from aom_av1_lavish_tpu.common import quant as Q
    for q in (0, 60, 120, 255):
        pq = Q.build_plane_quant(q, 0, 0)
        np.testing.assert_array_equal(WT.pq_array(pq), WJ._pq_array(pq))


@pytest.fixture(scope="module")
def wave_pair():
    """One KEY frame through both wavefront encoders."""
    y, u, v = _frame(W, H, seed=4)
    lam = 0.12 * 30.0 ** 2
    ref = WJ.WavefrontEncoder(100, lam)
    res_j = ref.encode_frame([y, u, v])
    port = WT.WavefrontEncoder(100, lam, device="cpu")
    res_t = port.encode_frame([y, u, v])
    return (res_j, ref), (res_t, port)


def test_wavefront_res390_and_recon_match_jax(wave_pair):
    (_, ref), (_, port) = wave_pair
    np.testing.assert_array_equal(port.res390, ref.res390)
    for a, b in zip(port.recon, ref.recon):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_wavefront_results_match_jax(wave_pair):
    (res_j, _), (res_t, _) = wave_pair
    assert res_j.keys() == res_t.keys()
    for k in res_j:
        for f in ("y_mode", "eoby", "eobu", "eobv"):
            assert res_t[k][f] == res_j[k][f], (k, f)
        for f in ("qy", "qu", "qv"):
            np.testing.assert_array_equal(res_t[k][f], res_j[k][f])


def test_key_frame_payload_and_recon_match_jax():
    """The KEY seam: TorchAllIntraEncoder writes the bytes and recon of
    the reference TpuAllIntraEncoder."""
    planes = _frame(W, H, seed=6)
    sh = make_sequence_header(W, H)
    out = []
    for cls in (TpuAllIntraEncoder, TorchAllIntraEncoder):
        kw = dict(device="cpu") if cls is TorchAllIntraEncoder else {}
        enc = cls(sh, make_lossy_frame_header(sh, 100), **kw)
        out.append((enc.encode_frame(planes),
                    [p.copy() for p in enc.recon]))
    assert out[0][0] == out[1][0]
    for a, b in zip(out[0][1], out[1][1]):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the wave table and kernels.wave_encode (kernel K4's fused entry; on the
# CPU its plain version), wave by wave, against the JAX WavefrontEncoder


@pytest.mark.parametrize("nbr,nbc", [(4, 6), (3, 5), (6, 3), (1, 7), (5, 1),
                                     (68, 120)])
def test_wave_table_covers_every_block_once_in_dependency_order(nbr, nbc):
    order, offsets = WT.wave_table(nbr, nbc)
    assert order.dtype == np.int32
    assert sorted(order.tolist()) == list(range(nbr * nbc))
    assert offsets[0] == 0 and offsets[-1] == nbr * nbc
    assert len(offsets) == nbr + nbc
    wave_of = np.empty(nbr * nbc, np.int64)
    for d in range(nbr + nbc - 1):
        blocks = order[offsets[d]:offsets[d + 1]]
        assert 0 < len(blocks) <= min(nbr, nbc)
        assert (blocks // nbc + blocks % nbc == d).all()
        assert (np.diff(blocks // nbc) > 0).all()       # rows ascending
        wave_of[blocks] = d
    # the blocks a prediction reads from (top, left, top-left) come earlier
    for b in range(nbr * nbc):
        r, x = divmod(b, nbc)
        for dr, dx in ((-1, 0), (0, -1), (-1, -1)):
            if r + dr >= 0 and x + dx >= 0:
                assert wave_of[(r + dr) * nbc + x + dx] < wave_of[b]
    # the reference's geometry: the same blocks in the same waves
    _, _, _, waves, _, _ = WJ.WavefrontEncoder(100, 1.0)._wave_geometry(
        nbr * 16, nbc * 16)
    assert [[r * nbc + x for r, x in w] for w in waves] == \
        [order[offsets[d]:offsets[d + 1]].tolist()
         for d in range(nbr + nbc - 1)]


def _frames(n, w, h, seed):
    return [_frame(w, h, seed=seed + i) for i in range(n)]


WAVE_CASES = {"96x64 N1": (96, 64, 1), "96x64 N3": (96, 64, 3),
              "80x48 N1": (80, 48, 1), "48x80 N3": (48, 80, 3)}


@pytest.fixture(scope="module")
def wave_runs():
    """Each case once: the JAX encoder's frames, and the same frames wave
    by wave through kernels.wave_encode on CPU tensors."""
    from aom_av1_lavish_torch.ops import kernels as K
    cache = {}

    def run(case):
        if case in cache:
            return cache[case]
        w, h, n = WAVE_CASES[case]
        frames = _frames(n, w, h, seed=11)
        lam = 0.12 * 30.0 ** 2
        ref = WJ.WavefrontEncoder(100, lam).encode_frames_raw(frames)
        src = [torch.from_numpy(np.stack([f[i] for f in frames]))
               for i in range(3)]
        recon = [torch.zeros_like(p) for p in src]
        nbr, nbc = h // 16, w // 16
        order_np, offsets = WT.wave_table(nbr, nbc)
        order = torch.from_numpy(order_np)
        pq = torch.from_numpy(np.stack(
            [WT.pq_array(p) for p in WT.WavefrontEncoder(
                100, lam, device="cpu").pq]))
        rows = torch.zeros((n, nbr * nbc, 390), dtype=torch.int16)
        costs = []
        for d in range(nbr + nbc - 1):
            count = offsets[d + 1] - offsets[d]
            cost = K.wave_encode(rows, *recon, *src, order, offsets[d], count,
                                 pq, lam)
            assert cost.dtype == torch.float32
            assert tuple(cost.shape) == (n, count, 7)
            costs.append(cost)
        cache[case] = (ref, rows.numpy(), [p.numpy() for p in recon],
                       torch.cat(costs, 1).numpy(), order_np)
        return cache[case]

    return run


@pytest.mark.parametrize("case", list(WAVE_CASES))
def test_wave_encode_rows_equal_the_jax_encoder(wave_runs, case):
    ref, rows, _, _, _ = wave_runs(case)
    for i, (_, r390, _) in enumerate(ref):
        assert r390.dtype == rows.dtype == np.int16
        np.testing.assert_array_equal(rows[i], r390)


@pytest.mark.parametrize("case", list(WAVE_CASES))
def test_wave_encode_modes_and_eobs_equal_the_jax_encoder(wave_runs, case):
    ref, rows, _, _, _ = wave_runs(case)
    w = WAVE_CASES[case][0]
    for i, (results, _, _) in enumerate(ref):
        assert len(results) == rows.shape[1]
        for (r, x), res in results.items():
            row = rows[i, r * (w // 16) + x]
            assert (row[0], row[1], row[2], row[3]) == \
                (res["y_mode"], res["eoby"], res["eobu"], res["eobv"])
        assert (rows[i, :, 1] > 0).any()       # the clip codes something


@pytest.mark.parametrize("case", list(WAVE_CASES))
def test_wave_encode_recon_equals_the_jax_encoder(wave_runs, case):
    ref, _, recon, _, _ = wave_runs(case)
    for i, (_, _, planes) in enumerate(ref):
        for got, want in zip(recon, planes):
            assert got.dtype == np.uint8
            np.testing.assert_array_equal(got[i], np.asarray(want))


@pytest.mark.parametrize("case", list(WAVE_CASES))
def test_wave_encode_costs_pick_the_coded_mode(wave_runs, case):
    """The costs a wave returns are those its decision was taken on: the
    first minimum over the 7 modes is the mode in the block's row."""
    _, rows, _, costs, order = wave_runs(case)
    assert np.isfinite(costs).all() and (costs > 0).all()
    picked = np.asarray(WT.WAVE_MODES)[costs.argmin(-1)]
    np.testing.assert_array_equal(picked, rows[:, order, 0])


def test_encoder_runs_one_wave_encode_call_a_wave(monkeypatch):
    """encode_frames_raw is the table, one wave_encode call a wave with
    the wave's offset and count, and one fetch."""
    calls = []
    orig = WT.wave_encode

    def spy(rows, *a):
        calls.append((tuple(rows.shape), a[7], a[8]))
        return orig(rows, *a)

    monkeypatch.setattr(WT, "wave_encode", spy)
    WT.WavefrontEncoder(100, 50.0, device="cpu").encode_frames_raw(
        _frames(2, 80, 48, seed=3))
    _, offsets = WT.wave_table(3, 5)
    assert calls == [((2, 15, 390), offsets[d], offsets[d + 1] - offsets[d])
                     for d in range(7)]
