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
