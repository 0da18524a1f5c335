"""Port transforms (aom_av1_lavish_torch/ops/txfm.py) against the JAX
batched transforms and the host engine: exact (tolerance 0), on inputs
made with numpy from a seed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aom_av1_lavish_tpu.bitstream import constants as c
from aom_av1_lavish_tpu.common import txfm2d as T2
from aom_av1_lavish_tpu.ops import txfm_jax as TJ
from aom_av1_lavish_torch.ops import txfm as TX

CASES = [
    (c.TX_4X4, c.DCT_DCT), (c.TX_4X4, c.ADST_ADST), (c.TX_4X4, c.IDTX),
    (c.TX_8X8, c.DCT_DCT), (c.TX_8X8, c.FLIPADST_DCT),
    (c.TX_16X16, c.DCT_DCT), (c.TX_16X16, c.V_DCT),
    (c.TX_16X16, c.FLIPADST_FLIPADST),
    (c.TX_8X16, c.ADST_DCT), (c.TX_16X8, c.DCT_DCT),
    (c.TX_32X32, c.DCT_DCT), (c.TX_64X64, c.DCT_DCT),
    (c.TX_32X64, c.DCT_DCT),
]


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


@pytest.mark.parametrize("ts,tt", CASES)
def test_fwd_matches_jax_and_host(ts, tt):
    rng = np.random.default_rng(100 + ts * 16 + tt)
    h, w = c.TX_HEIGHT[ts], c.TX_WIDTH[ts]
    resid = rng.integers(-255, 256, (6, h, w)).astype(np.int32)
    got = TX.fwd_txfm2d_batched(torch.from_numpy(resid), ts, tt)
    assert got.dtype == torch.int32
    want = np.asarray(TJ.fwd_txfm2d_batched(jnp.asarray(resid), ts, tt))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy()[0],
                                  T2.fwd_txfm2d(resid[0], ts, tt))


@pytest.mark.parametrize("ts,tt", CASES)
def test_inv_matches_jax_and_host(ts, tt):
    rng = np.random.default_rng(200 + ts * 16 + tt)
    h, w = c.TX_HEIGHT[ts], c.TX_WIDTH[ts]
    aw, ah = min(w, 32), min(h, 32)
    coeff = rng.integers(-(1 << 15), 1 << 15, (6, aw * ah)).astype(np.int32)
    pred = rng.integers(0, 256, (6, h, w)).astype(np.uint8)
    got = TX.inv_txfm2d_add_batched(torch.from_numpy(coeff),
                                    torch.from_numpy(pred), ts, tt)
    assert got.dtype == torch.uint8
    want = np.asarray(TJ.inv_txfm2d_add_batched(jnp.asarray(coeff),
                                                jnp.asarray(pred), ts, tt))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy()[0],
                                  T2.inv_txfm2d_add(coeff[0], pred[0], ts,
                                                    tt))


@pytest.mark.parametrize("ts", [c.TX_8X8, c.TX_16X16, c.TX_32X32,
                                c.TX_64X64])
def test_dct_roundtrip_of_real_residuals(ts):
    """The slice's sizes on residual-like data (small values, mostly
    smooth): forward then inverse, both against JAX."""
    rng = np.random.default_rng(300 + ts)
    h, w = c.TX_HEIGHT[ts], c.TX_WIDTH[ts]
    yy, xx = np.mgrid[0:h, 0:w]
    resid = (20 * np.sin(yy / 5.0 + rng.random((5, 1, 1)))
             + rng.integers(-6, 7, (5, h, w))).astype(np.int32)
    coeff = TX.fwd_txfm2d_batched(torch.from_numpy(resid), ts, c.DCT_DCT)
    np.testing.assert_array_equal(
        coeff.numpy(),
        np.asarray(TJ.fwd_txfm2d_batched(jnp.asarray(resid), ts,
                                         c.DCT_DCT)))
    pred = rng.integers(0, 256, (5, h, w)).astype(np.uint8)
    rec = TX.inv_txfm2d_add_batched(coeff, torch.from_numpy(pred), ts,
                                    c.DCT_DCT)
    np.testing.assert_array_equal(
        rec.numpy(),
        np.asarray(TJ.inv_txfm2d_add_batched(jnp.asarray(coeff.numpy()),
                                             jnp.asarray(pred), ts,
                                             c.DCT_DCT)))
