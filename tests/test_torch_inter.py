"""Port whole-frame P encode (aom_av1_lavish_torch/ops/inter.py) against
the JAX _p_frame_core on a two-reference 96x64 frame: result rows, the
partition map, the frame filter and the recon must be identical.  Pixels
are kept in 0..90, where every float32 SSD sum of the reference is exact
(ROADMAP F1)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aom_av1_lavish_tpu.common import quant as Q
from aom_av1_lavish_tpu.ops import inter_tpu as IJ
from aom_av1_lavish_torch.ops import inter as IT

H, W = 64, 96


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


def _clip(n=6, seed=3):
    """A panning, textured clip scaled into 0..90."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H + 2 * n, 0:W + 2 * n]
    base = (45 + 30 * np.sin(yy / 9.0) * np.cos(xx / 13.0)
            + rng.normal(0, 3, yy.shape)).clip(0, 90).astype(np.uint8)
    cb = rng.integers(30, 60, ((H + 2 * n) // 2, (W + 2 * n) // 2),
                      dtype=np.uint8)
    return [(np.ascontiguousarray(base[i:i + H, 2 * i:2 * i + W]),
             np.ascontiguousarray(cb[i // 2:i // 2 + H // 2, i:i + W // 2]),
             np.ascontiguousarray(90 - cb[i // 2:i // 2 + H // 2,
                                          i:i + W // 2]))
            for i in range(n)]


@pytest.fixture(scope="module")
def frame_pair():
    frames = _clip()
    src, last, arf = frames[2], frames[1], frames[5]
    q = 120
    pq = IT.pq_array(Q.build_plane_quant(q, 0, 0))
    lam = IT.rd_lambda(q)
    # reference: the chain's per-frame program (2 refs, merge DP, filter
    # pick) on padded references
    refs = [IJ._pad_ref_jnp(*map(jnp.asarray, r)) for r in (last, arf)]
    fn = IJ._p_frame_fn((H, W, 2, True, True))
    out = fn(*map(jnp.asarray, src),
             *(jnp.stack([r[k] for r in refs]) for k in range(4)),
             pq, pq, pq, lam, np.int32(1))
    (hdr, ctr, cfull, rec, lvl, h32, c32, cf32, h64, c64, cf64,
     fsel) = out
    ref = IJ.assemble_group_merge(
        np.asarray(hdr)[None], np.asarray(ctr)[None], cfull[None],
        np.asarray(lvl)[None], np.asarray(h32)[None], np.asarray(c32)[None],
        cf32[None], np.asarray(h64)[None], np.asarray(c64)[None],
        cf64[None])[0]
    ref["filt"] = int(fsel)
    ref["rec"] = np.asarray(rec)
    # port
    prefs = [IT.pad_ref(*map(torch.from_numpy, r)) for r in (last, arf)]
    pt = torch.from_numpy(pq)
    port = IT.p_frame(*map(torch.from_numpy, src),
                      *([r[k] for r in prefs] for k in range(4)),
                      pt, pt, pt, torch.tensor(lam), 1, interp=True)
    return ref, port, refs, prefs


@pytest.mark.parametrize("key", ["r16", "r32", "r64", "lvl"])
def test_p_frame_rows_match_jax(frame_pair, key):
    ref, port, _, _ = frame_pair
    got = port[key].numpy()
    want = np.asarray(ref[key])
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want.astype(got.dtype))


def test_p_frame_recon_and_filter_match_jax(frame_pair):
    ref, port, _, _ = frame_pair
    np.testing.assert_array_equal(port["rec"].numpy(), ref["rec"])
    assert int(port["fsel"]) == ref["filt"]


def test_p_frame_merges_and_uses_both_refs(frame_pair):
    """The case exercises what it claims to: merged leaves and ARF refs."""
    _, port, _, _ = frame_pair
    assert port["r32"].shape[0] == 6 and port["r64"].shape[0] == 1
    assert (port["r16"][:, 2] == 1).any() or (port["r32"][:, 2] == 1).any()


def test_pad_ref_matches_jax(frame_pair):
    _, _, refs, prefs = frame_pair
    for r, p in zip(refs, prefs):
        for a, b in zip(r, p):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_host_helpers_match_reference():
    for q in (0, 60, 120, 255):
        assert IT.rd_lambda(q) == IJ.rd_lambda(q)
    rec = np.arange(24 * 16, dtype=np.uint8).reshape(24, 16)
    for a, b in zip(IT.split_recon(rec, 16, 16),
                    IJ.split_recon(rec, 16, 16)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("no_dropout", [False, True])
@pytest.mark.parametrize("tx", [2, 3, 4])   # TX_16X16, TX_32X32, TX_64X64
def test_rd_dropout_matches_jax(monkeypatch, tx, no_dropout):
    """The RD tail dropout on the same seeded coefficients, the JAX
    function called eagerly: equal levels and dequantized values, with
    AVL_NO_DROPOUT unset (tails cut) and set (nothing dropped).  Both
    packages read the variable at the call: the JAX function itself, the
    port where residual coding takes its dropout flag (ops/inter._dropout),
    which decides whether kernels.rd_dropout_plain runs."""
    from aom_av1_lavish_tpu.bitstream import constants as c
    from aom_av1_lavish_tpu.bitstream import tables
    from aom_av1_lavish_torch.ops import kernels as K

    if no_dropout:
        monkeypatch.setenv("AVL_NO_DROPOUT", "1")
    else:
        monkeypatch.delenv("AVL_NO_DROPOUT", raising=False)
    scan = np.asarray(tables.scan(tx, c.DCT_DCT))
    rng = np.random.default_rng(tx)
    n = scan.size
    qc = (rng.integers(-3, 4, (64, n))
          * (rng.random((64, n)) < 0.2)).astype(np.int32)
    dqc = (qc * rng.integers(20, 90, (64, 1))).astype(np.int32)
    lam = IT.rd_lambda(120)
    ref = IJ._rd_dropout(jnp.asarray(qc), jnp.asarray(dqc), scan,
                         np.argsort(scan), lam, tx)
    st = torch.as_tensor(scan, dtype=torch.int64)
    got = (torch.from_numpy(qc), torch.from_numpy(dqc))
    assert IT._dropout() != no_dropout
    if IT._dropout():
        got = K.rd_dropout_plain(*got, st, torch.argsort(st), lam, tx)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    kept = int(np.count_nonzero(got[0].numpy()))
    assert (kept == np.count_nonzero(qc)) == no_dropout
