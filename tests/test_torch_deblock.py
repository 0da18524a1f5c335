"""Port deblock (aom_av1_lavish_torch/ops/deblock.py) against the JAX
device deblock: exact, on planes made with numpy from a seed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aom_av1_lavish_tpu.ops import deblock_jnp as DJ
from aom_av1_lavish_torch.ops import deblock as DT
from aom_av1_lavish_torch.ops.inter import _leaf_ids


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


def _planes(h, w, seed, blocky):
    rng = np.random.default_rng(seed)
    if blocky:
        # blockwise-flat + noise: exercises the flat/flat2/hev branches
        y = np.kron(rng.integers(0, 256, (h // 16, w // 16)),
                    np.ones((16, 16))).astype(np.int32)
        y = (y + rng.integers(-3, 4, (h, w))).clip(0, 255).astype(np.uint8)
        u = np.kron(rng.integers(0, 256, (h // 16, w // 16)),
                    np.ones((8, 8))).astype(np.int32)
        u = (u + rng.integers(-2, 3, (h // 2, w // 2))).clip(0, 255) \
            .astype(np.uint8)
        v = (255 - u).astype(np.uint8)
    else:
        y = rng.integers(0, 256, (h, w), dtype=np.uint8)
        u = rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8)
        v = rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8)
    return y, u, v


LEVELS = [(0, 0, 0), (8, 4, 6), (30, 20, 0), (63, 63, 63)]


@pytest.mark.parametrize("levels", LEVELS)
@pytest.mark.parametrize("sharpness", [0, 5])
@pytest.mark.parametrize("blocky", [True, False])
def test_deblock_fixed16_matches_jax(levels, sharpness, blocky):
    planes = _planes(64, 96, seed=sum(levels) + sharpness, blocky=blocky)
    got = DT.deblock_fixed16(*map(torch.from_numpy, planes), *levels,
                             sharpness=sharpness)
    want = DJ.deblock_fixed16(*map(jnp.asarray, planes), *levels,
                              sharpness=sharpness)
    for g, w in zip(got, want):
        assert g.dtype == torch.uint8
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("levels", LEVELS[1:])
@pytest.mark.parametrize("seed", [1, 2])
def test_deblock_leafmask_matches_jax(levels, seed):
    """Random {16, 32, 64} partitions of a 128x96 frame: edges inside a
    merged leaf stay untouched, the rest filter as in the reference."""
    H, W = 96, 128
    rng = np.random.default_rng(seed)
    nby, nbx = H // 16, W // 16
    lvl = np.zeros((nby, nbx), np.uint8)
    m32 = rng.integers(0, 2, (nby // 2, nbx // 2)).astype(bool)
    lvl[:nby // 2 * 2, :nbx // 2 * 2][np.kron(m32, np.ones((2, 2),
                                                           bool))] = 1
    m64 = rng.integers(0, 2, (nby // 4, nbx // 4)).astype(bool)
    lvl[:nby // 4 * 4, :nbx // 4 * 4][np.kron(m64, np.ones((4, 4),
                                                           bool))] = 2
    leaf = _leaf_ids(torch.from_numpy(lvl))
    planes = _planes(H, W, seed=10 + seed, blocky=True)
    got = DT.deblock_leafmask(*map(torch.from_numpy, planes), *levels, leaf)
    want = DJ.deblock_leafmask(*map(jnp.asarray, planes), *levels,
                               jnp.asarray(leaf.numpy()))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_leaf_ids_follow_the_partition_map():
    lvl = torch.tensor([[1, 1, 0, 0], [1, 1, 0, 0]], dtype=torch.uint8)
    ids = _leaf_ids(lvl)
    assert ids.tolist() == [[0, 0, 2, 3], [0, 0, 6, 7]]
