"""Learned partition pruning (speed feature).

Re-designs the reference's simple-motion-search / variance partition
MLPs (av1/encoder/partition_strategy.c av1_simple_motion_search_prune_rect,
partition_model_weights.h) with a model trained in-repo on this
encoder's own RD decisions (tools/train_partition_prune.py): features
are source-variance statistics of the block and its quadrants, the
label is whether the RD search chose to split.  Used by the lossy
encoder at speed >= 1 to skip whole RD branches.
"""

from __future__ import annotations

import os

import numpy as np

from .nn import NNConfig, nn_predict

_MODEL = None


def block_features(src_y: np.ndarray, px: int, py: int, size: int,
                   qindex: int) -> np.ndarray:
    """Feature vector for a square luma block at (px, py)."""
    blk = src_y[py:py + size, px:px + size].astype(np.float64)
    h = size // 2
    quads = (blk[:h, :h], blk[:h, h:], blk[h:, :h], blk[h:, h:])
    qvar = np.array([q.var() for q in quads])
    qmean = np.array([q.mean() for q in quads])
    return np.array([
        np.log2(blk.var() + 1.0),
        np.log2(qvar + 1.0).mean(),
        np.log2(qvar + 1.0).std(),
        np.log2(qmean.std() ** 2 + 1.0),
        np.log2(size),
        qindex / 64.0,
    ], np.float32)


N_FEATURES = 6


def _load() -> NNConfig:
    global _MODEL
    if _MODEL is None:
        path = os.path.join(os.path.dirname(__file__), "..", "..",
                            "data", "partition_prune.npz")
        d = np.load(path)
        _MODEL = NNConfig(layers=(
            (d["w1"].astype(np.float32), d["b1"].astype(np.float32)),
            (d["w2"].astype(np.float32), d["b2"].astype(np.float32))))
    return _MODEL


def prob_split(features: np.ndarray) -> float:
    """P(RD search prefers SPLIT) for one block."""
    score = nn_predict(_load(), features)[0, 0]
    return float(1.0 / (1.0 + np.exp(-score)))
