"""Tiny fully-connected NN inference (av1/encoder/ml.c analog).

The reference evaluates small float MLPs (NN_CONFIG: dense layers +
ReLU, optional softmax) inside the encoder's speed features.  Here the
same surface is a vectorizable numpy/JAX forward pass — models are
arrays, so the whole batch of blocks can be evaluated in one call on
the device when used inside jitted paths.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class NNConfig:
    """Weights of a dense MLP: list of (W, b) with W shaped (in, out).
    Mirrors NN_CONFIG (av1/encoder/ml.h:33)."""
    layers: tuple

    @property
    def num_inputs(self) -> int:
        return self.layers[0][0].shape[0]

    @property
    def num_outputs(self) -> int:
        return self.layers[-1][0].shape[1]


def nn_predict(cfg: NNConfig, features: np.ndarray) -> np.ndarray:
    """av1_nn_predict: forward pass with ReLU on hidden layers; accepts
    a single feature vector or a batch (N, num_inputs)."""
    x = np.atleast_2d(np.asarray(features, np.float32))
    n_layers = len(cfg.layers)
    for i, (w, b) in enumerate(cfg.layers):
        x = x @ w + b
        if i < n_layers - 1:
            x = np.maximum(x, 0.0)
    return x


def nn_softmax(scores: np.ndarray) -> np.ndarray:
    """av1_nn_softmax (overflow-safe)."""
    s = np.asarray(scores, np.float64)
    s = s - s.max(axis=-1, keepdims=True)
    e = np.exp(s)
    return e / e.sum(axis=-1, keepdims=True)
