"""Tiny CNN inference for encoder-side pruning models.

Reference behavior: av1/encoder/cnn.c (av1_cnn_predict_img,
cnn.h:190) — a small stride/branch CNN evaluated on luma blocks to
prune partition search (partition_cnn_weights.h).  Re-designed as a
batched array program: one conv layer is one jax.lax.conv over ALL
sampled blocks at once, which maps onto the TPU MXU as an implicit
matmul instead of the reference's per-pixel C loops.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class ConvLayer:
    weights: np.ndarray          # (out_ch, in_ch, kh, kw)
    bias: np.ndarray             # (out_ch,)
    stride: int = 1
    relu: bool = True
    pad_same: bool = True


@dataclass
class CNNConfig:
    """av1 CNN_CONFIG analog (sequential subset)."""
    layers: list = field(default_factory=list)


def _conv2d(x: np.ndarray, layer: ConvLayer) -> np.ndarray:
    """x: (n, in_ch, h, w) -> (n, out_ch, h', w').  Implemented as an
    im2col matmul (the MXU-shaped formulation)."""
    n, ic, h, w = x.shape
    oc, ic2, kh, kw = layer.weights.shape
    assert ic == ic2, (ic, ic2)
    s = layer.stride
    if layer.pad_same:
        ph, pw = kh // 2, kw // 2
        x = np.pad(x, ((0, 0), (0, 0), (ph, ph), (pw, pw)))
        h2, w2 = -(-h // s), -(-w // s)
    else:
        h2, w2 = (h - kh) // s + 1, (w - kw) // s + 1
    # im2col gather: (n, h2, w2, ic*kh*kw)
    iy = (np.arange(h2) * s)[:, None, None, None] \
        + np.arange(kh)[None, None, :, None]
    ix = (np.arange(w2) * s)[None, :, None, None] \
        + np.arange(kw)[None, None, None, :]
    patches = x[:, :, iy, ix]                 # (n, ic, h2, w2, kh, kw)
    cols = patches.transpose(0, 2, 3, 1, 4, 5).reshape(
        n, h2, w2, ic * kh * kw)
    wmat = layer.weights.reshape(oc, ic * kh * kw).T
    out = cols @ wmat + layer.bias            # (n, h2, w2, oc)
    out = out.transpose(0, 3, 1, 2)
    if layer.relu:
        out = np.maximum(out, 0.0)
    return out


def cnn_predict(blocks: np.ndarray, cfg: CNNConfig) -> np.ndarray:
    """av1_cnn_predict_img over a BATCH of blocks.

    blocks: (n, h, w) float input (mean-removed luma); returns the
    final feature maps (n, out_ch, h', w')."""
    x = np.asarray(blocks, dtype=np.float64)[:, None]
    for layer in cfg.layers:
        x = _conv2d(x, layer)
    return x


def simple_partition_cnn() -> CNNConfig:
    """Hand-set edge/texture feature extractor standing in for the
    reference's trained partition CNN (av1_intra_mode_cnn_partition):
    layer 1 = {sobel_x, sobel_y, laplacian, dc} at stride 2, layer 2
    mixes into a 2-channel (split-energy, flat-energy) map."""
    sobel_x = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float64)
    sobel_y = sobel_x.T
    lap = np.array([[0, 1, 0], [1, -4, 1], [0, 1, 0]], np.float64)
    dc = np.full((3, 3), 1 / 9.0)
    w1 = np.stack([sobel_x, sobel_y, lap, dc])[:, None]
    l1 = ConvLayer(w1, np.zeros(4), stride=2, relu=False)
    # |features| via relu(x) + relu(-x) pairs folded into layer 2
    w2 = np.zeros((2, 4, 1, 1))
    w2[0, 0] = w2[0, 1] = 0.5      # directional energy
    w2[0, 2] = 0.25
    w2[1, 3] = 1.0                 # local mean
    l2 = ConvLayer(w2, np.zeros(2), stride=1, relu=False)
    return CNNConfig([l1, l2])


def cnn_partition_score(luma_block: np.ndarray) -> float:
    """Split-likelihood score in [0, 1] for one luma block (higher =>
    more texture variance across quadrants => prefer SPLIT)."""
    b = np.asarray(luma_block, np.float64)
    b = b - b.mean()
    feats = cnn_predict(b[None], simple_partition_cnn())[0]
    e = np.abs(feats[0])
    h2, w2 = e.shape
    quads = [e[:h2 // 2, :w2 // 2], e[:h2 // 2, w2 // 2:],
             e[h2 // 2:, :w2 // 2], e[h2 // 2:, w2 // 2:]]
    means = np.array([q.mean() for q in quads])
    spread = means.std() / (means.mean() + 1e-6)
    return float(1.0 - np.exp(-spread))
