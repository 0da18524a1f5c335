"""The roofline yardstick: the device work an encode needs, by frame kind,
and the card's peaks.

The work is counted from the frame size and each frame's kind and
references, whatever implements it: each plane a kernel family reads is
counted once at its unpadded size, each surface, window, prediction or
coefficient block it writes once, in the narrowest type that holds it.
Launches, padding and the layout of arguments do not enter, so a change
that fuses or re-pads a kernel leaves the yardstick as it is.  Where the
search evaluates candidates whatever the content (the sub-pel refine's
22 a reference), they count; the merge levels' chroma candidates do not,
so the bound is a lower bound.

The algorithm's shapes (the JAX package's inter_tpu / tpl / temporal
filter, which the port follows): 16x16 blocks; per (frame, reference) a
full-resolution SSD surface of radius 16 and one at half resolution (8x8
blocks of 2x2 sums, radius 16), a fused 3x3 refine of nine SSDs, a
half-pel 3x3, quarter-pel 3x3 and eighth-pel diamond (22 predictions);
per frame the consensus snap (left, top and a median a reference), three
interpolation filters (chained GOP frames; not the realtime step), the
chroma predictions, and residual coding at 16x16 (luma 16, chroma 8) and,
with the merge DP, at 32x32 and 64x64 (luma 32 and 64 with its 32x32
corner, chroma 16 and 32).  TPL: for a group of n frames, each non-ARF
frame against the ARF and against its predecessor (2n - 3 surfaces,
radius 8).  The ARF's temporal filter: two neighbours, a radius-8 surface
and the aligned windows of three planes each.  The wavefront KEY: each
16x16 block trials 7 luma modes and codes two 8x8 chroma blocks.

Peaks (one H100 SXM, dense): 3.35e12 B/s of HBM3 and 1979e12 int8
operations/s on the tensor cores (NVIDIA's H100 data sheet); int32
33.45e12 operations/s = 132 SMs x 64 INT32 lanes (NVIDIA H100 Tensor Core
GPU Architecture whitepaper, 2022) x 2 operations an IMAD x 1.98 GHz, the
boost clock at which the data sheet's 67 TFLOP/s of float32 is 132 x 128 x
2 x f.  uint8 operands are held to the int8 peak, everything else to the
int32 one: both give a bound no later kernel can beat.
"""

from __future__ import annotations

import math

MEM_BYTES_PER_S = 3.35e12
OPS_PER_S = {"int8": 1979e12, "int32": 132 * 64 * 2 * 1.98e9}

FULLPEL_RADIUS = 16
TPL_RADIUS = 8
SUBPEL_CANDIDATES = 9 + 9 + 4
INTERP_FILTERS = 3
KEY_LUMA_MODES = 7


def _surface(W, H, bsz, radius, operand):
    """One SSD surface: the two planes read once, B x S^2 int32 written,
    a multiply and an add a pixel and candidate."""
    B = (H // bsz) * (W // bsz)
    S = 2 * radius + 1
    width = 1 if operand == "int8" else 4
    nbytes = 2 * W * H * width + B * S * S * 4
    return nbytes, B * S * S * bsz * bsz * 2, operand


def _transform_ops(n):
    """Operations of one n x n fast 2-D transform, forward or inverse:
    2n one-dimensional transforms of n log2 n operations."""
    return 2 * n * n * int(math.log2(n))


def _residual(B, n):
    """Residual coding of B n x n blocks: source and prediction read,
    levels (int16, tx64 its 32x32 corner), recon and an eob written;
    forward and inverse transforms and 6 operations a coefficient
    (residual, quantizer, recon)."""
    k = min(n, 32)
    nbytes = B * (2 * n * n + 2 * k * k + n * n + 2)
    return nbytes, B * (2 * _transform_ops(n) + 6 * n * n), "int32"


def _predictions(B, n, count):
    """`count` 8-tap predictions of B n x n blocks: written once; a
    separable filter, 8 multiply-adds a pixel over (n + 7) x n then n x n
    (the reference planes are counted with the caller)."""
    ops = (n + 7) * n * 16 + n * n * 16
    return B * n * n * count, B * ops * count, "int32"


def p_frame_work(W, H, n_refs, interp=True, merge=True):
    """[(family, bytes, operations, operand)] of one P frame of the
    chained GOP (2 references, interp, merge), the ARF (1 reference) or
    the realtime step (1 reference, no interp, no merge)."""
    B = (H // 16) * (W // 16)
    out = []
    for _ in range(n_refs):
        out.append(("ssd_surface",) + _surface(W, H, 16, FULLPEL_RADIUS,
                                               "int8"))
        out.append(("ssd_surface",) + _surface(W // 2, H // 2, 8,
                                               FULLPEL_RADIUS, "int32"))
        out.append(("gather_windows", 2 * W * H + B * 9 * 4,
                    B * 9 * 256 * 3, "int8"))
    luma = SUBPEL_CANDIDATES * n_refs + 2 + n_refs \
        + (INTERP_FILTERS if interp else 0)
    nb, ops, kind = _predictions(B, 16, luma)
    out.append(("convolve_8tap", nb + n_refs * W * H, ops, kind))
    nb, ops, kind = _predictions(B, 8, 2)
    out.append(("convolve_8tap", nb + n_refs * W * H // 2, ops, kind))
    levels = [(16, 1)] + ([(32, 4), (64, 16)] if merge else [])
    for n, div in levels:
        out.append(("quantize_b_vec",) + _residual(B // div, n))
        out.append(("quantize_b_vec",) + _residual(2 * (B // div), n // 2))
    return out


def key_work(W, H):
    """[(family, bytes, operations, operand)] of one wavefront KEY."""
    B = (H // 16) * (W // 16)
    per = (KEY_LUMA_MODES * (_transform_ops(16) * 2 + 6 * 256)
           + 2 * (_transform_ops(8) * 2 + 6 * 64))
    return [("quantize_b_vec", B * (384 + 768 + 384), B * per, "int32")]


def lookahead_work(W, H, n):
    """[(family, bytes, operations, operand)] of TPL and the ARF's temporal
    filter for a GF group of n frames."""
    out = []
    if n >= 2:
        out += [("ssd_surface",) + _surface(W, H, 16, TPL_RADIUS, "int8")
                ] * (2 * n - 3)
    if n >= 3:
        for _ in range(2):
            out.append(("ssd_surface",) + _surface(W, H, 16, TPL_RADIUS,
                                                   "int8"))
            out.append(("gather_windows", 3 * W * H, 0, "int8"))
    return out


def bound_s(work) -> float:
    """Least seconds the card could take for these calls: each call's
    larger of bytes over the memory rate and operations over the peak of
    its operand."""
    return sum(max(b / MEM_BYTES_PER_S, o / OPS_PER_S[k])
               for _, b, o, k in work)


def gop_schedule(n, kf_interval, gf_length):
    """[('key', i) | ('gf', start, L)] of an n-frame encode without
    two-pass stats: a KEY every kf_interval frames, GF groups of gf_length
    between (a frozen copy of the port's GopEncoder._build_schedule)."""
    sched, i = [], 0
    while i < n:
        if i % kf_interval == 0:
            sched.append(("key", i))
            i += 1
            continue
        L = min(gf_length, n - i, kf_interval - (i % kf_interval))
        sched.append(("gf", i, L))
        i += L
    return sched


def gop_work(W, H, n, kf_interval, gf_length):
    """The work of one n-frame GOP encode (use_arf, TPL and the temporal
    filter on, the chain on the device) and its counts."""
    work, counts = [], {"frames": n, "keys": 0, "groups": 0, "arfs": 0,
                        "inter": 0}
    for item in gop_schedule(n, kf_interval, gf_length):
        if item[0] == "key":
            work += key_work(W, H)
            counts["keys"] += 1
            continue
        L = item[2]
        counts["groups"] += 1
        work += lookahead_work(W, H, L)
        if L >= 3:
            work += p_frame_work(W, H, 1)
            counts["arfs"] += 1
            counts["inter"] += 1
            work += p_frame_work(W, H, 2) * (L - 1)
            counts["inter"] += L - 1
        else:
            work += p_frame_work(W, H, 1) * L
            counts["inter"] += L
    return work, counts
