#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (aom_av1_lavish_torch) on one GPU.

    python3 chip_smoke.py [--warm N] [--profile] [--before DIR [DIR ...]]

1. Builds the hand-written CUDA kernels (ops/csrc/*.cu) into
   build/torch_kernels/ and holds each kernel entry against its plain
   PyTorch version on the card at the shapes of the 1080p slice,
   requiring exact equality, and times both with CUDA events (and the
   kernel once more from a CUDA graph, without the host).  Each kernel's
   bound (the least time the card could take: its bytes at the
   memory rate or its operations at the peak rate, whichever is larger)
   is computed from the case's tensors.  K4's fused entry wave_encode
   (one wave of the wavefront KEY a launch) is held to its plain version
   too: every integer output exact, the float32 costs to 1e-6 relative.
   The frame-axis forms that a frame-parallel group launches (K1 and K2
   over the 6 P frames' sources against one reference, K4 with a quantizer
   per frame) are also held against one launch a frame, and at one frame
   against the single-frame form.
2. Times the call paths that the plane-form entries of K2 and K3 and the
   fused forms of K1 and K4 replaced (cut windows -> int32 -> ssd_surface;
   gather -> int32 -> convolve_8tap; nine gathers each with its subtract,
   square and sum; a wave as three planes of torch ops around three
   quantizer launches) beside the new forms, in turns, on the same inputs;
   with --before DIR... (checkouts of other commits) also each one's K2
   plane kernel beside this one's at K2's headline shapes.
   Then holds each P-frame program (ops/graphs.DeviceProgram: a CUDA graph
   captured once a key and replayed) at 1920x1088 against its plain
   version, the eager function it captured, on two successive groups of
   inputs, every output bit for bit and one replay's launch counts against
   one eager call's: the ARF (a one-frame chain), the default chain (6 P
   frames), the frame-parallel group (6 P frames), a low-delay P frame and
   two realtime steps; with each program's capture seconds, replay and
   plain milliseconds, device kernel runs and memory.
3. Runs the slice in two configurations: the 8-frame 1920x1088 inter-GOP
   encode of the repo's benchmark clip (KEY + a GF group of 7: hidden ARF
   + 6 chained P frames) with qindex 120 and CDEF off, first at cpu_used 8
   (TPL and the temporal filter off) and then with cpu_used unset, the
   repo's default (TPL and the ARF temporal filter on), each with the
   launch counters reset just before it; every kernel must have launched
   during each, and TPL and the filter must have gone through the plane
   form of K2 and the gather form of K1 only.
4. Encodes both configurations at a smaller size (352x288 at cpu_used 8;
   768x576 for the default, the smallest 4:3 size whose KEY takes the
   wavefront path as it does at 1080p) and decodes the streams with the
   port's decoder; the decoder's reference slots must equal the encoder's
   recon slots byte for byte.

5. Drives the other device paths, each with the launch counters reset just
   before it and read just after, each decoded with the port's decoder
   and held against the encoder's recon (or, lossless, the source):
   the default 1080p GOP with frame-parallel groups (FPMT,
   parallel/sharding.fpmt_encode_group: one launch per kernel entry for
   the group's 6 P frames, so the chained slice's launches less 5 frames'
   of them, and the same bytes on make_mesh(4, 1); then the group alone,
   as one call beside one call a frame, with its peak device memory and
   its results against the frames'), the
   same encode through the CLI (the clip as y4m, apps.enc --tpu --fp-mt 1,
   apps.dec), ShardedLosslessEncoder at 1920x1088 on make_mesh(2, 2), the
   device-RDO KEY in the default configuration at 720x576 and 352x288
   (with the trial sweep of a 720x576 plane timed on its own), low delay
   and realtime at 1920x1088, GOPs with short groups (gf_length 2,
   use_arf off) at 352x288, lossless at 1920x1088, the first pass and the
   two-pass encode at 1920x1088, and the batched all-intra entry at
   1920x1088 with 4 frames beside 1.
6. Runs every one of those paths at 96x64 on the card and on the CPU (and
   the FPMT GOP, ShardedInterGopEncoder and the api.Encoder lossless and
   GOP routes), then the 352x288 cpu_used 8 GOP, on the clip as it is and
   with its luma stretched to 0..255 (where K2's rounding rule takes
   effect, ROADMAP F1), then the 1920x1088 GOP
   at cpu_used 8 and with frame-parallel groups, 4 frames each (a
   wavefront KEY, a hidden ARF and two P frames, chained or as one group):
   the streams must be equal byte for byte (on a difference the first
   differing TU and group result are printed) and the first-pass stats
   equal to 1e-5.

With --warm N each configuration's slice is run N more times and the
stage medians are printed (and N runs of the default configuration with
frame-parallel groups); with --profile one more default-configuration
slice and one with frame-parallel groups run under torch.profiler and the
device time of each hand kernel, the other kernels' runs and the
device-busy share are printed.

Only the port is imported: jax and the JAX package are blocked.  Prints the
card's name and power limit, one JSON line with each kernel's record, and
as its last line {"ok": true, "device": {...}}.  Exits non-zero, before
that line, on any failure, and when no CUDA device is available.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
W, H, N_FRAMES, QINDEX = 1920, 1088, 8, 120
#: the largest frame whose KEY takes the device RDO, padded to the 64-pixel
#: superblock as the trial engine pads it
RDO_W, RDO_H = 768, 576
PADR = 64
KW_DEFAULT = dict(qindex=QINDEX, gf_length=8, use_tpu=True,
                  enable_cdef=False)
KW_CPU8 = dict(KW_DEFAULT, cpu_used=8)
KW_FPMT = dict(KW_DEFAULT, frame_parallel=True)
#: P frames in the frame-parallel group of the 8-frame GOP (KEY, ARF, 6 P)
FPMT_FRAMES = 6
PK = "aom_av1_lavish_tpu/ops/pallas_kernels.py"
CSRC = "aom_av1_lavish_torch/ops/csrc"
#: record name -> (source, the TPU kernel it replaces, the LAUNCHES key its
#: launches count under, the key its own launches are read from).  K1's two
#: entries have a record each (block_ssd_at is its fused form), as have K4's
#: (wave_encode is its fused form for the wavefront KEY): both count under
#: their kernel's LAUNCHES key and are told apart by ENTRY_LAUNCHES
KERNELS = {
    "gather_windows": (f"{CSRC}/gather_windows.cu", f"{PK}:249",
                       "gather_windows", "avl_gather_windows"),
    "block_ssd_at": (f"{CSRC}/gather_windows.cu", f"{PK}:249",
                     "gather_windows", "avl_block_ssd_at"),
    "ssd_surface": (f"{CSRC}/ssd_surface.cu", f"{PK}:143", "ssd_surface",
                    "ssd_surface"),
    "convolve_8tap": (f"{CSRC}/convolve_8tap.cu", f"{PK}:419",
                      "convolve_8tap", "convolve_8tap"),
    "quantize_b_vec": (f"{CSRC}/quantize_b.cu", f"{PK}:343",
                       "quantize_b_vec", "avl_quantize_b"),
    "wave_encode": (f"{CSRC}/wave_encode.cu", f"{PK}:343",
                    "quantize_b_vec", "avl_wave_encode"),
}
#: the device function(s) of each kernel, as a profiler names them
DEVICE_FUNCS = {
    "gather_windows": ("gather_windows_kernel", "gather_flat_kernel",
                       "block_ssd_at_kernel"),
    "ssd_surface": ("ssd_plane_kernel", "ssd_surface_kernel"),
    "convolve_8tap": ("conv8_plane_kernel", "convolve_8tap_kernel"),
    "quantize_b_vec": ("quantize_b_kernel", "wave_encode_kernel"),
}
# Published peaks of one H100 SXM (NVIDIA's data sheet, dense): device
# memory rate, and operations per second by operand type.  int32 is not in
# the data sheet; it runs on the CUDA cores, so it gets their float32 rate,
# which it cannot exceed.
MEM_BYTES_PER_S = 3.35e12
OPS_PER_S = {"uint8": 1979e12, "int32": 67e12}


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20) -> float:
    """Mean milliseconds per call on the card (CUDA events, warmed up)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def graph_ms(fn, reps: int = 20) -> float:
    """Mean milliseconds per call with the host taken out: `reps` calls are
    captured into one CUDA graph and the graph's replay is timed.  For a
    kernel that runs for less time than its wrapper takes to enqueue it,
    this is the kernel's own time where cuda_ms gives the host's."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def key_lambda(w: int, h: int, qindex: int) -> float:
    """The RD multiplier the wavefront KEY of a w x h frame codes with."""
    from aom_av1_lavish_torch.encoder.encoder import make_sequence_header
    from aom_av1_lavish_torch.encoder.lossy import (LossyAllIntraEncoder,
                                                    make_lossy_frame_header)
    sh = make_sequence_header(w, h)
    return LossyAllIntraEncoder(sh, make_lossy_frame_header(sh, qindex)).lam


def wave_work(n_frames: int, count: int):
    """(bytes, integer operations) of one wave_encode call on `count`
    blocks of `n_frames` frames.  Bytes: a block reads its source (256 +
    2 x 64), its edges (33 + 2 x 17) and its index, and writes its recon,
    its (390,) int16 row and 7 float32 costs; a call reads the tables and
    the quantizer parameters once.  Operations: the butterflies of the
    stage tables as the interpreter runs them (5 a rotation: two
    multiplies, two adds, a shift; 1 an add/sub, 3 with the inverse's
    clamp), four 1-D passes over each of the 7 luma and 2 chroma blocks,
    and 46 a position around them (prediction 8, residual and shifts 4,
    quantizer 16, rate estimate 6, inverse shifts and clamps 6, recon 3,
    SSE 3)."""
    import numpy as np

    from aom_av1_lavish_torch.ops import kernels as K
    tab, off = K.wave_tables(), K.WAVE_TABLE_OFFSETS
    per_block = 0
    for n, blocks in ((16, 7), (8, 2)):
        stages = int(tab[off[f"params{n}"] + 7])
        ops = 0
        for key, inverse in ((f"fdct{n}_col", 0), (f"fdct{n}_row", 0),
                             (f"idct{n}", 1), (f"idct{n}", 1)):
            kind = tab[off[key]:off[key] + stages * n * 5].reshape(-1, 5)[:, 0]
            ops += n * int(5 * np.sum(kind == 2)
                           + (1 + 2 * inverse) * np.sum(kind == 1))
        per_block += blocks * (ops + 46 * n * n)
    nbytes = (n_frames * count * (384 + 67 + 384 + 780 + 28) + 4 * count
              + 4 * off["total"] + 120)
    return nbytes, n_frames * count * per_block


def _wave_cases(dev):
    """wave_encode at the KEY's shapes: the longest wave of a 1080p frame
    (68 blocks) for 1 and for 4 frames, its first wave (1 block), and the
    longest wave of a 768x576 frame (36 blocks).  The source is the
    benchmark clip; the recon the waves before would have left is the
    source with noise of a coded frame's size."""
    import numpy as np
    import torch

    from aom_av1_lavish_torch.common import quant as Q
    from aom_av1_lavish_torch.ops.wavefront import pq_array, wave_table
    from aom_av1_lavish_torch.utils.clips import make_frames

    rng = np.random.default_rng(5)
    pq = torch.as_tensor(np.stack([pq_array(Q.build_plane_quant(QINDEX, 0, 0))
                                   ] * 3), device=dev)
    cases = []
    for w, h, n_frames, wave, what in (
            (W, H, 1, 67, "longest wave"), (W, H, 4, 67, "longest wave"),
            (W, H, 1, 0, "first wave"), (RDO_W, RDO_H, 1, 35,
                                         "longest wave")):
        frames = make_frames(n_frames, w, h)
        src = [torch.as_tensor(np.stack([f[i] for f in frames]), device=dev)
               for i in range(3)]
        recon = [(p.to(torch.int16) + torch.as_tensor(
            rng.integers(-6, 7, tuple(p.shape)).astype(np.int16),
            device=dev)).clamp(0, 255).to(torch.uint8) for p in src]
        order, offsets = wave_table(h // 16, w // 16)
        start, count = offsets[wave], offsets[wave + 1] - offsets[wave]
        rows = torch.zeros((n_frames, len(order), 390), dtype=torch.int16,
                           device=dev)
        nbytes, ops = wave_work(n_frames, count)
        cases.append(("wave_encode", "wave_encode",
                      f"{w}x{h} {what}: {count} blocks x {n_frames} frame(s)",
                      (rows, *recon, *src, torch.as_tensor(order, device=dev),
                       start, count, pq, key_lambda(w, h, QINDEX)),
                      (ops, "int32"), nbytes))
    return cases


def run_case(K, fn: str, args):
    """-> (got, want): the result tensors of the wrapper `K.<fn>` and of
    its plain version on `args`.  wave_encode writes into its first four
    arguments (rows and recon planes), so each side gets its own copies and
    they count as results beside the costs it returns."""
    out = []
    for f in (getattr(K, fn), getattr(K, fn + "_plain")):
        if fn == "wave_encode":
            mine = [a.clone() for a in args[:4]]
            out.append((*mine, f(*mine, *args[4:])))
        else:
            res = f(*args)
            out.append(res if isinstance(res, tuple) else (res,))
    return out


def wave_error(got, want, args):
    """wave_encode against its plain version -> (max abs difference of the
    integer outputs, max relative difference of the costs, blocks whose
    two lowest costs lie within 1e-6 relative and whose mode differs).
    Such a block's outputs are left out of the integer comparison; any
    other difference counts."""
    order, start, count = args[7], args[8], args[9]
    bid = order[start:start + count].long()
    cg, cw = got[4], want[4]
    rel = float(((cg - cw).abs() / cw.abs().clamp_min(1.0)).max())
    low = cw.sort(-1).values
    near = (low[..., 1] - low[..., 0]) <= 1e-6 * low[..., 1].abs()
    flipped = got[0][:, bid, 0] != want[0][:, bid, 0]         # (N, count)
    if bool((flipped & ~near).any()):
        return float("inf"), rel, int(flipped.sum())
    err = 0.0
    keep = (~flipped)[..., None]
    d = (got[0][:, bid].int() - want[0][:, bid].int()).abs() * keep
    err = max(err, float(d.max()))
    for g, w, b in zip(got[1:4], want[1:4], (16, 8, 8)):
        n, hh, ww = g.shape
        d = (g.int() - w.int()).abs().reshape(n, hh // b, b, ww // b, b) \
            .amax((2, 4)).reshape(n, -1)                      # per block
        d[:, bid] *= ~flipped
        err = max(err, float(d.max()))
    return err, rel, int(flipped.sum())


def ssd_ops(n_blk, bsz, r, kind):
    """K2's operations: the correlation C = sum(s*w), a multiply and an add
    per pixel pair; W2 and S2, box sums of squares, are a few operations a
    window pixel and are left out."""
    return 2 * n_blk * (2 * r + 1) ** 2 * bsz * bsz, kind


def _cases(dev):
    """(kernel name, wrapper name, label, args, operations[, bytes]) at
    the slice's shapes, made from a seed; the wrapper `K.<wrapper name>`
    and its plain version `K.<wrapper name>_plain` take the same args.
    `operations` is (count, operand type) of the integer operations the
    function does on these inputs; `bytes`, where given, what the function
    must move when that is not the size of its tensors.  The first case of
    a kernel is its headline: the entry and shape the slice calls most."""
    import numpy as np
    import torch

    from aom_av1_lavish_torch.common import interpred as IP
    from aom_av1_lavish_torch.common import quant as Q
    from aom_av1_lavish_torch.ops.wavefront import pq_array

    rng = np.random.default_rng(0)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    cases = []
    nby, nbx = H // 16, W // 16
    B = nby * nbx

    # K2 from planes: the full-res (uint8, bsz 16) and half-res (int32 2x2
    # sums, bsz 8) surfaces of a PADR-padded 1080p reference, r 16,
    # ordinary and bright inputs; then grids whose width is no multiple
    # of the kernel's block group and whose addresses are not 16-byte
    # aligned, and the other dtype at each block size.  The bright inputs
    # take both branches of the surface's rounding rule (ssd_surface.cu):
    # uint8 240..255 and int32 350..510 at bsz 8 keep S2, W2 and C below
    # 2^24 (R(S2 + W2) - 2C), int32 960..1020 at bsz 8 puts S2 and W2
    # above it (the exact SSD)
    for dtype, bsz, lo, hi in ((np.uint8, 16, 0, 256),
                               (np.uint8, 16, 240, 256),
                               (np.int32, 8, 0, 1021),
                               (np.int32, 8, 350, 511),
                               (np.int32, 8, 960, 1021)):
        sc = 16 // bsz
        src = t(rng.integers(lo, hi, (H // sc, W // sc)).astype(dtype))
        ref = t(rng.integers(lo, hi, ((H + 2 * PADR) // sc,
                                      (W + 2 * PADR) // sc)).astype(dtype))
        o = PADR // sc - 16
        cases.append(("ssd_surface", "ssd_surface_plane",
                      f"plane {np.dtype(dtype).name} bsz{bsz} r16 "
                      f"px{lo}..{hi - 1} B{B}",
                      (src, ref, nby, nbx, bsz, 16, o, o),
                      ssd_ops(B, bsz, 16, np.dtype(dtype).name)))
    for dtype, bsz, r, gy, gx, oy, ox in ((np.uint8, 16, 16, 5, 7, 3, 5),
                                          (np.int32, 8, 16, 5, 7, 3, 5),
                                          (np.uint8, 8, 8, 9, 13, 0, 1),
                                          (np.int32, 16, 8, 4, 6, 2, 2)):
        hi = 256 if dtype == np.uint8 else 1021
        Wn = 2 * r + bsz
        src = t(rng.integers(0, hi, (gy * bsz + 3, gx * bsz + 5))
                .astype(dtype))
        ref = t(rng.integers(0, hi, (oy + (gy - 1) * bsz + Wn + 2,
                                     ox + (gx - 1) * bsz + Wn + 3))
                .astype(dtype))
        cases.append(("ssd_surface", "ssd_surface_plane",
                      f"plane {np.dtype(dtype).name} bsz{bsz} r{r} "
                      f"grid{gy}x{gx} unaligned",
                      (src, ref, gy, gx, bsz, r, oy, ox),
                      ssd_ops(gy * gx, bsz, r, np.dtype(dtype).name)))
    # K2 from planes at the shape of TPL and the temporal filter: bsz 16,
    # r 8, the reference edge-padded by 8
    src = t(rng.integers(0, 256, (H, W)).astype(np.uint8))
    ref = t(rng.integers(0, 256, (H + 16, W + 16)).astype(np.uint8))
    cases.append(("ssd_surface", "ssd_surface_plane",
                  f"plane uint8 bsz16 r8 pad8 B{B}",
                  (src, ref, nby, nbx, 16, 8, 0, 0),
                  ssd_ops(B, 16, 8, "uint8")))
    # K2 from windows (the entry the Pallas kernels had)
    for bsz, r, lo, hi in ((16, 16, 0, 256), (16, 16, 240, 256),
                           (8, 16, 0, 1021), (8, 16, 350, 511),
                           (8, 16, 960, 1021), (16, 8, 0, 256)):
        Wn = 2 * r + bsz
        src = t(rng.integers(lo, hi, (B, bsz, bsz)).astype(np.int32))
        win = t(rng.integers(lo, hi, (B, Wn, Wn)).astype(np.int32))
        cases.append(("ssd_surface", "ssd_surface",
                      f"windows bsz{bsz} r{r} px{lo}..{hi - 1} B{B}",
                      (src, win, bsz, r), ssd_ops(B, bsz, r, "int32")))

    filt = np.concatenate([np.asarray(IP.SUBPEL_FILTERS_8),
                           np.asarray(IP.SUBPEL_FILTERS_8SMOOTH),
                           np.asarray(IP.SUBPEL_FILTERS_8SHARP)])

    def taps(n_blk):
        return (t(filt[rng.integers(0, len(filt), n_blk)].astype(np.int32)),
                t(filt[rng.integers(0, len(filt), n_blk)].astype(np.int32)))

    def conv_ops(n_blk, n, kind):
        # 8 multiply-adds per horizontal and per vertical output
        return 2 * 8 * n_blk * ((n + 7) * n + n * n), kind

    # K3 from a plane: luma 16/32/64 and chroma 8/16/32 blocks of a padded
    # 1080p plane, origins anywhere inside it; then origins that hit the
    # clamp on every side
    plane = t(rng.integers(0, 256, (H + 2 * PADR, W + 2 * PADR))
              .astype(np.uint8))
    for n, nb in ((16, 8160), (8, 8160), (32, 2040), (16, 2040),
                  (64, 510), (32, 510)):
        br = t(rng.integers(0, H + 2 * PADR - n - 7, nb).astype(np.int32))
        bc = t(rng.integers(0, W + 2 * PADR - n - 7, nb).astype(np.int32))
        cases.append(("convolve_8tap", "convolve_8tap_plane",
                      f"plane {n}x{n} B{nb}",
                      (plane, br, bc, *taps(nb), n, n),
                      conv_ops(nb, n, "uint8")))
    small = t(rng.integers(0, 256, (90, 117)).astype(np.uint8))
    for n in (8, 16, 32, 64):
        br = t(rng.integers(-n - 20, 90 + 20, 301).astype(np.int32))
        bc = t(rng.integers(-n - 20, 117 + 20, 301).astype(np.int32))
        cases.append(("convolve_8tap", "convolve_8tap_plane",
                      f"plane {n}x{n} B301 clamped origins",
                      (small, br, bc, *taps(301), n, n),
                      conv_ops(301, n, "uint8")))
    # K3 from int32 regions
    for n, nb in ((16, 8160), (8, 8160), (32, 2040), (16, 2040),
                  (64, 510), (32, 510)):
        region = t(rng.integers(0, 256, (nb, n + 7, n + 7)).astype(np.int32))
        cases.append(("convolve_8tap", "convolve_8tap",
                      f"regions {n}x{n} B{nb}", (region, *taps(nb), n, n),
                      conv_ops(nb, n, "int32")))
    # K1, gather form: the temporal filter's aligned luma blocks, MC
    # regions, chroma regions; uint8 and int32 planes of a PADR-padded
    # 1080p reference; then the filter's 8x8 chroma blocks of two
    # neighbours, and origins that hit the clamp on every side
    for dtype, wn, nb in ((np.uint8, 16, 8160), (np.uint8, 23, 8160),
                          (np.uint8, 15, 8160), (np.uint8, 39, 2040),
                          (np.uint8, 71, 510), (np.int32, 25, 8160)):
        pl = t(rng.integers(0, 256, (H + 128, W + 128)).astype(dtype))
        br = t(rng.integers(0, H + 128 - wn, nb).astype(np.int32))
        bc = t(rng.integers(0, W + 128 - wn, nb).astype(np.int32))
        cases.append(("gather_windows", "gather_windows",
                      f"{np.dtype(dtype).name} {wn}x{wn} B{nb}",
                      (pl, br, bc, wn, wn), (0, "uint8")))
    pl = t(rng.integers(0, 256, (H // 2 + 16, W // 2 + 16)).astype(np.uint8))
    br = t(rng.integers(0, H // 2 + 8, 2 * B).astype(np.int32))
    bc = t(rng.integers(0, W // 2 + 8, 2 * B).astype(np.int32))
    cases.append(("gather_windows", "gather_windows",
                  f"uint8 8x8 B{2 * B} (chroma, two neighbours)",
                  (pl, br, bc, 8, 8), (0, "uint8")))
    for dtype, wn in ((np.uint8, 16), (np.uint8, 23), (np.int32, 9)):
        pl = t(rng.integers(0, 256, (90, 117)).astype(dtype))
        br = t(rng.integers(-wn - 20, 90 + 20, 301).astype(np.int32))
        bc = t(rng.integers(-wn - 20, 117 + 20, 301).astype(np.int32))
        cases.append(("gather_windows", "gather_windows",
                      f"{np.dtype(dtype).name} {wn}x{wn} B301 clamped "
                      "origins", (pl, br, bc, wn, wn), (0, "uint8")))

    # K1, fused form: SSD of every source block at C candidate origins in
    # the padded reference.  3x3 neighbourhoods around a centre within the
    # search range (the refine's shape) at bsz 16 and 8, bright pixels,
    # candidates scattered over the plane, and neighbourhoods around
    # centres on and off a small plane whose width is no multiple of 16
    def at_ops(n_blk, n_cand, bsz):
        return 3 * n_blk * n_cand * bsz * bsz, "uint8"

    off = np.array([-1, 0, 1])
    oy9, ox9 = np.repeat(off, 3), np.tile(off, 3)
    for bsz, lo, hi in ((16, 0, 256), (8, 0, 256), (16, 240, 256)):
        src = t(rng.integers(lo, hi, (nby * bsz, nbx * bsz)).astype(np.uint8))
        ref = t(rng.integers(lo, hi, (nby * bsz + 2 * PADR,
                                      nbx * bsz + 2 * PADR)).astype(np.uint8))
        y0 = np.repeat(np.arange(nby), nbx) * bsz
        x0 = np.tile(np.arange(nbx), nby) * bsz
        cy = PADR + y0 + rng.integers(-32, 33, B)
        cx = PADR + x0 + rng.integers(-32, 33, B)
        cases.append(("block_ssd_at", "block_ssd_at",
                      f"bsz{bsz} 3x3 px{lo}..{hi - 1} B{B}",
                      (src, ref, t((cy[:, None] + oy9).astype(np.int32)),
                       t((cx[:, None] + ox9).astype(np.int32)), nby, nbx,
                       bsz), at_ops(B, 9, bsz)))
    src = t(rng.integers(0, 256, (H, W)).astype(np.uint8))
    ref = t(rng.integers(0, 256, (H + 2 * PADR, W + 2 * PADR))
            .astype(np.uint8))
    cases.append(("block_ssd_at", "block_ssd_at",
                  f"bsz16 9 scattered candidates B{B}",
                  (src, ref,
                   t(rng.integers(0, H + 2 * PADR - 16, (B, 9))
                     .astype(np.int32)),
                   t(rng.integers(0, W + 2 * PADR - 16, (B, 9))
                     .astype(np.int32)), nby, nbx, 16), at_ops(B, 9, 16)))
    for bsz, n_cand in ((16, 9), (8, 9), (16, 5), (8, 35)):
        gy, gx = 5, 7
        src = t(rng.integers(0, 256, (gy * bsz + 3, gx * bsz + 5))
                .astype(np.uint8))
        ref = t(rng.integers(0, 256, (90, 117)).astype(np.uint8))
        cy = rng.integers(-bsz - 20, 90 + 20, gy * gx)
        cx = rng.integers(-bsz - 20, 117 + 20, gy * gx)
        dy = rng.integers(-2, 3, (gy * gx, n_cand))
        dx = rng.integers(-2, 3, (gy * gx, n_cand))
        cases.append(("block_ssd_at", "block_ssd_at",
                      f"bsz{bsz} C{n_cand} clamped origins unaligned "
                      f"B{gy * gx}",
                      (src, ref, t((cy[:, None] + dy).astype(np.int32)),
                       t((cx[:, None] + dx).astype(np.int32)), gy, gx, bsz),
                      at_ops(gy * gx, n_cand, bsz)))
    # K4: real quantizer params (qindex 120) and random ones that make the
    # int32 products wrap, at n = 64, 256, 1024
    pq = pq_array(Q.build_plane_quant(QINDEX, 0, 0))
    for n, rows, log_scale in ((256, 8160, 0), (64, 16320, 0),
                               (1024, 2040, 1), (1024, 510, 2)):
        # abs, compare, add, clamp x2, 3 multiplies, 2 adds, 3 shifts,
        # select, 2 sign multiplies
        ops = (16 * rows * n, "int32")
        coeff = t(rng.integers(-(1 << 15), 1 << 15, (rows, n))
                  .astype(np.int32))
        dc = np.arange(n) == 0
        par = [t(np.where(dc, row[0], row[1]).astype(np.int32))
               for row in pq]
        cases.append(("quantize_b_vec", "quantize_b_vec",
                      f"n{n} rows{rows} q{QINDEX}",
                      (coeff, *par, log_scale), ops))
        par = [t(rng.integers(a, b, n).astype(np.int32))
               for a, b in ((20, 1000), (10, 500), (1 << 12, 1 << 16),
                            (1 << 14, 1 << 16), (4, 7000))]
        coeff = t(rng.integers(-(1 << 20), 1 << 20, (rows, n))
                  .astype(np.int32))
        cases.append(("quantize_b_vec", "quantize_b_vec",
                      f"n{n} rows{rows} random-params",
                      (coeff, *par, log_scale), ops))
    # K4 at the shapes of the device-RDO trials of a 720x576 KEY (the plane
    # padded to 768x576; every block of a geometry under all 61 modes in
    # one launch: 4x4, 8x8, 16x8, 16x16, 32x16, 32x32, 64x32, 64x64), of
    # its chroma DC trials (one mode), and of one wave of the batched
    # all-intra entry at 1080p (4 frames x the longest wave's 68 blocks x 7
    # modes, and its chroma)
    for n, rows, log_scale, what in (
            [(bw * bh if bw * bh < 1024 else 1024,
              RDO_W // bw * (RDO_H // bh) * 61, ls, f"rdo {bw}x{bh} x61")
             for bw, bh, ls in ((4, 4, 0), (8, 8, 0), (16, 8, 0),
                                (16, 16, 0), (32, 16, 1), (32, 32, 1),
                                (64, 32, 2), (64, 64, 2))]
            + [(64, RDO_W // 16 * (RDO_H // 16), 0, "rdo chroma 8x8 dc"),
               (256, 4 * 68 * 7, 0, "intra batch 4 frames, wave of 68 x7"),
               (64, 4 * 68, 0, "intra batch 4 frames, chroma wave")]):
        coeff = t(rng.integers(-(1 << 15), 1 << 15, (rows, n))
                  .astype(np.int32))
        dc = np.arange(n) == 0
        par = [t(np.where(dc, row[0], row[1]).astype(np.int32))
               for row in pq]
        cases.append(("quantize_b_vec", "quantize_b_vec",
                      f"n{n} rows{rows} ls{log_scale} ({what})",
                      (coeff, *par, log_scale), (16 * rows * n, "int32")))
    return cases + _frame_axis_cases(dev, rng) + _wave_cases(dev)


def _frame_axis_cases(dev, rng):
    """The frame-axis forms that a 1080p frame-parallel group launches,
    with its FPMT_FRAMES P frames: K2's full-res (uint8, bsz 16) and
    half-res (int32 2x2 sums, bsz 8) surfaces of every frame's source
    against one padded reference, K1's 3x3 refine of every frame's blocks,
    and K4 with a quantizer per frame (qindex 100 + 10 f) at the shapes of
    the luma and chroma 16x16 level and the 32 and 64 merge levels (luma
    and chroma).  Their
    labels carry " F<frames> " (phase_kernels holds each against one
    launch a frame)."""
    import numpy as np
    import torch

    from aom_av1_lavish_torch.common import quant as Q
    from aom_av1_lavish_torch.ops.wavefront import pq_array

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    nf = FPMT_FRAMES
    nby, nbx = H // 16, W // 16
    B = nby * nbx
    cases = []
    src = t(rng.integers(0, 256, (nf, H, W)).astype(np.uint8))
    ref = t(rng.integers(0, 256, (H + 2 * PADR, W + 2 * PADR))
            .astype(np.uint8))
    cases.append(("ssd_surface", "ssd_surface_plane",
                  f"plane uint8 bsz16 r16 F{nf} B{B}",
                  (src, ref, nby, nbx, 16, 16, PADR - 16, PADR - 16),
                  ssd_ops(nf * B, 16, 16, "uint8")))
    src_h = t(rng.integers(0, 1021, (nf, H // 2, W // 2)).astype(np.int32))
    ref_h = t(rng.integers(0, 1021, ((H + 2 * PADR) // 2,
                                     (W + 2 * PADR) // 2)).astype(np.int32))
    cases.append(("ssd_surface", "ssd_surface_plane",
                  f"plane int32 bsz8 r16 F{nf} B{B}",
                  (src_h, ref_h, nby, nbx, 8, 16, PADR // 2 - 16,
                   PADR // 2 - 16), ssd_ops(nf * B, 8, 16, "int32")))
    off = np.array([-1, 0, 1])
    y0 = np.repeat(np.arange(nby), nbx) * 16
    x0 = np.tile(np.arange(nbx), nby) * 16
    cy = PADR + y0 + rng.integers(-32, 33, (nf, B))
    cx = PADR + x0 + rng.integers(-32, 33, (nf, B))
    cases.append(("block_ssd_at", "block_ssd_at", f"bsz16 3x3 F{nf} B{B}",
                  (src, ref,
                   t((cy[..., None] + np.repeat(off, 3)).astype(np.int32)),
                   t((cx[..., None] + np.tile(off, 3)).astype(np.int32)),
                   nby, nbx, 16), (3 * nf * B * 9 * 256, "uint8")))
    pqs = [pq_array(Q.build_plane_quant(100 + 10 * f, 0, 0))
           for f in range(nf)]
    for n, rows, log_scale in ((256, B, 0), (64, B, 0), (1024, B // 4, 1),
                               (256, B // 4, 0), (1024, B // 16, 2)):
        dc = np.arange(n) == 0
        par = [t(np.stack([np.where(dc, pq[i][0], pq[i][1]) for pq in pqs])
                 .astype(np.int32)) for i in range(5)]
        coeff = t(rng.integers(-(1 << 15), 1 << 15, (nf, rows, n))
                  .astype(np.int32))
        cases.append(("quantize_b_vec", "quantize_b_vec",
                      f"n{n} rows{rows} F{nf} q per frame",
                      (coeff, *par, log_scale),
                      (16 * nf * rows * n, "int32")))
    return cases


def frame_args(fn: str, args, sl):
    """The arguments of a frame-axis case cut to the frames `sl` (an int:
    one frame, in the single-frame form)."""
    if fn == "ssd_surface_plane":
        return (args[0][sl], *args[1:])
    if fn == "block_ssd_at":
        return (args[0][sl], args[1], args[2][sl], args[3][sl], *args[4:])
    return (args[0][sl], *(p[sl] for p in args[1:6]), args[6])


def check_frame_axis(K, fn: str, label: str, args) -> None:
    """A frame-axis case on the card: its launch equals one launch a frame
    of the single-frame form, stacked, and its first frame cut as a batch
    of one equals that frame's single-frame launch."""
    import torch

    wrapper = getattr(K, fn)
    got = wrapper(*args)
    got = got if isinstance(got, tuple) else (got,)
    per = [wrapper(*frame_args(fn, args, f)) for f in range(FPMT_FRAMES)]
    per = [p if isinstance(p, tuple) else (p,) for p in per]
    one = wrapper(*frame_args(fn, args, slice(0, 1)))
    one = one if isinstance(one, tuple) else (one,)
    for i, g in enumerate(got):
        if not torch.equal(g, torch.stack([p[i] for p in per])):
            raise AssertionError(f"{fn} {label}: the batch differs from "
                                 "one launch a frame")
        if not torch.equal(one[i], per[0][i][None]):
            raise AssertionError(f"{fn} {label}: a batch of one frame "
                                 "differs from the single-frame form")
    log(f"{fn} {label}: equal to {FPMT_FRAMES} single-frame launches, and "
        "at F=1 to the single-frame form")


def bound_ms(nbytes, operations):
    """(ms, "bytes" | "operations"): the larger of the bytes moved (each
    input read once, each output written once) at the card's memory rate
    and the operations at the peak rate of their type."""
    count, kind = operations
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = count / OPS_PER_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def moved_bytes(args, outs) -> int:
    import torch
    return sum(a.numel() * a.element_size() for a in (*args, *outs)
               if isinstance(a, torch.Tensor))


def phase_kernels(dev) -> dict:
    """Each kernel entry against its plain version: exact, with times."""
    import torch

    from aom_av1_lavish_torch.ops import kernels as K

    recs = {name: dict(name=name, route="cuda", source=src, replaces=rep,
                       max_abs_err=0.0, ms=None, plain_ms=None,
                       bound_ms=None, bound_by=None, library_ms=None,
                       graph_ms=None, cases=[])
            for name, (src, rep, _, _) in KERNELS.items()}
    log(f"{'kernel':<15} {'entry and shape':<47} {'max_err':>7} "
        f"{'kernel ms':>10} {'graph ms':>9} {'plain ms':>10} "
        f"{'bound ms':>9} by {'bytes':>12} {'operations':>12}")
    n_cases = 0
    for name, fn, label, args, operations, *nbytes in _cases(dev):
        wrapper = getattr(K, fn)
        plain = getattr(K, fn + "_plain")
        got, want = run_case(K, fn, args)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            if g.shape != w.shape or g.dtype != w.dtype:
                raise AssertionError(f"{name} {label}: {tuple(g.shape)} "
                                     f"{g.dtype} vs {tuple(w.shape)} "
                                     f"{w.dtype}")
        if fn == "wave_encode":
            err, rel, flipped = wave_error(got, want, args)
            log(f"{name} {label}: integer outputs max abs difference "
                f"{err:g}; float32 costs max relative difference {rel:.3g} "
                f"(limit 1e-6); {flipped} block(s) whose two lowest costs "
                "lie within 1e-6 and whose mode differs")
            if not rel <= 1e-6:
                raise AssertionError(f"{name} {label}: costs differ from "
                                     f"the plain version's by {rel:.3g}")
        else:
            err = max([float((g.double() - w.double()).abs().max())
                       for g, w in zip(got, want) if g.numel()] + [0.0])
        # (wave_encode writes in place what it wrote before: repeats of
        # one call on the same tensors do the same work)
        ms = cuda_ms(lambda: wrapper(*args))
        g_ms = graph_ms(lambda: wrapper(*args))
        plain_ms = cuda_ms(lambda: plain(*args), reps=3)
        nbytes = nbytes[0] if nbytes else moved_bytes(args, got)
        b_ms, b_by = bound_ms(nbytes, operations)
        log(f"{name:<15} {label:<47} {err:>7g} {ms:>10.4f} {g_ms:>9.4f} "
            f"{plain_ms:>10.4f} {b_ms:>9.5f} {b_by:<10} {nbytes:>12d} "
            f"{operations[0]:>12d}")
        rec = recs[name]
        rec["cases"].append(dict(
            shape=f"{fn} {label}", ms=round(ms, 5), graph_ms=round(g_ms, 5),
            plain_ms=round(plain_ms, 4), bound_ms=round(b_ms, 7),
            bound_by=b_by, bytes=nbytes, operations=operations[0]))
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        if rec["ms"] is None:          # the first case is the headline one
            rec.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                       bound_by=b_by, graph_ms=g_ms)
        if err != 0.0:
            raise AssertionError(f"{name} {label}: kernel differs from its "
                                 f"plain version (max abs err {err})")
        if f" F{FPMT_FRAMES} " in f"{label} ":
            check_frame_axis(K, fn, label, args)
        n_cases += 1
    log(f"{n_cases} cases bit-equal to their plain versions")
    # what a frame's waves cost at the least: they depend on each other, so
    # a 1080p KEY is 187 launches in a row, none shorter than the 1-block one
    first = next(c for c in recs["wave_encode"]["cases"]
                 if "first wave" in c["shape"])
    n_waves = H // 16 + W // 16 - 1
    log(f"dependency floor of a {W}x{H} KEY: {n_waves} waves x "
        f"{first['graph_ms']:.5f} ms (the 1-block wave from a graph) = "
        f"{n_waves * first['graph_ms']:.3f} ms")
    return recs


def parent_ssd_plane(parent: str):
    """K2's plane entry as the checkout `parent` (a directory holding
    another commit of the repo) has it: its ssd_surface.cu alone, built
    with this checkout's nvcc flags into build/torch_kernels/ ->
    fn(src, ref, nby, nbx, bsz, r, oy, ox) -> (nby*nbx, S, S) float32 of
    one source plane, launched on the current stream and counted
    nowhere."""
    import ctypes
    import hashlib

    import torch

    from aom_av1_lavish_torch.ops import build
    from aom_av1_lavish_torch.ops import kernels as K

    cu = os.path.join(parent, CSRC, "ssd_surface.cu")
    with open(cu, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    so = build.BUILD_DIR / f"parent_ssd_surface_{tag}.so"
    if not so.exists():
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        done = subprocess.run([build._nvcc(), *build.ARCH_FLAGS,
                               *build.NVCC_FLAGS, "-shared", "-o", str(so),
                               cu], capture_output=True, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"nvcc failed on {cu}:\n"
                               f"{done.stdout[-2000:]}{done.stderr[-2000:]}")
    fn = ctypes.CDLL(str(so)).avl_ssd_surface_plane
    fn.argtypes = K._SIGNATURES["avl_ssd_surface_plane"]
    fn.restype = ctypes.c_int

    def plane(src, ref, nby, nbx, bsz, r, oy, ox):
        S = 2 * r + 1
        out = torch.empty((nby * nbx, S, S), dtype=torch.float32,
                          device=ref.device)
        rc = fn(out.data_ptr(), src.data_ptr(), ref.data_ptr(),
                src.shape[-1], ref.shape[1], nby, nbx, bsz, r, oy, ox,
                src.element_size(), 1, src.shape[-2] * src.shape[-1],
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{cu}: launch failed with CUDA error {rc}")
        return out
    return plane


def phase_before_after(dev, parents=()) -> None:
    """The call paths of the earlier slices beside the entries that
    replaced them (the plane forms of K2 and K3, the fused forms of K1 and
    K4), on the same 1080p inputs, timed in turns (before, after, after,
    before) and reported as the mean of each pair, and once each from a
    CUDA graph (the device's time without the host's).  For each of
    `parents` (checkouts of other commits), also its K2 plane kernel beside
    this one at K2's headline shapes, in turns from CUDA graphs, with the
    number of surface entries in which the two differ."""
    import numpy as np
    import torch

    from aom_av1_lavish_torch.common import interpred as IP
    from aom_av1_lavish_torch.ops import kernels as K

    rng = np.random.default_rng(1)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    nby, nbx = H // 16, W // 16
    B = nby * nbx
    src = t(rng.integers(0, 256, (H, W)).astype(np.uint8))
    ref = t(rng.integers(0, 256, (H + 2 * PADR, W + 2 * PADR))
            .astype(np.uint8))
    src_blk = K.stride_windows(src, 0, 0, nby, nbx, 16, 16).to(torch.int32)
    src_h = t(rng.integers(0, 1021, (H // 2, W // 2)).astype(np.int32))
    ref_h = t(rng.integers(0, 1021, (H // 2 + PADR, W // 2 + PADR))
              .astype(np.int32))
    src_h_blk = K.stride_windows(src_h, 0, 0, nby, nbx, 8, 8).contiguous()
    filt = t(np.asarray(IP.SUBPEL_FILTERS_8).astype(np.int32))
    br = t(rng.integers(0, H + 2 * PADR - 23, B).astype(np.int32))
    bc = t(rng.integers(0, W + 2 * PADR - 23, B).astype(np.int32))
    kx = filt[t(rng.integers(0, 16, B))]
    ky = filt[t(rng.integers(0, 16, B))]

    def k2_before():
        win = K.stride_windows(ref, PADR - 16, PADR - 16, nby, nbx, 16,
                               48).to(torch.int32)
        return K.ssd_surface(src_blk, win, 16, 16)

    def k2_after():
        return K.ssd_surface_plane(src, ref, nby, nbx, 16, 16, PADR - 16,
                                   PADR - 16)

    def k2h_before():
        win = K.stride_windows(ref_h, PADR // 2 - 16, PADR // 2 - 16, nby,
                               nbx, 8, 40).to(torch.int32)
        return K.ssd_surface(src_h_blk, win, 8, 16)

    def k2h_after():
        return K.ssd_surface_plane(src_h, ref_h, nby, nbx, 8, 16,
                                   PADR // 2 - 16, PADR // 2 - 16)

    def k3_before():
        region = K.gather_windows(ref, br, bc, 23, 23).to(torch.int32)
        return K.convolve_8tap(region, kx, ky, 16, 16)

    def k3_after():
        return K.convolve_8tap_plane(ref, br, bc, kx, ky, 16, 16)

    # the full-pel refine: a 3x3 neighbourhood of origins per block
    off = torch.tensor([-1, 0, 1], device=dev)
    y0 = torch.arange(nby, device=dev).repeat_interleave(nbx) * 16
    x0 = torch.arange(nbx, device=dev).repeat(nby) * 16
    ny = (PADR + y0 + t(rng.integers(-32, 33, B)))[:, None] \
        + off.repeat_interleave(3)
    nx = (PADR + x0 + t(rng.integers(-32, 33, B)))[:, None] + off.repeat(3)
    ny, nx = ny.to(torch.int32), nx.to(torch.int32)
    ny_k = [ny[:, k].contiguous() for k in range(9)]
    nx_k = [nx[:, k].contiguous() for k in range(9)]
    syf = src_blk.to(torch.float32)

    def k1_before():
        out = []
        for k in range(9):
            blk = K.gather_windows(ref, ny_k[k], nx_k[k], 16, 16)
            d = blk.to(torch.float32) - syf
            out.append((d * d).sum((1, 2)))
        return torch.stack(out, 1)

    def k1_after():
        return K.block_ssd_at(src, ref, ny, nx, nby, nbx, 16) \
            .to(torch.float32)

    # one wave of the KEY: three planes of torch ops around three quantizer
    # launches (wave_encode's plain version on CUDA tensors) | one launch
    wave = next(c for c in _wave_cases(dev) if "68 blocks x 1 " in c[2])[3]
    got, want = run_case(K, "wave_encode", wave)
    err, rel, flipped = wave_error(got, want, wave)
    if err != 0.0 or not rel <= 1e-6:
        raise AssertionError("K4 wave: the two call paths differ (integer "
                             f"outputs by {err:g}, costs by {rel:.3g})")

    def k4_before():
        return K.wave_encode_plain(*wave)

    def k4_after():
        return K.wave_encode(*wave)

    def same(a, b):
        return torch.equal(a, b) or (a.dtype == torch.float32
                                     and torch.allclose(a, b, rtol=1e-6,
                                                        atol=0))

    for label, before, after in (
            ("K4 wave of 68 blocks: 3 x (edges, predictions, transforms, "
             "quantize_b_vec, rate, inverse, argmin, scatter) | wave_encode",
             k4_before, k4_after),
            ("K2 full res: windows -> int32 -> ssd_surface | "
             "ssd_surface_plane (uint8, bsz16 r16)", k2_before, k2_after),
            ("K2 half res: windows -> ssd_surface | ssd_surface_plane "
             "(int32, bsz8 r16)", k2h_before, k2h_after),
            ("K3 16x16: gather -> int32 -> convolve_8tap | "
             "convolve_8tap_plane", k3_before, k3_after),
            ("K1 refine 3x3: 9 x (gather_windows, float, subtract, square, "
             "sum) | block_ssd_at", k1_before, k1_after)):
        if not same(before(), after()):
            raise AssertionError(f"{label}: the two call paths differ")
        b0 = cuda_ms(before)
        a0 = cuda_ms(after)
        a1 = cuda_ms(after)
        b1 = cuda_ms(before)
        log(f"before/after B{B} {label}: {(b0 + b1) / 2:.4f} ms "
            f"({b0:.4f}, {b1:.4f}) | {(a0 + a1) / 2:.4f} ms "
            f"({a0:.4f}, {a1:.4f}); from a graph {graph_ms(before):.4f} | "
            f"{graph_ms(after):.4f} ms")
    log(f"K4 wave, before/after: {flipped} block(s) of 68 whose two lowest "
        "costs lie within 1e-6 and whose mode differs")
    if not parents:
        log("K2 against an earlier checkout: not run (no --before given)")
    ref8 = t(rng.integers(0, 256, (H + 16, W + 16)).astype(np.uint8))
    olds = {p: parent_ssd_plane(p) for p in parents}
    for parent, label, args in ((p, *case) for p in parents for case in (
            ("full res, uint8 bsz16 r16", (src, ref, nby, nbx, 16, 16,
                                           PADR - 16, PADR - 16)),
            ("half res, int32 bsz8 r16", (src_h, ref_h, nby, nbx, 8, 16,
                                          PADR // 2 - 16, PADR // 2 - 16)),
            ("TPL and TF, uint8 bsz16 r8 pad 8", (src, ref8, nby, nbx, 16, 8,
                                                  0, 0)))):
        old = olds[parent]
        a, b = K.ssd_surface_plane(*args), old(*args)
        torch.cuda.synchronize()
        differ = int((a != b).sum())
        err = float((a - b).abs().max())
        if err > 1.0:
            raise AssertionError(f"K2 {label}: the other checkout's "
                                 f"surface differs from this one's by {err}"
                                 " (the rounding moves an entry by 1 at "
                                 "most)")
        b0 = graph_ms(lambda: old(*args))
        a0 = graph_ms(lambda: K.ssd_surface_plane(*args))
        a1 = graph_ms(lambda: K.ssd_surface_plane(*args))
        b1 = graph_ms(lambda: old(*args))
        log(f"K2 {label} B{B}, from a graph: {parent} {(b0 + b1) / 2:.4f} "
            f"ms ({b0:.4f}, {b1:.4f}) | this checkout {(a0 + a1) / 2:.4f} "
            f"ms ({a0:.4f}, {a1:.4f}); {differ} of {a.numel()} entries "
            f"differ, by at most {err:g}")


def kernel_runs(fn):
    """fn() under torch.profiler -> (device kernel runs, their device
    milliseconds), copies and fills left out."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [ev for ev in prof.key_averages()
           if ev.device_type == DeviceType.CUDA
           and "memcpy" not in ev.key.lower()
           and "memset" not in ev.key.lower()]
    return (sum(ev.count for ev in evs),
            sum(ev.self_device_time_total for ev in evs) / 1e3)


#: the qindexes of the two successive 1080p groups of phase_programs:
#: the slice's (112-120) with frames on both sides of q 128, where the
#: high-precision-MV flag flips
PROGRAM_QS = ([112, 118, 124, 130, 119, 120], [120, 131, 126, 114, 122, 129])


def program_cases(dev, frames, qs, w: int, h: int, g: int = 0):
    """The P-frame programs at w x h on one group's inputs -> [(name,
    program, its arguments)]: the group's len(qs) sources are frames
    1 + g.., LAST frames[g], the ARF frames[-1] (the frames stand in for
    reconstructions); the ARF program codes the group's last source over
    LAST, the low-delay frame and the realtime step its first."""
    from aom_av1_lavish_torch.common.loopfilter import (
        pick_filter_level_from_q)
    from aom_av1_lavish_torch.ops import inter as IT
    from aom_av1_lavish_torch.parallel import sharding as S

    nf = len(qs)
    one = slice(nf - 1, nf)
    srcs, (last, arf), q = IT.upload_group(
        frames[1 + g:1 + g + nf], [frames[g], frames[-1]], qs, dev)
    lf = IT.deblock_levels([pick_filter_level_from_q(
        qq, frame_is_key=False, bd=8) for qq in qs], nf, dev)
    pq, lam, hp = q["pq"], q["lam"], q["hp"]
    fq = (*(p[0] for p in pq), lam[0], hp[0])
    return [
        ("ARF", IT._p_chain_fn((h, w, 1, 0, True, 1)),
         (*(s[one] for s in srcs), *(p[one] for p in pq), lam[one],
          hp[one], lf[one], *last)),
        ("chain", IT._p_chain_fn((h, w, 2, 0, True, nf)),
         (*srcs, *pq, lam, hp, lf, *last, *arf)),
        ("FPMT group", S._fpmt_group_fn(None, h, w, 0, nf),
         (*srcs, *pq, lam, hp, lf, *last, *arf)),
        ("low delay P frame", IT._p_frame_fn((h, w, 1, True, False)),
         (*(s[0] for s in srcs), *fq, *last)),
        ("realtime step", IT._p_step_fn((h, w)),
         (*(s[0] for s in srcs), *IT.pad_ref(*last), *fq)),
    ]


def step_after(args, out, frame, dev):
    """The realtime step's arguments for `frame` after the step that took
    `args` and returned `out`: its next state, cloned."""
    from aom_av1_lavish_torch.ops.inter import to_device
    return (*(to_device(p, dev) for p in frame),
            *(t.clone() for t in out[2:]), *args[7:])


def phase_programs(dev, frames) -> None:
    """Each P-frame program of the port (ops/graphs.DeviceProgram) at
    1920x1088 against its plain version (the eager function that its
    graph captured) on the same inputs, every output bit for bit, over two
    successive groups of inputs: the ARF (_p_chain_fn, a one-frame chain
    over LAST), the default chain (_p_chain_fn, 6 P frames over LAST and
    the ARF), the frame-parallel group (_fpmt_group_fn, 6 P frames), a
    low-delay single P frame (_p_frame_fn, one reference) and two
    successive realtime steps (_p_step_fn) a group.  One replay must count
    the kernel launches one eager call counts (the chain's are six
    frame-parallel groups' of one frame, the group's one group's).  Prints
    each program's capture seconds (warm-up and capture), replay and plain
    milliseconds (CUDA events), device kernel runs and their device time
    for one replay (torch.profiler), and device memory: the peak of the
    first call (warm-up, capture, replay) and what the capture holds
    after it."""
    import torch

    from aom_av1_lavish_torch.ops import kernels as K

    nf = FPMT_FRAMES
    first = {}
    for g, qs in enumerate(PROGRAM_QS):
        for name, prog, args in program_cases(dev, frames, qs, W, H, g):
            got = want = None
            torch.cuda.synchronize()
            new = prog.capture_of(*args) is None
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            K.reset_launches()
            got = prog(*args)
            torch.cuda.synchronize()
            replayed = K.launch_counts()
            peak = torch.cuda.max_memory_allocated() - held
            kept = torch.cuda.memory_allocated() - held
            got = [t.clone() for t in got]
            K.reset_launches()
            want = prog.fn(*args)
            torch.cuda.synchronize()
            eager = K.launch_counts()
            differ = [i for i, (a, b) in enumerate(zip(got, want))
                      if a.shape != b.shape or not torch.equal(a, b)]
            if differ or len(got) != len(want):
                raise AssertionError(f"program {name}, group {g}: outputs "
                                     f"{differ} of the replay differ from "
                                     "the plain version's")
            if replayed != eager:
                raise AssertionError(f"program {name}, group {g}: a replay "
                                     f"counted {replayed}, an eager call "
                                     f"{eager}")
            if name == "chain" or name == "FPMT group":
                want_k = fpmt_per_group(qs)
                want_k = {k: v * (nf if name == "chain" else 1)
                          for k, v in want_k.items() if v}
                have = dict(replayed[0], **replayed[1])
                wrong = {k: (have.get(k, 0), v) for k, v in want_k.items()
                         if have.get(k, 0) != v}
                if wrong:
                    raise AssertionError(f"program {name}: launches "
                                         f"(counted, expected) {wrong}")
            cap = prog.capture_of(*args)
            if cap is None or cap.replays < 1:
                raise AssertionError(f"program {name}: no capture replayed")
            if new:
                first[name] = (peak, kept)
            if name.startswith("realtime"):
                # the second step reads the state the first one produced
                args2 = step_after(args, got, frames[2 + g], dev)
                got2 = [t.clone() for t in prog(*args2)]
                want2 = prog.fn(*args2)
                if not all(torch.equal(a, b) for a, b in zip(got2, want2)):
                    raise AssertionError(f"realtime step 2, group {g}: the "
                                         "replay differs from the plain "
                                         "version")
            if g == 0:
                log(f"program {name} {W}x{H}, group {g}: replay equals the "
                    f"plain version ({len(got)} outputs); launches a "
                    f"replay {json.dumps(dict(replayed[0], **replayed[1]))}")
                continue
            rep_ms = cuda_ms(lambda: prog(*args), reps=5)
            plain_ms = cuda_ms(lambda: prog.fn(*args), reps=1)
            runs, dev_ms = kernel_runs(lambda: prog(*args))
            p_runs, p_dev_ms = kernel_runs(lambda: prog.fn(*args))
            peak0, kept0 = first.get(name, (float("nan"), float("nan")))
            log(f"program {name} {W}x{H}: two groups' replays equal the "
                f"plain version (realtime: two successive steps each); "
                f"capture {cap.seconds:.3f} s; replay {rep_ms:.3f} ms, "
                f"plain {plain_ms:.3f} ms (CUDA events); device kernel runs "
                f"a replay {runs} ({dev_ms:.3f} ms of kernels), plain "
                f"{p_runs} ({p_dev_ms:.3f} ms); first call's peak "
                f"{peak0 / 2**20:.1f} MiB above the {held / 2**20:.1f} MiB "
                f"held before it, {kept0 / 2**20:.1f} MiB kept by the "
                f"capture; replays {cap.replays}")


def run_slice(dev, frames, kw):
    """One 1080p slice in configuration `kw` -> (encoder, payloads,
    seconds, launches by kernel and by C entry, stage seconds), the launch
    counters set to 0 just before it."""
    import torch

    from aom_av1_lavish_torch.encoder.gop import TorchGopEncoder
    from aom_av1_lavish_torch.ops import kernels as K
    from aom_av1_lavish_torch.utils import profiler

    profiler.enable()
    profiler.reset()
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    enc = TorchGopEncoder(W, H, device=dev, **kw)
    payloads = enc.encode_sequence(frames)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(K.LAUNCHES, **K.ENTRY_LAUNCHES)
    stages = profiler.times()
    profiler.enable(False)
    return enc, payloads, secs, launches, stages


#: launches of one 1080p slice (a KEY and one GF group of 7) that the
#: slice's structure fixes: per (frame, reference) of the ARF and the six P
#: frames (1 + 6 * 2 = 13) two K2 surfaces and one fused K1 refine; with TPL
#: and the filter on, 12 TPL pairs and 2 filter neighbours more of K2 and
#: 2 neighbours x 3 planes of K1's gather form
EXPECTED = {
    "cpu_used 8": {"ssd_surface": 26, "gather_windows": 13,
                   "avl_block_ssd_at": 13, "avl_gather_windows": 0,
                   "avl_ssd_surface": 0},
    "default": {"ssd_surface": 26 + 14, "gather_windows": 13 + 6,
                "avl_block_ssd_at": 13, "avl_gather_windows": 6,
                "avl_ssd_surface": 0},
}
#: K4 in either slice: one fused launch a wave of the KEY (187 waves at
#: 1080p) and 9 quantize_b_vec launches for each of the 7 chained frames
for _exp in EXPECTED.values():
    _exp.update({"avl_wave_encode": 187, "avl_quantize_b": 63,
                 "quantize_b_vec": 250})


def phase_slice(dev, frames, label, kw) -> dict:
    """The 1080p slice in configuration `kw` with the launch counters
    reset just before it; returns the launch counts."""
    import numpy as np

    from aom_av1_lavish_torch.ops import kernels as K

    enc, payloads, secs, launches, stages = run_slice(dev, frames, kw)
    if len(payloads) != N_FRAMES or not all(payloads):
        raise AssertionError(f"expected {N_FRAMES} non-empty TUs, got "
                             f"{[len(p) for p in payloads]}")
    missing = [k for k in K.LAUNCHES if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched by the {label} slice: "
                             f"{missing}")
    wrong = {k: (launches.get(k, 0), v) for k, v in EXPECTED[label].items()
             if launches.get(k, 0) != v}
    if wrong:
        raise AssertionError(f"{label} slice: launches (counted, expected) "
                             f"{wrong}")
    want = {"gop/key", "gop/arf_encode", "gop/chain_device", "gop/emit",
            "key/waves", "key/fetch", "key/deblock", "key/emit"}
    if enc.enable_tpl and enc.enable_tf:
        want |= {"gop/tpl", "gop/temporal_filter"}
    if not want <= set(stages):
        raise AssertionError(f"{label} slice: stages {sorted(stages)} lack "
                             f"{sorted(want - set(stages))}")
    # the last P frame's recon (LAST slot) against its source
    rec = enc.slots[enc.arf_slot]
    for p, shape in zip(rec, ((H, W), (H // 2, W // 2), (H // 2, W // 2))):
        if p.shape != shape or p.dtype != np.uint8:
            raise AssertionError(f"recon plane {p.shape} {p.dtype}")
    mse = np.mean((rec[0].astype(np.float64)
                   - frames[N_FRAMES - 2][0].astype(np.float64)) ** 2)
    psnr = 10 * np.log10(255.0 ** 2 / max(mse, 1e-9))
    if not psnr > 30.0:
        raise AssertionError(f"last P frame luma PSNR {psnr:.2f} dB")
    log(f"slice {label} {W}x{H}: {N_FRAMES} TUs, "
        f"{sum(map(len, payloads))} bytes, "
        f"{secs:.3f} s, {N_FRAMES / secs:.4f} frames/s, last P luma PSNR "
        f"{psnr:.2f} dB")
    for k, v in sorted(stages.items(), key=lambda kv: -kv[1]):
        log(f"  stage {k:<20} {v:8.3f} s")
    log(f"  launches {json.dumps(launches)}")
    return launches


def phase_warm(dev, frames, label, kw, n: int) -> None:
    """n more runs of the slice in configuration `kw`: median, minimum and
    maximum of the total and of each GOP stage, and the peak device
    memory."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    totals, per_stage = [], {}
    for _ in range(n):
        _, _, secs, _, stages = run_slice(dev, frames, kw)
        totals.append(secs)
        for k, v in stages.items():
            if k.startswith(("gop/", "key/")):
                per_stage.setdefault(k, []).append(v)
    med = statistics.median(totals)
    log(f"warm slice {label} n={n}: median {med:.3f} s (min "
        f"{min(totals):.3f}, max "
        f"{max(totals):.3f}), {N_FRAMES / med:.4f} frames/s; runs "
        f"{[round(x, 3) for x in totals]}")
    for k, v in sorted(per_stage.items(),
                       key=lambda kv: -statistics.median(kv[1])):
        m = statistics.median(v)
        log(f"  warm stage {k:<20} median {m:7.3f} s (min {min(v):.3f}, max "
            f"{max(v):.3f}), {100 * m / med:.0f}% of the median total")
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f}"
        f" MiB allocated, {torch.cuda.memory_reserved() / 2**20:.1f} MiB "
        "reserved (the captured programs' pools among it)")


def phase_profile(dev, frames, label, kw) -> None:
    """One slice in configuration `kw` under torch.profiler: device time
    of each hand kernel, of everything else, and the device-busy share of
    the wall clock."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, _, secs, launches, _ = run_slice(dev, frames, kw)
    hand = {name: [0.0, 0] for name in DEVICE_FUNCS}
    other_us, other_n, copies_us = 0.0, 0, 0.0
    for ev in prof.key_averages():
        # device-side events only: a host-side operator event repeats the
        # time of the kernels it launched
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if not us:
            continue
        for name, funcs in DEVICE_FUNCS.items():
            if any(f in ev.key for f in funcs):
                hand[name][0] += us
                hand[name][1] += ev.count
                break
        else:
            if "memcpy" in ev.key.lower() or "memset" in ev.key.lower():
                copies_us += us
            else:
                other_us += us
                other_n += ev.count
    hand_us = sum(v[0] for v in hand.values())
    total_us = hand_us + other_us + copies_us
    if total_us <= 0:
        raise AssertionError("the profiler recorded no device time")
    log(f"profiled slice {label}: {secs:.3f} s wall clock under the "
        f"profiler, "
        f"{total_us / 1e3:.2f} ms of device time "
        f"({100 * total_us / 1e6 / secs:.1f}% of that wall clock)")
    for name, (us, n) in hand.items():
        log(f"  device {name:<15} {us / 1e3:8.3f} ms in {n} kernel runs "
            f"({launches[name]} launches counted)")
    log(f"  device hand kernels together {hand_us / 1e3:.3f} ms; other "
        f"kernels {other_us / 1e3:.2f} ms in {other_n} runs; memcpy/memset "
        f"{copies_us / 1e3:.2f} ms")


def phase_decode(dev, frames, w, h, label, kw) -> None:
    """Encode at w x h in configuration `kw`, decode with the port's
    decoder: reference slots must equal the encoder's recon slots
    exactly."""
    import numpy as np

    from aom_av1_lavish_torch.decoder.decoder import decode_frame_obus
    from aom_av1_lavish_torch.encoder.gop import TorchGopEncoder

    enc = TorchGopEncoder(w, h, device=dev, **kw)
    payloads = enc.encode_sequence(frames)
    sh, state, shown = None, {"slots": [None] * 8}, []
    for p in payloads:
        fr, sh = decode_frame_obus(p, sh, state)
        shown.extend(fr)
    if len(shown) != len(frames):
        raise AssertionError(f"decoded {len(shown)} of {len(frames)} frames")
    compared = 0
    for slot in range(8):
        if enc.slots[slot] is None:
            continue
        for pe, pd in zip(enc.slots[slot], state["slots"][slot]["planes"]):
            if not np.array_equal(pe, pd):
                raise AssertionError(f"slot {slot}: decoder != encoder recon")
            compared += 1
    if compared == 0:
        raise AssertionError("no recon slots to compare")
    log(f"decode {label} {w}x{h}: {len(shown)} frames; {compared} slot "
        f"planes equal the encoder recon")


# ---------------------------------------------------------------------------
# the other device paths


@contextlib.contextmanager
def instances_of(cls, method: str, seconds=None):
    """Collects the instances of `cls` on which `method` is called while
    the block runs (the encoders an entry point builds inside itself),
    and each call's host seconds into `seconds` when given (for a method
    that returns with its results on the host)."""
    seen = []
    orig = getattr(cls, method)

    def spy(self, *a, **k):
        if not any(self is s for s in seen):
            seen.append(self)
        t0 = time.perf_counter()
        try:
            return orig(self, *a, **k)
        finally:
            if seconds is not None:
                seconds.append(time.perf_counter() - t0)

    setattr(cls, method, spy)
    try:
        yield seen
    finally:
        setattr(cls, method, orig)


def read_payloads(path):
    from aom_av1_lavish_torch.bitstream.ivf import read_ivf
    return [p for p, _ in read_ivf(path)]


def decode_payloads(payloads):
    """-> (shown frames, decoder state) of the port's decoder."""
    from aom_av1_lavish_torch.decoder.decoder import decode_frame_obus
    sh, state, shown = None, {"slots": [None] * 8}, []
    for p in payloads:
        if p:
            fr, sh = decode_frame_obus(p, sh, state)
            shown.extend(fr)
    return shown, state


def require_planes_equal(what, got, want) -> int:
    """Each plane of `got` equals that of `want` over want's extent."""
    import numpy as np
    n = 0
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        if not np.array_equal(g[:w.shape[0], :w.shape[1]], w):
            raise AssertionError(f"{what}: plane {n} differs")
        n += 1
    if n == 0:
        raise AssertionError(f"{what}: nothing to compare")
    return n


def require_slots_equal(what, enc_slots, state) -> int:
    n = 0
    for slot in range(8):
        if enc_slots[slot] is not None:
            n += require_planes_equal(f"{what} slot {slot}",
                                      state["slots"][slot]["planes"],
                                      enc_slots[slot])
    if n == 0:
        raise AssertionError(f"{what}: no recon slots to compare")
    return n


def timed_path(label, fn, expected=None, need=()):
    """Runs one path with the launch counters set to 0 just before it and
    read just after; `expected` fixes counts, `need` names kernels that
    must have launched -> (fn's result, seconds, launches)."""
    import torch

    from aom_av1_lavish_torch.ops import kernels as K
    from aom_av1_lavish_torch.utils import profiler

    profiler.enable()
    profiler.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(K.LAUNCHES, **K.ENTRY_LAUNCHES)
    stages = profiler.times()
    profiler.enable(False)
    missing = [k for k in need if launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"{label}: kernels not launched: {missing}")
    wrong = {k: (launches.get(k, 0), v) for k, v in (expected or {}).items()
             if launches.get(k, 0) != v}
    if wrong:
        raise AssertionError(f"{label}: launches (counted, expected) {wrong}")
    log(f"path {label}: {secs:.3f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; launches "
        f"{json.dumps(launches)}")
    for k, v in sorted(stages.items(), key=lambda kv: -kv[1]):
        if k.startswith(("gop/", "rdo/", "key/")):
            log(f"  stage {k:<20} {v:8.3f} s")
    return out, secs, launches


ALL_KERNELS = ("gather_windows", "ssd_surface", "convolve_8tap",
               "quantize_b_vec")
#: per 1080p P frame over one reference with 1/8-pel MVs: 22 sub-pel
#: predictions, 3 snap candidates and 2 chroma planes (27), and 7 per merge
#: level (5 candidates, 2 chroma planes); K4 once per plane and level; a KEY
#: is 187 waves, one fused K4 launch (wave_encode) each
K3_FIXED16, K3_MERGE, K4_KEY = 27, 27 + 2 * 7, 187


def phase_rdo_key(dev, tmp) -> dict:
    """The default configuration where the KEY takes the device RDO: 8
    frames at 720x576 (the largest such frame) and at 352x288, decoded;
    and the trial sweep of one padded 720x576 luma plane on its own."""
    import numpy as np
    import torch

    from aom_av1_lavish_torch.encoder.gop import TorchGopEncoder
    from aom_av1_lavish_torch.encoder.tpu_rdo import TpuRdoAllIntraEncoder
    from aom_av1_lavish_torch.ops.rdo_intra import IntraTrialEngine
    from aom_av1_lavish_torch.utils.clips import make_frames

    out = {}
    for w, h in ((720, 576), (352, 288)):
        frames = make_frames(N_FRAMES, w, h)

        def run():
            with instances_of(TpuRdoAllIntraEncoder, "encode_frame") as keys:
                enc = TorchGopEncoder(w, h, device=dev, **KW_DEFAULT)
                payloads = enc.encode_sequence(frames)
            if len(keys) != 1:
                raise AssertionError(f"{len(keys)} device-RDO KEYs")
            return enc, payloads

        # 11 luma geometries and their 10 chroma ones (4x4 has none) on
        # each of 2 planes, then a 1-frame ARF chain and 6 P frames, 9
        # quantizer calls each
        (enc, payloads), _, launches = timed_path(
            f"device-RDO KEY GOP {w}x{h}", run, need=ALL_KERNELS,
            expected={"quantize_b_vec": 11 + 2 * 10 + 7 * 9})
        shown, state = decode_payloads(payloads)
        if len(shown) != N_FRAMES:
            raise AssertionError(f"decoded {len(shown)} frames")
        n = require_slots_equal(f"device-RDO GOP {w}x{h}", enc.slots, state)
        log(f"  decode {w}x{h}: {len(shown)} frames; {n} slot planes equal "
            "the encoder recon")
        out[f"rdo_gop_{w}x{h}"] = launches
    # the sweep alone, every geometry of a 768x576 plane, inputs on the card
    rng = np.random.default_rng(2)
    plane = rng.integers(0, 256, (RDO_H, RDO_W)).astype(np.uint8)
    eng = IntraTrialEngine(QINDEX, device=dev)
    sizes = [(4, 4), (8, 8), (16, 16), (32, 32), (64, 64), (16, 8), (8, 16),
             (32, 16), (16, 32), (64, 32), (32, 64)]
    t0 = time.perf_counter()
    prep = eng.prepare(plane, sizes, lambda y, x, bh, bw: 50.0)
    t_prep = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: eng.sweep(prep), reps=3)
    log(f"trial sweep {RDO_W}x{RDO_H}, 11 geometries x 61 modes: "
        f"{ms / 1e3:.4f} s on the card per sweep (CUDA events, results "
        f"copied back); host preparation {t_prep:.3f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    return out


def phase_lowdelay(dev, tmp, frames) -> dict:
    """encode_tpu_lowdelay_ivf at 1920x1088, 4 frames."""
    from aom_av1_lavish_torch.encoder.tpu_inter import (
        TpuLowDelayEncoder, encode_tpu_lowdelay_ivf)

    path = os.path.join(tmp, "lowdelay.ivf")
    per_frame = []

    def run():
        with instances_of(TpuLowDelayEncoder, "encode_frame",
                          per_frame) as encs:
            encode_tpu_lowdelay_ivf(path, frames, W, H, qindex=60,
                                    device=dev)
        return encs[0]

    n_p = len(frames) - 1
    enc, secs, launches = timed_path(
        f"low delay {W}x{H}, {len(frames)} frames", run, need=ALL_KERNELS,
        expected={"ssd_surface": 2 * n_p, "avl_block_ssd_at": n_p,
                  "avl_gather_windows": 0,
                  "convolve_8tap": K3_MERGE * n_p,
                  "quantize_b_vec": K4_KEY + 9 * n_p,
                  "avl_wave_encode": K4_KEY, "avl_quantize_b": 9 * n_p})
    shown, state = decode_payloads(read_payloads(path))
    n = require_slots_equal("low delay", enc.slots, state)
    log(f"  decode: {len(shown)} frames; {n} slot planes equal the encoder "
        f"recon; KEY {per_frame[0]:.3f} s, P frames "
        f"{[round(x, 3) for x in per_frame[1:]]} s each (device encode, "
        "host deblock and emit)")
    return {"lowdelay": launches}


def phase_realtime(dev, tmp, frames) -> dict:
    """encode_realtime_tpu_ivf at 1920x1088, 4 frames; every decoded P
    frame equals the recon of the same stream stepped once more."""
    from aom_av1_lavish_torch.encoder.nonrd import encode_realtime_tpu_ivf
    from aom_av1_lavish_torch.ops.inter import DeviceRtEncoder

    from aom_av1_lavish_torch.encoder.tpu_intra import TorchAllIntraEncoder

    path = os.path.join(tmp, "realtime.ivf")
    n_p = len(frames) - 1
    key_secs = []

    def run():
        with instances_of(TorchAllIntraEncoder, "encode_frame", key_secs):
            encode_realtime_tpu_ivf(path, frames, W, H, qindex=90,
                                    device=dev)

    _, secs, launches = timed_path(
        f"realtime {W}x{H}, {len(frames)} frames", run,
        need=ALL_KERNELS,
        expected={"ssd_surface": 2 * n_p, "avl_block_ssd_at": n_p,
                  "avl_gather_windows": 0,
                  "convolve_8tap": K3_FIXED16 * n_p,
                  "quantize_b_vec": K4_KEY + 3 * n_p,
                  "avl_wave_encode": K4_KEY, "avl_quantize_b": 3 * n_p})
    shown, _ = decode_payloads(read_payloads(path))
    if len(shown) != len(frames):
        raise AssertionError(f"decoded {len(shown)} frames")
    rt = DeviceRtEncoder(90, device=dev)
    rt.reset_ref(shown[0][:3])
    t0 = time.perf_counter()
    for f, dec in zip(frames[1:], shown[1:]):
        rt.encode_frame(f)
        require_planes_equal("realtime P frame", rt.fetch_recon(H, W),
                             dec[:3])
    step = (time.perf_counter() - t0) / n_p
    log(f"  decode: {len(shown)} frames, every P frame equals the device "
        f"recon; KEY {key_secs[0]:.3f} s, then "
        f"{(secs - key_secs[0]) / n_p:.3f} s per P frame in the stream "
        f"(step, copy and emit, one frame in flight); {step:.3f} s per P "
        "frame stepped alone with its recon fetched")
    return {"realtime": launches}


def phase_short_groups(dev) -> dict:
    """GOPs whose groups hold no ARF at 352x288: gf_length 2 at cpu_used 8
    and use_arf off in the default configuration (single P frames through
    TpuInterFrameEncoder's own device encode)."""
    from aom_av1_lavish_torch.encoder.gop import TorchGopEncoder
    from aom_av1_lavish_torch.utils.clips import make_frames

    frames = make_frames(N_FRAMES, 352, 288)
    out = {}
    for name, kw in (("gf_length 2", dict(KW_CPU8, gf_length=2)),
                     ("use_arf off", dict(KW_DEFAULT, use_arf=False))):
        def run():
            enc = TorchGopEncoder(352, 288, device=dev, **kw)
            return enc, enc.encode_sequence(frames)

        (enc, payloads), _, launches = timed_path(
            f"short groups ({name}) 352x288", run, need=ALL_KERNELS,
            expected={"avl_block_ssd_at": N_FRAMES - 1,
                      "avl_gather_windows": 0,
                      "ssd_surface": 2 * (N_FRAMES - 1)})
        shown, state = decode_payloads(payloads)
        if len(shown) != N_FRAMES:
            raise AssertionError(f"decoded {len(shown)} frames")
        n = require_slots_equal(name, enc.slots, state)
        log(f"  decode: {len(shown)} frames; {n} slot planes equal the "
            "encoder recon")
        out[name] = launches
    return out


def phase_lossless(dev, tmp, frames) -> dict:
    """encode_lossless_ivf at 1920x1088: the decoder returns the source.
    Its device work is integer adds and shifts outside any kernel."""
    from aom_av1_lavish_torch.encoder import encode_lossless_ivf

    path = os.path.join(tmp, "lossless.ivf")
    _, secs, launches = timed_path(
        f"lossless {W}x{H}, {len(frames)} frames",
        lambda: encode_lossless_ivf(path, frames, W, H, device=dev),
        expected={k: 0 for k in ALL_KERNELS})
    shown, _ = decode_payloads(read_payloads(path))
    if len(shown) != len(frames):
        raise AssertionError(f"decoded {len(shown)} frames")
    for f, dec in zip(frames, shown):
        require_planes_equal("lossless", dec[:3], f)
    log(f"  decode: {len(shown)} frames equal the source; "
        f"{secs / len(frames):.3f} s per frame, "
        f"{os.path.getsize(path)} bytes")
    return {"lossless": launches}


def phase_twopass(dev, tmp, frames) -> dict:
    """first_pass over the 8 frames at 1920x1088, then encode_twopass_ivf
    (which runs it again and reads the stats back from its file)."""
    from aom_av1_lavish_torch.encoder.firstpass import first_pass, load_stats
    from aom_av1_lavish_torch.encoder.gop import (GopEncoder,
                                                  encode_twopass_ivf)

    stats, secs, fp_launches = timed_path(
        f"first pass {W}x{H}, {len(frames)} frames",
        lambda: first_pass(frames, device=dev),
        expected={"avl_ssd_surface_plane": len(frames),
                  "ssd_surface": len(frames), "gather_windows": 0,
                  "convolve_8tap": 0, "quantize_b_vec": 0})
    for s in stats:
        log(f"  stats frame {int(s.frame)}: intra {s.intra_error:.6g} coded "
            f"{s.coded_error:.6g} inter {s.pcnt_inter:.4f} motion "
            f"{s.pcnt_motion:.4f} |mv| {s.mv_mag:.4f}")
    if not all(s.pcnt_inter > 0.5 for s in stats[1:]):
        raise AssertionError("first pass: the pan's frames are not inter")
    path = os.path.join(tmp, "twopass.ivf")

    def run():
        with instances_of(GopEncoder, "encode_sequence") as encs:
            encode_twopass_ivf(path, frames, W, H, device=dev,
                               stats_path=os.path.join(tmp, "fpstats"),
                               **KW_DEFAULT)
        return encs[0]

    enc, secs2, launches = timed_path(
        f"two-pass {W}x{H}, {len(frames)} frames", run, need=ALL_KERNELS,
        expected={"avl_wave_encode": K4_KEY, "avl_quantize_b": 63})
    back = load_stats(os.path.join(tmp, "fpstats"))
    if [s.to_array().tolist() for s in back] != \
            [s.to_array().tolist() for s in stats]:
        raise AssertionError("two-pass: the stats file differs from the "
                             "first pass run before it")
    shown, state = decode_payloads(read_payloads(path))
    if len(shown) != len(frames):
        raise AssertionError(f"decoded {len(shown)} frames")
    n = require_slots_equal("two-pass", enc.slots, state)
    log(f"  decode: {len(shown)} frames; {n} slot planes equal the encoder "
        f"recon; first pass {secs / len(frames):.4f} s per frame")
    return {"first_pass": fp_launches, "twopass": launches}


def phase_intra_batch(dev, tmp, frames) -> dict:
    """encode_tpu_ivf at 1920x1088: 4 frames in one batch beside 1 frame
    through the same entry, in turns (1, 4, 4, 1)."""
    import numpy as np

    from aom_av1_lavish_torch.encoder.tpu_intra import (TorchAllIntraEncoder,
                                                        encode_tpu_ivf)

    path = os.path.join(tmp, "intra_batch.ivf")

    def run(n):
        def go():
            with instances_of(TorchAllIntraEncoder, "_encode_tile") as encs:
                encode_tpu_ivf(path, frames[:n], W, H, qindex=QINDEX,
                               device=dev)
            return encs
        return timed_path(f"batched all-intra {W}x{H}, {n} frame(s)", go,
                          expected={"quantize_b_vec": K4_KEY,
                                    "avl_wave_encode": K4_KEY,
                                    "avl_quantize_b": 0,
                                    "gather_windows": 0, "ssd_surface": 0,
                                    "convolve_8tap": 0})

    n = len(frames)
    _, one_a, _ = run(1)
    _, many_a, _ = run(n)
    encs, many_b, launches = run(n)
    shown, _ = decode_payloads(read_payloads(path))
    if len(shown) != n or len(encs) != n:
        raise AssertionError(f"decoded {len(shown)} frames of {len(encs)}")
    for enc, f, dec in zip(encs, frames, shown):
        require_planes_equal("batched all-intra", enc.recon, dec[:3])
        mse = np.mean((np.asarray(dec[0], np.float64) - f[0]) ** 2)
        if not 10 * np.log10(255.0 ** 2 / max(mse, 1e-9)) > 30.0:
            raise AssertionError("batched all-intra: luma PSNR under 30 dB")
    _, one_b, _ = run(1)
    one, many = (one_a + one_b) / 2, (many_a + many_b) / 2
    log(f"  decode: {n} frames equal the encoders' recon; {n} frames in one "
        f"batch {many:.3f} s ({many_a:.3f}, {many_b:.3f}) beside {n} x one "
        f"frame {n * one:.3f} s ({one_a:.3f}, {one_b:.3f} each)")
    return {"intra_batch": launches}


@contextlib.contextmanager
def launches_per_call(module, name: str, calls: list):
    """Wraps `module.<name>` while the block runs: each call appends (its
    positional arguments, its keyword arguments, the kernel launches it
    made) to `calls`."""
    from aom_av1_lavish_torch.ops import kernels as K

    orig = getattr(module, name)

    def spy(*a, **k):
        before = dict(K.LAUNCHES, **K.ENTRY_LAUNCHES)
        try:
            return orig(*a, **k)
        finally:
            after = dict(K.LAUNCHES, **K.ENTRY_LAUNCHES)
            calls.append((a, k, {key: v - before.get(key, 0)
                                 for key, v in after.items()}))

    setattr(module, name, spy)
    try:
        yield calls
    finally:
        setattr(module, name, orig)


def fpmt_per_group(qindexes) -> dict:
    """Launches of one 1080p frame-parallel group, whatever its number of
    P frames (each kernel entry takes all of them at once; a chained P
    frame is a group of one), both references searched: per reference two
    K2 surfaces (full and half res) and one fused K1 refine; K3 90 at any
    q (the eighth-pel diamond always runs, each frame taking its pick by
    its flag): each reference's sub-pel refine, the snap candidates, the
    three interp-filter banks, two chroma planes, and 7 a merge level; K4
    once per plane and level."""
    return {"ssd_surface": 4, "avl_ssd_surface_plane": 4,
            "gather_windows": 2, "avl_block_ssd_at": 2,
            "avl_gather_windows": 0,
            "convolve_8tap": 90, "avl_convolve_8tap_plane": 90,
            "quantize_b_vec": 9, "avl_quantize_b": 9, "avl_wave_encode": 0}


def require_group_launches(label, calls) -> None:
    """Each fpmt_encode_group call launched fpmt_per_group's counts."""
    if not calls:
        raise AssertionError(f"{label}: no frame-parallel group ran")
    for args, _, got in calls:
        want = fpmt_per_group(args[2])
        wrong = {k: (got.get(k, 0), v) for k, v in want.items()
                 if got.get(k, 0) != v}
        if wrong:
            raise AssertionError(f"{label}: group of {len(args[2])} P "
                                 f"frames, launches (counted, expected) "
                                 f"{wrong}")
        log(f"  {label}: group of {len(args[2])} P frames (q "
            f"{list(args[2])}), launches per group {json.dumps(got)}")


def phase_fpmt(dev, frames, slice_launches):
    """The default-configuration 1080p GOP with frame-parallel groups
    (GopEncoder(frame_parallel=True) -> parallel/sharding
    fpmt_encode_group): each group's launches (fpmt_per_group), and the
    GOP's: the chained slice's with the group's P frames counted once as a
    group instead of once each; decoded by the port's decoder against the
    encoder's recon, and the same bytes on a make_mesh(4, 1) layout ->
    (launches, payloads, shown frames, the first group's call)."""
    from aom_av1_lavish_torch.encoder.gop import GopEncoder
    from aom_av1_lavish_torch.parallel import sharding

    groups = []

    def run(mesh=None):
        with launches_per_call(sharding, "fpmt_encode_group", groups):
            enc = GopEncoder(W, H, device=dev, mesh=mesh, **KW_FPMT)
            return enc, enc.encode_sequence(frames)

    (enc, payloads), _, launches = timed_path(
        f"FPMT GOP {W}x{H}, {N_FRAMES} frames", run, need=ALL_KERNELS)
    require_group_launches("FPMT", groups)
    want = dict(slice_launches)
    for args, _, _ in groups:
        for k, v in fpmt_per_group(args[2]).items():
            want[k] = want.get(k, 0) + v - sum(
                fpmt_per_group([q])[k] for q in args[2])
    wrong = {k: (launches.get(k, 0), v) for k, v in want.items()
             if launches.get(k, 0) != v}
    if wrong:
        raise AssertionError(f"FPMT GOP: launches (counted, expected) "
                             f"{wrong}")
    log(f"  FPMT GOP launches equal the chained slice's less "
        f"{sum(len(a[2]) for a, _, _ in groups) - len(groups)} P frames' "
        f"(each group's frames counted once): {json.dumps(want)}")
    group_call = groups[0][:2]
    shown, state = decode_payloads(payloads)
    if len(shown) != N_FRAMES:
        raise AssertionError(f"FPMT: decoded {len(shown)} frames")
    n = require_slots_equal("FPMT", enc.slots, state)
    t0 = time.perf_counter()
    _, on_mesh = run(sharding.make_mesh(4, 1, device=dev))
    secs = time.perf_counter() - t0
    if on_mesh != payloads:
        raise AssertionError("FPMT: the stream on make_mesh(4, 1) differs "
                             "from the stream with mesh=None")
    log(f"  decode: {len(shown)} frames; {n} slot planes equal the encoder "
        f"recon; make_mesh(4, 1): the same {sum(map(len, payloads))} bytes "
        f"({secs:.3f} s)")
    return launches, payloads, shown, group_call


def phase_fpmt_group(dev, call) -> None:
    """The GOP's frame-parallel group on its own, as the GOP called it:
    the group as one call (one launch per kernel entry for all its P
    frames) beside one call a frame, in turns (group, frames, frames,
    group), with each run's host seconds (device synchronized) and peak
    device memory; the group's results against the frames' (any
    difference is logged: the float stages are reduced frame by frame, so
    none is expected); and the device kernel runs of each, counted by
    torch.profiler."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from aom_av1_lavish_torch.ops import kernels as K
    from aom_av1_lavish_torch.parallel import sharding

    args, kw = call
    mesh, srcs, qs, last, arf = args
    lfs = kw.get("lf_levels")
    nf = len(srcs)

    def group():
        return sharding.fpmt_encode_group(mesh, srcs, qs, last, arf, **kw)

    def frames():
        raws, recs = [], []
        for j in range(nf):
            r, c = sharding.fpmt_encode_group(
                mesh, srcs[j:j + 1], qs[j:j + 1], last, arf,
                **dict(kw, lf_levels=None if lfs is None else lfs[j:j + 1]))
            raws += r
            recs += c
        return raws, recs

    def timed(fn):
        """-> (fn's result, seconds, peak device memory, the memory held
        before it, launches)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        K.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        return (out, secs, torch.cuda.max_memory_allocated(), base,
                dict(K.LAUNCHES, **K.ENTRY_LAUNCHES))

    g0, tg0, pg, base, lg = timed(group)
    f0, tf0, pf, _, lf = timed(frames)
    tf1 = timed(frames)[1]
    tg1 = timed(group)[1]
    require_group_launches("FPMT group alone", [(args, kw, lg)])
    diff = [(j, k) for j in range(nf) for k in g0[0][j]
            if not np.array_equal(g0[0][j][k], f0[0][j][k])]
    diff += [(j, f"recon plane {i}") for j in range(nf)
             for i in range(3)
             if not np.array_equal(g0[1][j][i], f0[1][j][i])]
    log(f"FPMT group {W}x{H}, {nf} P frames (q {list(qs)}): one call "
        f"{(tg0 + tg1) / 2:.4f} s ({tg0:.4f}, {tg1:.4f}), peak device "
        f"memory {pg / 2**20:.1f} MiB ({base / 2**20:.1f} MiB held before "
        f"it); one call a frame {(tf0 + tf1) / 2:.4f} s ({tf0:.4f}, "
        f"{tf1:.4f}), peak {pf / 2**20:.1f} MiB; launches {json.dumps(lg)} "
        f"| {json.dumps(lf)}")
    log(f"  group against one call a frame: "
        f"{'every result equal' if not diff else f'differences {diff}'}")
    runs = []
    for fn in (group, frames):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        runs.append(sum(ev.count for ev in prof.key_averages()
                        if ev.device_type == DeviceType.CUDA
                        and "memcpy" not in ev.key.lower()
                        and "memset" not in ev.key.lower()))
    log(f"  device kernel runs (torch.profiler): one call {runs[0]}, one "
        f"call a frame {runs[1]} ({runs[1] / nf:.0f} a frame)")


def phase_cli(dev, tmp, frames, launches_fpmt, payloads, shown) -> dict:
    """The clip as y4m (utils/y4m), encoded by apps.enc with --tpu --fp-mt
    1 in this process and decoded by apps.dec: the stream is the FPMT
    GOP's, its launches are too, and the y4m holds the frames the port's
    decoder showed for it."""
    from aom_av1_lavish_torch.apps import dec, enc
    from aom_av1_lavish_torch.parallel import sharding
    from aom_av1_lavish_torch.utils.y4m import read_y4m, write_y4m

    src = os.path.join(tmp, "clip.y4m")
    ivf = os.path.join(tmp, "cli.ivf")
    out = os.path.join(tmp, "cli.y4m")
    t0 = time.perf_counter()
    write_y4m(src, frames, W, H)
    t_write = time.perf_counter() - t0
    groups = []

    def run():
        with launches_per_call(sharding, "fpmt_encode_group", groups):
            rc = enc.main([src, "-o", ivf, "--tpu", "--fp-mt", "1",
                           "--enable-cdef", "0", "--cq-level", str(QINDEX),
                           "--gf-length", "8", "-q"])
        if rc != 0:
            raise AssertionError(f"apps.enc exited with {rc}")

    _, secs, launches = timed_path(
        f"CLI apps.enc --tpu --fp-mt 1 {W}x{H}, {N_FRAMES} frames", run,
        need=ALL_KERNELS, expected=launches_fpmt)
    require_group_launches("CLI", groups)
    if read_payloads(ivf) != payloads:
        raise AssertionError("CLI: the stream differs from the FPMT GOP's")
    t0 = time.perf_counter()
    if dec.main([ivf, "-o", out]) != 0:
        raise AssertionError("apps.dec failed")
    t_dec = time.perf_counter() - t0
    got, w, h, _ = read_y4m(out)
    if len(got) != N_FRAMES or (w, h) != (W, H):
        raise AssertionError(f"CLI: {len(got)} frames of {w}x{h} decoded")
    for g, s in zip(got, shown):
        require_planes_equal("CLI decode", g, s[:3])
    log(f"  y4m written in {t_write:.3f} s; the IVF equals the FPMT GOP's "
        f"stream; apps.dec: {len(got)} frames in {t_dec:.3f} s, equal to "
        "the port decoder's")
    return launches


def phase_sharded_lossless(dev, frames) -> dict:
    """ShardedLosslessEncoder at 1920x1088 on make_mesh(2, 2) (two frames
    a batch, two tile columns): the single-device LosslessEncoder's bytes
    with tile_cols_log2=1, decoded to the source."""
    from aom_av1_lavish_torch.encoder.encoder import (
        LosslessEncoder, make_lossless_frame_header, make_sequence_header)
    from aom_av1_lavish_torch.parallel.sharding import (
        ShardedLosslessEncoder, make_mesh)

    payloads, secs, launches = timed_path(
        f"sharded lossless {W}x{H}, {len(frames)} frames, mesh (2, 2)",
        lambda: ShardedLosslessEncoder(W, H, make_mesh(2, 2, device=dev))
        .encode_frames(frames), expected={k: 0 for k in ALL_KERNELS})
    sh = make_sequence_header(W, H)
    for f, p in zip(frames, payloads):
        e = LosslessEncoder(sh, make_lossless_frame_header(
            sh, tile_cols_log2=1))
        e.device = dev
        if e.encode_frame(f) != p:
            raise AssertionError("sharded lossless: differs from the "
                                 "single-device encoder with 2 tiles")
    shown, _ = decode_payloads(payloads)
    if len(shown) != len(frames):
        raise AssertionError(f"decoded {len(shown)} frames")
    for f, d in zip(frames, shown):
        require_planes_equal("sharded lossless", d[:3], f)
    log(f"  equal to LosslessEncoder(tile_cols_log2=1); decoded to the "
        f"source; {secs / len(frames):.3f} s per frame")
    return {"sharded_lossless": launches}


def timed_pair(dev, fn):
    """fn(device) on the card and on the CPU -> (results, host seconds)."""
    got, secs = [], []
    for device in (dev, "cpu"):
        t0 = time.perf_counter()
        got.append(fn(device))
        secs.append(time.perf_counter() - t0)
    return got, secs


@contextlib.contextmanager
def returns_of(owner, name: str, out: list):
    """Wraps `owner.<name>` while the block runs: each call's return value
    is appended to `out`."""
    orig = getattr(owner, name)

    def spy(*a, **k):
        res = orig(*a, **k)
        out.append(res)
        return res

    setattr(owner, name, spy)
    try:
        yield out
    finally:
        setattr(owner, name, orig)


#: the fields of a result row before its coefficients
ROW_FIELDS = ("mv_r", "mv_c", "ref", "eob_y", "eob_u", "eob_v")


def first_group_difference(got, want, W_: int,
                           names=("card", "CPU")) -> str:
    """The first difference between two lists of group results ((raws,
    recons) a group call, host arrays; a recon may be None) -> where it
    lies and both values, named by `names`, or '' when they are equal."""
    import numpy as np

    na, nb = names
    for g, ((raws_a, recs_a), (raws_b, recs_b)) in enumerate(zip(got, want)):
        for j, (a, b) in enumerate(zip(raws_a, raws_b)):
            if a["filt"] != b["filt"]:
                return (f"group call {g}, frame {j}: interp filter {na} "
                        f"{a['filt']}, {nb} {b['filt']}")
            for k in ("lvl", "r16", "r32", "r64"):
                x, y = np.asarray(a[k]), np.asarray(b[k])
                diff = np.argwhere(x != y)
                if len(diff) == 0:
                    continue
                idx = tuple(int(i) for i in diff[0])
                where = f"{k}{list(idx)}"
                if k != "lvl":
                    bsz = {"r16": 16, "r32": 32, "r64": 64}[k]
                    per_row = W_ // bsz
                    field = (ROW_FIELDS[idx[1]] if idx[1] < 6
                             else f"coefficient {idx[1] - 6}")
                    where += (f" (block row {idx[0] // per_row}, column "
                              f"{idx[0] % per_row} of the {bsz} grid, "
                              f"{field})")
                return (f"group call {g}, frame {j}: {where} {na} "
                        f"{x[idx]}, {nb} {y[idx]}")
            ra, rb = recs_a[j], recs_b[j]
            if ra is not None and rb is not None:
                for p, (pa, pb) in enumerate(zip(ra, rb)):
                    diff = np.argwhere(np.asarray(pa) != np.asarray(pb))
                    if len(diff):
                        idx = tuple(int(i) for i in diff[0])
                        return (f"group call {g}, frame {j}: recon plane {p}"
                                f" at {list(idx)} {na} {pa[idx]}, {nb} "
                                f"{pb[idx]}")
    return ""


def full_range_frames(n: int, w: int, h: int) -> list:
    """make_frames' clip with each luma plane stretched to 0..255 (its
    chroma as it is): bright content, where the reference's SSD surface
    rounds (ROADMAP F1)."""
    import numpy as np

    from aom_av1_lavish_torch.utils.clips import make_frames

    out = []
    for y, u, v in make_frames(n, w, h):
        y = y.astype(np.float64)
        y = (y - y.min()) * 255.0 / (y.max() - y.min())
        out.append((np.round(y).astype(np.uint8), u, v))
    return out


#: the 1080p card-against-CPU GOPs: 4 frames, gf_length 4 (a wavefront
#: KEY, then a group of 3: the hidden ARF as a one-frame chain and two P
#: frames, chained or as one frame-parallel group)
FULL_HD_PAIR_FRAMES = 4


def phase_card_vs_cpu_1080p(dev) -> None:
    """The 1920x1088 GOP at cpu_used 8 and with frame-parallel groups
    (default configuration), 4 frames each, encoded on the card and on the
    CPU: the streams must be equal byte for byte.  On a difference the
    first differing TU and the first differing group result (frame, block,
    row field, both values) are printed before the failure."""
    from aom_av1_lavish_torch.encoder.gop import GopEncoder
    from aom_av1_lavish_torch.ops.inter import DeviceChainEncoder
    from aom_av1_lavish_torch.parallel import sharding
    from aom_av1_lavish_torch.utils.clips import make_frames

    frames = make_frames(FULL_HD_PAIR_FRAMES, W, H)
    for label, kw, owner, name in (
            ("cpu_used 8", KW_CPU8, DeviceChainEncoder, "encode_chain"),
            ("FPMT", KW_FPMT, sharding, "fpmt_encode_group")):
        kw = dict(kw, gf_length=FULL_HD_PAIR_FRAMES)
        groups = {}

        def run(d):
            with returns_of(owner, name, groups.setdefault(str(d), [])):
                return GopEncoder(W, H, device=d, **kw).encode_sequence(
                    frames)

        got, secs = timed_pair(dev, run)
        card, cpu = got
        sizes = (sum(map(len, card)), sum(map(len, cpu)))
        if card != cpu:
            tu = next((i for i, (a, b) in enumerate(zip(card, cpu))
                       if a != b), None)
            where = first_group_difference(groups[str(dev)], groups["cpu"],
                                           W)
            raise AssertionError(
                f"{W}x{H} {label}, {len(frames)} frames: the card's stream "
                f"({sizes[0]} bytes) differs from the CPU's ({sizes[1]} "
                f"bytes), first in TU {tu}; {where or 'group results equal'}"
                f" (card {secs[0]:.3f} s, CPU {secs[1]:.3f} s)")
        log(f"card vs CPU {W}x{H} {label}, {len(frames)} frames "
            f"(gf_length {FULL_HD_PAIR_FRAMES}; {len(groups['cpu'])} group "
            f"calls): {sizes[0]} bytes, equal (card {secs[0]:.3f} s, CPU "
            f"{secs[1]:.3f} s)")


def phase_card_vs_cpu(dev, tmp) -> None:
    """Every new path at 96x64 on the card and on the CPU: the same bytes
    (the first-pass stats to 1e-5); then the 352x288 cpu_used 8 GOP."""
    import numpy as np

    from aom_av1_lavish_torch.api import Encoder, EncoderConfig
    from aom_av1_lavish_torch.encoder import encode_lossless_ivf
    from aom_av1_lavish_torch.encoder.firstpass import first_pass
    from aom_av1_lavish_torch.encoder.gop import (GopEncoder, encode_gop_ivf,
                                                  encode_twopass_ivf)
    from aom_av1_lavish_torch.encoder.nonrd import encode_realtime_tpu_ivf
    from aom_av1_lavish_torch.encoder.tpu_inter import encode_tpu_lowdelay_ivf
    from aom_av1_lavish_torch.encoder.tpu_intra import encode_tpu_ivf
    from aom_av1_lavish_torch.encoder.tpu_rdo import encode_tpu_rdo_ivf
    from aom_av1_lavish_torch.parallel.sharding import (
        ShardedInterGopEncoder, make_mesh)
    from aom_av1_lavish_torch.utils.clips import make_frames

    w, h = 96, 64
    frames = make_frames(N_FRAMES, w, h)
    paths = (
        ("device-RDO all-intra", encode_tpu_rdo_ivf, frames[:2],
         dict(qindex=80)),
        ("default GOP (device-RDO KEY)", encode_gop_ivf, frames, KW_DEFAULT),
        ("low delay", encode_tpu_lowdelay_ivf, frames[:4], dict(qindex=60)),
        ("realtime", encode_realtime_tpu_ivf, frames[:4], dict(qindex=90)),
        ("gf_length 2", encode_gop_ivf, frames, dict(KW_CPU8, gf_length=2)),
        ("use_arf off", encode_gop_ivf, frames,
         dict(KW_CPU8, use_arf=False)),
        ("lossless", encode_lossless_ivf, frames[:2], {}),
        ("two-pass", encode_twopass_ivf, frames, KW_DEFAULT),
        ("batched all-intra", encode_tpu_ivf, frames[:3], dict(qindex=100)),
    )
    for name, fn, clip, kw in paths:
        got = []
        for device in (dev, "cpu"):
            path = os.path.join(tmp, f"small_{device}.ivf")
            fn(path, clip, w, h, device=device, **kw)
            with open(path, "rb") as f:
                got.append(f.read())
        if got[0] != got[1] or len(got[0]) <= 32:
            raise AssertionError(f"{name} at {w}x{h}: the card's stream "
                                 f"({len(got[0])} bytes) differs from the "
                                 f"CPU's ({len(got[1])} bytes)")
        log(f"card vs CPU {w}x{h} {name}: {len(got[0])} bytes, equal")

    def api(device, clip, **kw):
        enc = Encoder(EncoderConfig(width=w, height=h, device=device, **kw))
        for f in clip:
            enc.encode(f)
        return enc.flush()

    # the port's parallel/sharding and api entry points -> payload lists
    for name, fn in (
            ("FPMT GOP", lambda d: GopEncoder(
                w, h, device=d, **KW_FPMT).encode_sequence(frames)),
            ("ShardedInterGopEncoder", lambda d: ShardedInterGopEncoder(
                w, h, make_mesh(4, 1, device=d),
                qindex=80).encode_frames(frames[:5])),
            ("api.Encoder lossless", lambda d: api(d, frames[:2],
                                                   lossless=True)),
            ("api.Encoder GOP", lambda d: api(d, frames, **KW_DEFAULT))):
        got, secs = timed_pair(dev, fn)
        if got[0] != got[1] or not all(got[0]):
            raise AssertionError(f"{name} at {w}x{h}: the card's payloads "
                                 f"{[len(p) for p in got[0]]} differ from "
                                 f"the CPU's {[len(p) for p in got[1]]}")
        log(f"card vs CPU {w}x{h} {name}: {sum(map(len, got[0]))} bytes in "
            f"{len(got[0])} TUs, equal (card {secs[0]:.3f} s, CPU "
            f"{secs[1]:.3f} s)")
    for what, cif in (
            ("", make_frames(N_FRAMES, 352, 288)),
            (", luma stretched to 0..255", full_range_frames(N_FRAMES, 352,
                                                             288))):
        got, secs = timed_pair(dev, lambda d, cif=cif: b"".join(GopEncoder(
            352, 288, device=d, **KW_CPU8).encode_sequence(cif)))
        if got[0] != got[1]:
            at = next((i for i, (x, y) in enumerate(zip(*got)) if x != y),
                      min(map(len, got)))
            raise AssertionError(f"352x288 cpu_used 8{what}: the card's "
                                 f"stream ({len(got[0])} bytes) differs from"
                                 f" the CPU's ({len(got[1])} bytes), first "
                                 f"at byte {at}")
        log(f"card vs CPU 352x288 cpu_used 8{what}, {N_FRAMES} frames: "
            f"{len(got[0])} bytes, equal (card {secs[0]:.3f} s, CPU "
            f"{secs[1]:.3f} s)")
    a = np.stack([s.to_array() for s in first_pass(frames, device=dev)])
    b = np.stack([s.to_array() for s in first_pass(frames, device="cpu")])
    if not np.allclose(a, b, rtol=1e-5, atol=0):
        raise AssertionError("first pass at 96x64: the card's stats differ "
                             "from the CPU's beyond 1e-5")
    log(f"card vs CPU {w}x{h} first pass: stats agree to 1e-5 "
        f"(max relative difference "
        f"{float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30))):.2e})")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--warm", type=int, default=0, metavar="N",
                    help="run each configuration's slice N more times and "
                    "print medians")
    ap.add_argument("--profile", action="store_true",
                    help="run one more default-configuration slice, and one "
                    "with frame-parallel groups, under torch.profiler")
    ap.add_argument("--before", nargs="+", default=[], metavar="DIR",
                    help="checkouts of other commits: time each one's K2 "
                    "plane kernel beside this one's at K2's headline shapes")
    opts = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from aom_av1_lavish_torch.ops import build
    from aom_av1_lavish_torch.runtime import native_available
    from aom_av1_lavish_torch.utils.clips import make_frames

    dev = torch.device("cuda")
    t_start = time.perf_counter()

    def lap(what: str) -> None:
        log(f"[{time.perf_counter() - t_start:.1f} s] {what} done")

    card = gpu_line()
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda "
        f"{torch.version.cuda}; card: {card}")
    if not native_available():
        raise RuntimeError("native runtime (gcc build) unavailable")
    t0 = time.perf_counter()
    so = build.build()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s: "
        f"{os.path.relpath(so, ROOT)}")
    ptx = so.with_suffix(".log")
    if ptx.exists():
        for line in ptx.read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log("  " + line.strip())

    recs = phase_kernels(dev)
    lap("kernel cases")
    phase_before_after(dev, opts.before)
    lap("before/after pairs")
    frames = make_frames(N_FRAMES, W, H)
    phase_programs(dev, frames)
    lap("P-frame programs")
    launches8 = phase_slice(dev, frames, "cpu_used 8", KW_CPU8)
    launches = phase_slice(dev, frames, "default", KW_DEFAULT)
    lap("slices")
    if opts.warm:
        phase_warm(dev, frames, "cpu_used 8", KW_CPU8, opts.warm)
        phase_warm(dev, frames, "default", KW_DEFAULT, opts.warm)
        phase_warm(dev, frames, "FPMT", KW_FPMT, opts.warm)
    if opts.profile:
        phase_profile(dev, frames, "default", KW_DEFAULT)
        phase_profile(dev, frames, "FPMT", KW_FPMT)
    phase_decode(dev, make_frames(N_FRAMES, 352, 288), 352, 288,
                 "cpu_used 8", KW_CPU8)
    phase_decode(dev, make_frames(N_FRAMES, 768, 576), 768, 576, "default",
                 KW_DEFAULT)
    lap("warm runs, profile and decode checks")

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    by_path = {}
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        by_path["fpmt"], fpmt_payloads, fpmt_shown, group_call = phase_fpmt(
            dev, frames, launches)
        lap("FPMT")
        phase_fpmt_group(dev, group_call)
        lap("FPMT group alone")
        by_path["cli"] = phase_cli(dev, tmp, frames, by_path["fpmt"],
                                   fpmt_payloads, fpmt_shown)
        lap("CLI")
        by_path.update(phase_sharded_lossless(dev, frames[:2]))
        lap("sharded lossless")
        by_path.update(phase_rdo_key(dev, tmp))
        by_path.update(phase_lowdelay(dev, tmp, frames[:4]))
        by_path.update(phase_realtime(dev, tmp, frames[:4]))
        by_path.update(phase_short_groups(dev))
        by_path.update(phase_lossless(dev, tmp, frames[:2]))
        by_path.update(phase_twopass(dev, tmp, frames))
        by_path.update(phase_intra_batch(dev, tmp, frames[:4]))
        lap("the other device paths")
        phase_card_vs_cpu(dev, tmp)
        phase_card_vs_cpu_1080p(dev)
        lap("card against CPU")

    # launches: the default-configuration slice's (this script's main
    # path), K1's two entries apart; the cpu_used 8 slice's and each other
    # path's beside them
    kernels = []
    for name, rec in recs.items():
        key = KERNELS[name][3]
        kernels.append(dict(
            rec, launches=launches.get(key, 0),
            launches_cpu_used_8=launches8.get(key, 0),
            launches_by_path={p: v.get(key, 0) for p, v in by_path.items()}))
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    # any import of jax or of the JAX package now raises ImportError
    sys.modules["jax"] = None
    sys.modules["aom_av1_lavish_tpu"] = None
    sys.exit(main())
