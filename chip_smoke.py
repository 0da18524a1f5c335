#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (aom_av1_lavish_torch) on one GPU.

    python3 chip_smoke.py [--warm N] [--profile]

1. Builds the hand-written CUDA kernels (ops/csrc/*.cu) into
   build/torch_kernels/ and holds each kernel entry against its plain
   PyTorch version on the card at the shapes of the 1080p slice,
   requiring exact equality, and times both with CUDA events (and the
   kernel once more from a CUDA graph, without the host).  Each kernel's
   bound (the least time the card could take: its bytes at the
   memory rate or its operations at the peak rate, whichever is larger)
   is computed from the case's tensors.
2. Times the call paths that the plane-form entries of K2 and K3 and the
   fused form of K1 replaced (cut windows -> int32 -> ssd_surface; gather
   -> int32 -> convolve_8tap; nine gathers each with its subtract, square
   and sum) beside the new forms, in turns, on the same inputs.
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

With --warm N each configuration's slice is run N more times and the
stage medians are printed; with --profile one more default-configuration
slice runs under torch.profiler and the device time of each hand kernel
and the device-busy share are printed.

Only the port is imported: jax and the JAX package are blocked.  Prints the
card's name and power limit, one JSON line with each kernel's record, and
as its last line {"ok": true, "device": {...}}.  Exits non-zero, before
that line, on any failure, and when no CUDA device is available.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
W, H, N_FRAMES, QINDEX = 1920, 1088, 8, 120
PADR = 64
KW_DEFAULT = dict(qindex=QINDEX, gf_length=8, use_tpu=True,
                  enable_cdef=False)
KW_CPU8 = dict(KW_DEFAULT, cpu_used=8)
PK = "aom_av1_lavish_tpu/ops/pallas_kernels.py"
CSRC = "aom_av1_lavish_torch/ops/csrc"
#: record name -> (source, the TPU kernel it replaces, the LAUNCHES key its
#: launches count under, the key its own launches are read from).  K1's two
#: entries have a record each (block_ssd_at is its fused form): both count
#: under LAUNCHES["gather_windows"] and are told apart by ENTRY_LAUNCHES
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
                       "quantize_b_vec", "quantize_b_vec"),
}
#: the device function(s) of each kernel, as a profiler names them
DEVICE_FUNCS = {
    "gather_windows": ("gather_windows_kernel", "gather_flat_kernel",
                       "block_ssd_at_kernel"),
    "ssd_surface": ("ssd_plane_kernel", "ssd_surface_kernel"),
    "convolve_8tap": ("conv8_plane_kernel", "convolve_8tap_kernel"),
    "quantize_b_vec": ("quantize_b_kernel",),
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


def _cases(dev):
    """(kernel name, wrapper name, label, args, operations) at the
    slice's shapes, made from a seed; the wrapper `K.<wrapper name>` and
    its plain version `K.<wrapper name>_plain` take the same args.
    `operations` is (count, operand type) of the integer operations the
    function does on these inputs.  The first case of a kernel is its
    headline: the entry and shape the slice calls most."""
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

    def ssd_ops(n_blk, bsz, r, kind):
        # subtract, multiply, add per pixel pair
        return 3 * n_blk * (2 * r + 1) ** 2 * bsz * bsz, kind

    # K2 from planes: the full-res (uint8, bsz 16) and half-res (int32 2x2
    # sums, bsz 8) surfaces of a PADR-padded 1080p reference, r 16,
    # ordinary and bright inputs; then grids whose width is no multiple
    # of the kernel's block group and whose addresses are not 16-byte
    # aligned, and the other dtype at each block size
    for dtype, bsz, lo, hi in ((np.uint8, 16, 0, 256),
                               (np.uint8, 16, 240, 256),
                               (np.int32, 8, 0, 1021),
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
                           (8, 16, 0, 1021), (8, 16, 960, 1021),
                           (16, 8, 0, 256)):
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
    return cases


def bound_ms(args, outs, operations):
    """(ms, "bytes" | "operations"): the larger of the tensors' bytes
    (each input read once, each output written once) at the card's memory
    rate and the operations at the peak rate of their type."""
    import torch
    nbytes = sum(a.numel() * a.element_size() for a in (*args, *outs)
                 if isinstance(a, torch.Tensor))
    count, kind = operations
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = count / OPS_PER_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(dev) -> dict:
    """Each kernel entry against its plain version: exact, with times."""
    import torch

    from aom_av1_lavish_torch.ops import kernels as K

    recs = {name: dict(name=name, route="cuda", source=src, replaces=rep,
                       max_abs_err=0.0, ms=None, plain_ms=None,
                       bound_ms=None, bound_by=None, library_ms=None,
                       graph_ms=None)
            for name, (src, rep, _, _) in KERNELS.items()}
    log(f"{'kernel':<15} {'entry and shape':<47} {'max_err':>7} "
        f"{'kernel ms':>10} {'graph ms':>9} {'plain ms':>10} "
        f"{'bound ms':>9} by")
    n_cases = 0
    for name, fn, label, args, operations in _cases(dev):
        wrapper = getattr(K, fn)
        plain = getattr(K, fn + "_plain")
        got = wrapper(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = 0.0
        for g, w in zip(got, want):
            if g.shape != w.shape or g.dtype != w.dtype:
                raise AssertionError(f"{name} {label}: {tuple(g.shape)} "
                                     f"{g.dtype} vs {tuple(w.shape)} "
                                     f"{w.dtype}")
            err = max(err, float((g.double() - w.double()).abs().max())
                      if g.numel() else 0.0)
        ms = cuda_ms(lambda: wrapper(*args))
        g_ms = graph_ms(lambda: wrapper(*args))
        plain_ms = cuda_ms(lambda: plain(*args), reps=3)
        b_ms, b_by = bound_ms(args, got, operations)
        log(f"{name:<15} {label:<47} {err:>7g} {ms:>10.4f} {g_ms:>9.4f} "
            f"{plain_ms:>10.4f} {b_ms:>9.4f} {b_by}")
        rec = recs[name]
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        if rec["ms"] is None:          # the first case is the headline one
            rec.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                       bound_by=b_by, graph_ms=g_ms)
        if err != 0.0:
            raise AssertionError(f"{name} {label}: kernel differs from its "
                                 f"plain version (max abs err {err})")
        n_cases += 1
    log(f"{n_cases} cases bit-equal to their plain versions")
    return recs


def phase_before_after(dev) -> None:
    """The call paths of the earlier slices beside the entries that
    replaced them (the plane forms of K2 and K3, the fused form of K1), on
    the same 1080p inputs, timed in turns (before, after, after, before)
    and reported as the mean of each pair, and once each from a CUDA graph
    (the device's time without the host's)."""
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

    for label, before, after in (
            ("K2 full res: windows -> int32 -> ssd_surface | "
             "ssd_surface_plane (uint8, bsz16 r16)", k2_before, k2_after),
            ("K2 half res: windows -> ssd_surface | ssd_surface_plane "
             "(int32, bsz8 r16)", k2h_before, k2h_after),
            ("K3 16x16: gather -> int32 -> convolve_8tap | "
             "convolve_8tap_plane", k3_before, k3_after),
            ("K1 refine 3x3: 9 x (gather_windows, float, subtract, square, "
             "sum) | block_ssd_at", k1_before, k1_after)):
        if not torch.equal(before(), after()):
            raise AssertionError(f"{label}: the two call paths differ")
        b0 = cuda_ms(before)
        a0 = cuda_ms(after)
        a1 = cuda_ms(after)
        b1 = cuda_ms(before)
        log(f"before/after B{B} {label}: {(b0 + b1) / 2:.4f} ms "
            f"({b0:.4f}, {b1:.4f}) | {(a0 + a1) / 2:.4f} ms "
            f"({a0:.4f}, {a1:.4f}); from a graph {graph_ms(before):.4f} | "
            f"{graph_ms(after):.4f} ms")


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
    want = {"gop/key", "gop/arf_encode", "gop/chain_device", "gop/emit"}
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
            if k.startswith("gop/"):
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
        " MiB")


def phase_profile(dev, frames, kw) -> None:
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
    log(f"profiled slice: {secs:.3f} s wall clock under the profiler, "
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--warm", type=int, default=0, metavar="N",
                    help="run each configuration's slice N more times and "
                    "print medians")
    ap.add_argument("--profile", action="store_true",
                    help="run one more default-configuration slice under "
                    "torch.profiler")
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
    phase_before_after(dev)
    frames = make_frames(N_FRAMES, W, H)
    launches8 = phase_slice(dev, frames, "cpu_used 8", KW_CPU8)
    launches = phase_slice(dev, frames, "default", KW_DEFAULT)
    if opts.warm:
        phase_warm(dev, frames, "cpu_used 8", KW_CPU8, opts.warm)
        phase_warm(dev, frames, "default", KW_DEFAULT, opts.warm)
    if opts.profile:
        phase_profile(dev, frames, KW_DEFAULT)
    phase_decode(dev, make_frames(N_FRAMES, 352, 288), 352, 288,
                 "cpu_used 8", KW_CPU8)
    phase_decode(dev, make_frames(N_FRAMES, 768, 576), 768, 576, "default",
                 KW_DEFAULT)

    # launches: the default-configuration slice's (this script's main
    # path), K1's two entries apart; the cpu_used 8 slice's beside them
    kernels = []
    for name, rec in recs.items():
        key = KERNELS[name][3]
        kernels.append(dict(rec, launches=launches.get(key, 0),
                            launches_cpu_used_8=launches8.get(key, 0)))
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
