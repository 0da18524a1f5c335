"""The four hand-written Hopper kernels of the encoder's device path.

Each kernel of aom_av1_lavish_tpu/ops/pallas_kernels.py becomes a CUDA
C++ kernel in ops/csrc/, built by ops/build.py and called through ctypes:

  K1 gather_windows — csrc/gather_windows.cu  (_gather_win_kernel)
  K2 ssd_surface    — csrc/ssd_surface.cu     (_ssd_lane_kernel and
                                               _ssd_kernel)
  K3 convolve_8tap  — csrc/convolve_8tap.cu   (_conv8_kernel)
  K4 quantize_b_vec — csrc/quantize_b.cu      (_quant_kernel)
     wave_encode    — csrc/wave_encode.cu     (_quant_kernel's inline twin
                                               with its producer and its
                                               consumers in a wave of the
                                               wavefront KEY)
     code_residual  — csrc/code_residual.cu   (the same twin with the
                                               residual coding of a P
                                               frame's plane around it)

Every kernel has two entries or more.  ssd_surface and convolve_8tap take
the windows and regions the Pallas kernels took; ssd_surface_plane and
convolve_8tap_plane take the padded reference plane and cut the windows
and regions themselves, inside the kernel, which is what the motion search
and motion compensation call (the windows never exist in device memory).
gather_windows copies the windows out; block_ssd_at, which the full-pel
refine calls, reads them and returns only each block's SSD at each of its
candidate origins.  quantize_b_vec quantizes rows of coefficients;
wave_encode, which the wavefront KEY calls, codes one whole wave of 16x16
blocks in one launch (edges, predictions, transforms, the quantizer, rate
estimate, inverse, mode decision, outputs); code_residual, which the P
frames call, codes one plane's blocks at one transform size in one launch
(residual, forward DCT, quantizer, tail dropout, rate estimate, inverse,
recon).  All entries of a kernel count under its one name.

Beside each wrapper sits its plain PyTorch version (integer math, no
convolution library), which takes the same tensors on any device.  A
wrapper runs the plain version only when its tensors lie on the CPU; on
CUDA tensors it launches the kernel, or raises.  Each launch adds one to
LAUNCHES[name] (and to ENTRY_LAUNCHES under the C entry's name), so a run
can show which kernels, and which of their entries, its path went through.
A CUDA graph that replays launches (ops/graphs.py) adds its capture's
counts on every replay, and its warm-up and capture count nothing.
What bounds each kernel on the H100 is noted at the top of its source.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from ..bitstream import constants as c
from ..bitstream import tables
from ..common import coeffs as CF
from ..common import txfm1d as T1
from ..common import txfm2d as T2
from ..common.intra import SMOOTH_WEIGHTS

from .txfm import fwd_txfm2d_batched, inv_txfm2d_add_batched

LAUNCHES = {"gather_windows": 0, "ssd_surface": 0, "convolve_8tap": 0,
            "quantize_b_vec": 0}
#: the same launches by the C entry they went through (a kernel's two
#: entries apart), filled as entries are used
ENTRY_LAUNCHES: dict[str, int] = {}

_VP = ctypes.c_void_p
_INT = ctypes.c_int
_LL = ctypes.c_longlong
_SIGNATURES = {
    "avl_gather_windows": [_VP, _VP, _VP, _VP, _INT, _INT, _INT, _INT,
                           _INT, _INT, _VP],
    "avl_block_ssd_at": [_VP, _VP, _VP, _VP, _VP, _INT, _INT, _INT, _INT,
                         _INT, _INT, _INT, _INT, _LL, _VP],
    "avl_ssd_surface": [_VP, _VP, _VP, _INT, _INT, _INT, _VP],
    "avl_ssd_surface_plane": [_VP, _VP, _VP, _INT, _INT, _INT, _INT, _INT,
                              _INT, _INT, _INT, _INT, _INT, _LL, _VP],
    "avl_convolve_8tap": [_VP, _VP, _VP, _VP, _INT, _INT, _INT, _VP],
    "avl_convolve_8tap_plane": [_VP, _VP, _VP, _VP, _VP, _VP, _INT, _INT,
                                _INT, _INT, _VP],
    "avl_quantize_b": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _LL, _INT,
                       _INT, _LL, _VP],
    "avl_wave_encode": [_VP] * 11 + [_INT] * 6
    + [ctypes.c_float, ctypes.c_float, _VP],
    "avl_code_residual": [_VP] * 5 + [_INT] + [_VP] * 4 + [_INT] * 4
    + [ctypes.c_float, ctypes.c_float, _INT, _VP],
}
_lib = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    ENTRY_LAUNCHES.clear()


def launch_counts() -> tuple[dict, dict]:
    """A copy of (LAUNCHES, ENTRY_LAUNCHES)."""
    return dict(LAUNCHES), dict(ENTRY_LAUNCHES)


def set_launch_counts(counts: tuple[dict, dict]) -> None:
    """Puts back counts that launch_counts() returned."""
    LAUNCHES.update(counts[0])
    ENTRY_LAUNCHES.clear()
    ENTRY_LAUNCHES.update(counts[1])


def launches_between(before: tuple[dict, dict],
                     after: tuple[dict, dict]) -> tuple[dict, dict]:
    """The launches counted from `before` to `after` (both from
    launch_counts()), as a pair of dicts of the same kind."""
    return tuple({k: v - b.get(k, 0) for k, v in a.items()
                  if v != b.get(k, 0)} for b, a in zip(before, after))


def add_launches(counts: tuple[dict, dict]) -> None:
    """Counts launches made without a wrapper's call: those that a CUDA
    graph replays (launches_between of its capture)."""
    for total, add in zip((LAUNCHES, ENTRY_LAUNCHES), counts):
        for k, v in add.items():
            total[k] = total.get(k, 0) + v


def _kernel(name: str):
    """The C launcher `name` from the built library (built on first use)."""
    global _lib
    if _lib is None:
        from .build import load
        lib = load()
        for fn, argtypes in _SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _lib = lib
    return getattr(_lib, name)


def _on_cpu(name: str, *tensors) -> bool:
    """True when every tensor lies on the CPU, False when all lie on one
    CUDA device; anything else is an error."""
    devs = {t.device for t in tensors}
    if all(d.type == "cpu" for d in devs):
        return True
    if len(devs) == 1 and next(iter(devs)).type == "cuda":
        return False
    raise ValueError(f"{name}: tensors on {sorted(map(str, devs))}; "
                     "expected all on the CPU or all on one CUDA device")


def _require(cond: bool, name: str, what: str) -> None:
    if not cond:
        raise ValueError(f"{name}: {what}")


def _launch(name: str, fn: str, *args) -> None:
    stream = torch.cuda.current_stream().cuda_stream
    rc = _kernel(fn)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{rc}")
    LAUNCHES[name] += 1
    ENTRY_LAUNCHES[fn] = ENTRY_LAUNCHES.get(fn, 0) + 1


# ---------------------------------------------------------------------------
# K1: window gather


def gather_windows_plain(plane, base_r, base_c, wr: int, wc: int):
    """plane (H, W); base_r/base_c (B,) -> (B, wr, wc) windows at each
    block's origin, indices clamped to the plane."""
    H, W = plane.shape
    dev = plane.device
    rr = (base_r.long()[:, None, None]
          + torch.arange(wr, device=dev)[None, :, None]).clamp(0, H - 1)
    cc = (base_c.long()[:, None, None]
          + torch.arange(wc, device=dev)[None, None, :]).clamp(0, W - 1)
    return plane[rr, cc]


def gather_windows(plane, base_r, base_c, wr: int, wc: int):
    """K1 (replaces pallas_kernels.gather_windows): uint8 or int32 plane
    (H, W), int32 origins (B,) -> (B, wr, wc) of the plane's dtype."""
    name = "gather_windows"
    _require(plane.dim() == 2 and plane.dtype in (torch.uint8, torch.int32),
             name, "plane must be a 2-D uint8 or int32 tensor")
    _require(base_r.dim() == 1 and base_r.shape == base_c.shape
             and base_r.dtype == torch.int32
             and base_c.dtype == torch.int32, name,
             "base_r/base_c must be int32 (B,) tensors")
    _require(wr > 0 and wc > 0, name, "wr and wc must be positive")
    if _on_cpu(name, plane, base_r, base_c):
        return gather_windows_plain(plane, base_r, base_c, wr, wc)
    plane = plane.contiguous()
    base_r = base_r.contiguous()
    base_c = base_c.contiguous()
    B = base_r.shape[0]
    out = torch.empty((B, wr, wc), dtype=plane.dtype, device=plane.device)
    if B:
        _launch(name, "avl_gather_windows", out.data_ptr(),
                plane.data_ptr(), base_r.data_ptr(), base_c.data_ptr(), B,
                plane.shape[0], plane.shape[1], wr, wc,
                plane.element_size())
    return out


def block_ssd_at_plain(src, ref, base_r, base_c, nby: int, nbx: int,
                       bsz: int):
    """Integer SSD of block b of the source grid (block (by, bx) is
    src[by*bsz:, bx*bsz:]) against the (bsz, bsz) window of ref at each of
    its candidate origins (base_r[b, k], base_c[b, k]), window indices
    clamped to ref as gather_windows clamps them -> (B, C) int32.  With a
    (F, H, W) stack of source planes the origins and the result are
    (F, B, C): frame f's blocks against the one reference."""
    blk = stride_windows(src, 0, 0, nby, nbx, bsz, bsz).to(torch.int32)
    out = []
    for k in range(base_r.shape[-1]):
        win = gather_windows_plain(ref, base_r[..., k].reshape(-1),
                                   base_c[..., k].reshape(-1), bsz, bsz)
        d = win.reshape(blk.shape).to(torch.int32) - blk
        out.append((d * d).sum((-2, -1), dtype=torch.int32))
    return torch.stack(out, -1)


def block_ssd_at(src, ref, base_r, base_c, nby: int, nbx: int, bsz: int):
    """K1 fused with the SSD that follows it: uint8 source plane
    (>= nby*bsz, >= nbx*bsz), uint8 reference plane (H, W), int32 origins
    (nby*nbx, C) -> (nby*nbx, C) int32, exact (at most bsz*bsz*255^2).
    One launch where the caller would gather C windows per block and
    subtract, square and sum each.  A (F, h, w) stack of source planes
    with (F, nby*nbx, C) origins takes every frame's blocks against the
    one reference in the same launch -> (F, nby*nbx, C).  bsz is 8 or 16
    on the card."""
    name = "gather_windows"
    B = nby * nbx
    _require(src.dim() in (2, 3) and ref.dim() == 2
             and src.dtype == torch.uint8 and ref.dtype == torch.uint8, name,
             "block_ssd_at: src (a plane or a (F, h, w) stack) and ref must "
             "be uint8 planes")
    lead = tuple(src.shape[:-2])
    _require(nby > 0 and nbx > 0 and src.shape[-2] >= nby * bsz
             and src.shape[-1] >= nbx * bsz, name,
             f"block_ssd_at: src {tuple(src.shape)} does not hold "
             f"{nby}x{nbx} blocks of {bsz}")
    grid = ", ".join(map(str, lead + (B,)))
    _require(base_r.dim() == len(lead) + 2
             and tuple(base_r.shape[:-1]) == lead + (B,)
             and base_r.shape == base_c.shape
             and base_r.dtype == torch.int32
             and base_c.dtype == torch.int32, name,
             f"block_ssd_at: base_r/base_c must be int32 ({grid}, C) "
             "tensors")
    if _on_cpu(name, src, ref, base_r, base_c):
        return block_ssd_at_plain(src, ref, base_r, base_c, nby, nbx, bsz)
    _require(bsz in (8, 16), name, "block_ssd_at takes bsz 8 or 16")
    src = src.contiguous()
    ref = ref.contiguous()
    base_r = base_r.contiguous()
    base_c = base_c.contiguous()
    n_frames = lead[0] if lead else 1
    C = base_r.shape[-1]
    out = torch.empty(lead + (B, C), dtype=torch.int32, device=ref.device)
    if C and n_frames:
        _launch(name, "avl_block_ssd_at", out.data_ptr(), src.data_ptr(),
                ref.data_ptr(), base_r.data_ptr(), base_c.data_ptr(), B, C,
                nbx, bsz, src.shape[-1], ref.shape[0], ref.shape[1],
                n_frames, src.shape[-2] * src.shape[-1])
    return out


# ---------------------------------------------------------------------------
# K2: SSD surface


def ssd_value_plain(s2, w2, c):
    """A surface entry from S2 = sum(s^2), W2 = sum(w^2) and C = sum(s*w)
    over one candidate position, each summed exactly in int32 -> float32,
    rounded as the JAX package's surface rounds: e_src + e_ref - 2*corr in
    float32.  Where S2, W2 and C all lie in [0, 2^24) every partial sum of
    the reference is an exact integer, in any order, and its one rounding
    is the add S2 + W2, so the entry is R(S2 + W2) - 2C (R: to nearest
    even float32; S2 + W2 < 2^25, and the subtraction is exact).  Past
    2^24 the reference's value depends on the order in which XLA sums
    (only half-resolution int32 planes get there): the entry is then the
    exact S2 + W2 - 2C, converted once."""
    order_free = ((s2 | w2 | c) >> 24) == 0
    return torch.where(order_free,
                       (s2 + w2).to(torch.float32)
                       - (2 * c).to(torch.float32),
                       (s2 + w2 - 2 * c).to(torch.float32))


def ssd_sums_plain(src_blk, win, bsz: int, radius: int):
    """(B, bsz, bsz) source blocks x (B, W, W) windows -> S2 (B, 1, 1),
    W2 and C (B, 2r+1, 2r+1), int32: the sums of s^2, w^2 and s*w over
    each candidate position."""
    S = 2 * radius + 1
    src = src_blk.to(torch.int32)
    w = win.to(torch.int32)
    s2 = (src * src).sum((1, 2), dtype=torch.int32)[:, None, None]
    w2 = (w * w).unfold(1, bsz, 1).sum(-1, dtype=torch.int32) \
        .unfold(2, bsz, 1).sum(-1, dtype=torch.int32)
    rows = []
    for dy in range(S):
        band = w[:, dy:dy + bsz, :].unfold(2, bsz, 1)   # (B, bsz, S, bsz)
        rows.append((band * src[:, :, None, :]).sum((1, 3),
                                                    dtype=torch.int32))
    return s2, w2, torch.stack(rows, 1)


def ssd_surface_plain(src_blk, win, bsz: int, radius: int):
    """(B, bsz, bsz) source blocks x (B, W, W) windows -> (B, 2r+1, 2r+1)
    float32 SSD: S2, W2 and C summed exactly in int32, each entry rounded
    by ssd_value_plain."""
    return ssd_value_plain(*ssd_sums_plain(src_blk, win, bsz, radius))


def ssd_surface(src_blk, win, bsz: int, radius: int):
    """K2 (replaces pallas_kernels.ssd_surface): int32 src (B, bsz, bsz)
    and win (B, 2r+bsz, 2r+bsz) -> (B, 2r+1, 2r+1) float32, each entry
    rounded as the reference's surface rounds (ssd_value_plain)."""
    name = "ssd_surface"
    W = 2 * radius + bsz
    B = src_blk.shape[0]
    _require(src_blk.dtype == torch.int32 and win.dtype == torch.int32,
             name, "src_blk and win must be int32")
    _require(tuple(src_blk.shape) == (B, bsz, bsz)
             and tuple(win.shape) == (B, W, W), name,
             f"expected src (B,{bsz},{bsz}) and win (B,{W},{W}), got "
             f"{tuple(src_blk.shape)} and {tuple(win.shape)}")
    if _on_cpu(name, src_blk, win):
        return ssd_surface_plain(src_blk, win, bsz, radius)
    src_blk = src_blk.contiguous()
    win = win.contiguous()
    S = 2 * radius + 1
    out = torch.empty((B, S, S), dtype=torch.float32, device=win.device)
    if B:
        _launch(name, "avl_ssd_surface", out.data_ptr(),
                src_blk.data_ptr(), win.data_ptr(), B, bsz, radius)
    return out


def stride_windows(plane, oy: int, ox: int, nby: int, nbx: int, bsz: int,
                    wsz: int):
    """(nby*nbx, wsz, wsz) windows at stride bsz over a plane (a view
    until reshaped), window origin = block origin + (oy, ox); a (F, h, w)
    stack of planes gives (F, nby*nbx, wsz, wsz)."""
    span_r = (nby - 1) * bsz + wsz
    span_c = (nbx - 1) * bsz + wsz
    win = plane[..., oy:oy + span_r, ox:ox + span_c].unfold(-2, wsz, bsz) \
        .unfold(-2, wsz, bsz)                  # (..., nby, nbx, wsz, wsz)
    return win.reshape(*plane.shape[:-2], nby * nbx, wsz, wsz)


def ssd_surface_plane_plain(src, ref, nby: int, nbx: int, bsz: int,
                            radius: int, oy: int, ox: int):
    """ssd_surface_plain over the block grid of a source plane: block
    (by, bx) is src[by*bsz:, bx*bsz:] and its window starts at
    (oy + by*bsz, ox + bx*bsz) of ref -> (nby*nbx, 2r+1, 2r+1) float32,
    each entry rounded by ssd_value_plain's rule.
    A (F, h, w) stack of source planes, each against the one reference,
    gives (F, nby*nbx, 2r+1, 2r+1)."""
    W = 2 * radius + bsz
    win = stride_windows(ref, oy, ox, nby, nbx, bsz, W)
    blk = stride_windows(src, 0, 0, nby, nbx, bsz, bsz)
    lead = blk.shape[:-3]
    out = ssd_surface_plain(blk.reshape(-1, bsz, bsz),
                            win.expand(*lead, *win.shape).reshape(-1, W, W),
                            bsz, radius)
    return out.reshape(*lead, nby * nbx, *out.shape[1:])


def ssd_surface_plane(src, ref, nby: int, nbx: int, bsz: int, radius: int,
                      oy: int, ox: int):
    """K2 from planes: uint8 or int32 source plane (>= nby*bsz, >= nbx*bsz)
    and reference plane of the same dtype, which must hold every window:
    rows oy .. oy + (nby-1)*bsz + 2r+bsz, columns likewise from ox ->
    (nby*nbx, 2r+1, 2r+1) float32, each entry rounded by
    ssd_value_plain's rule.  A (F, h, w) stack of source planes is searched
    against the one reference in the same launch -> (F, nby*nbx, 2r+1,
    2r+1).  bsz is 8 or 16 on the card."""
    name = "ssd_surface"
    W = 2 * radius + bsz
    _require(src.dim() in (2, 3) and ref.dim() == 2
             and src.dtype == ref.dtype
             and src.dtype in (torch.uint8, torch.int32), name,
             "src (a plane or a (F, h, w) stack) and ref must be planes, "
             "both uint8 or both int32")
    _require(nby > 0 and nbx > 0 and radius >= 0 and oy >= 0 and ox >= 0,
             name, "nby, nbx must be positive; radius, oy, ox non-negative")
    _require(src.shape[-2] >= nby * bsz and src.shape[-1] >= nbx * bsz, name,
             f"src {tuple(src.shape)} does not hold {nby}x{nbx} blocks of "
             f"{bsz}")
    _require(ref.shape[0] >= oy + (nby - 1) * bsz + W
             and ref.shape[1] >= ox + (nbx - 1) * bsz + W, name,
             f"ref {tuple(ref.shape)} does not hold every {W}x{W} window "
             f"from ({oy}, {ox})")
    if _on_cpu(name, src, ref):
        return ssd_surface_plane_plain(src, ref, nby, nbx, bsz, radius, oy,
                                       ox)
    _require(bsz in (8, 16), name, "the plane form takes bsz 8 or 16")
    lead = tuple(src.shape[:-2])
    n_frames = lead[0] if lead else 1
    _require(0 < n_frames <= 65535, name, "1 to 65535 source planes")
    src = src.contiguous()
    ref = ref.contiguous()
    S = 2 * radius + 1
    out = torch.empty(lead + (nby * nbx, S, S), dtype=torch.float32,
                      device=ref.device)
    _launch(name, "avl_ssd_surface_plane", out.data_ptr(), src.data_ptr(),
            ref.data_ptr(), src.shape[-1], ref.shape[1], nby, nbx, bsz,
            radius, oy, ox, src.element_size(), n_frames,
            src.shape[-2] * src.shape[-1])
    return out


# ---------------------------------------------------------------------------
# K3: 8-tap separable sub-pel convolve


def convolve_8tap_plain(region, kx, ky, bh: int, bw: int):
    """Batched 8-bit av1_convolve_2d_sr: region (B, bh+7, bw+7) int32,
    per-block taps kx/ky (B, 8) -> (B, bh, bw) uint8."""
    region = region.to(torch.int32)
    kx = kx.to(torch.int32)
    ky = ky.to(torch.int32)
    acc = torch.zeros(region.shape[:1] + (bh + 7, bw), dtype=torch.int32,
                      device=region.device)
    for k in range(8):
        acc = acc + kx[:, k, None, None] * region[:, :, k:k + bw]
    im = (acc + (1 << 14) + (1 << 2)) >> 3
    acc2 = torch.zeros(region.shape[:1] + (bh, bw), dtype=torch.int32,
                       device=region.device)
    for k in range(8):
        acc2 = acc2 + ky[:, k, None, None] * im[:, k:k + bh, :]
    res = ((acc2 + (1 << 19) + (1 << 10)) >> 11) - ((1 << 8) + (1 << 7))
    return res.clamp(0, 255).to(torch.uint8)


def convolve_8tap(region, kx, ky, bh: int, bw: int):
    """K3 (replaces pallas_kernels.convolve_8tap)."""
    name = "convolve_8tap"
    B = region.shape[0]
    _require(region.dtype == torch.int32 and kx.dtype == torch.int32
             and ky.dtype == torch.int32, name,
             "region, kx and ky must be int32")
    _require(tuple(region.shape) == (B, bh + 7, bw + 7)
             and tuple(kx.shape) == (B, 8) and tuple(ky.shape) == (B, 8),
             name, f"expected region (B,{bh + 7},{bw + 7}) and taps (B,8)")
    if _on_cpu(name, region, kx, ky):
        return convolve_8tap_plain(region, kx, ky, bh, bw)
    region = region.contiguous()
    kx = kx.contiguous()
    ky = ky.contiguous()
    out = torch.empty((B, bh, bw), dtype=torch.uint8, device=region.device)
    if B:
        _launch(name, "avl_convolve_8tap", out.data_ptr(),
                region.data_ptr(), kx.data_ptr(), ky.data_ptr(), B, bh, bw)
    return out


def convolve_8tap_plane_plain(ref, base_r, base_c, kx, ky, bh: int,
                              bw: int):
    """convolve_8tap_plain on the (bh+7, bw+7) regions of a uint8 plane
    at origins (base_r, base_c), indices clamped to the plane."""
    region = gather_windows_plain(ref, base_r, base_c, bh + 7, bw + 7)
    return convolve_8tap_plain(region, kx, ky, bh, bw)


def _aligned16(t):
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def convolve_8tap_plane(ref, base_r, base_c, kx, ky, bh: int, bw: int):
    """K3 from a plane: uint8 plane (H, W), int32 region origins (B,) and
    int32 taps (B, 8) -> (B, bh, bw) uint8, the prediction of each block
    from the (bh+7, bw+7) region at its origin (clamped to the plane).
    On the card blocks are square, 8, 16, 32 or 64, and the taps of a
    block must have absolute values that sum to at most 963 (AV1's
    filter rows sum to at most 240), which keeps the 16-bit horizontal
    intermediate exact."""
    name = "convolve_8tap"
    B = base_r.shape[0]
    _require(ref.dim() == 2 and ref.dtype == torch.uint8, name,
             "ref must be a 2-D uint8 plane")
    _require(base_r.dim() == 1 and base_r.shape == base_c.shape
             and base_r.dtype == torch.int32
             and base_c.dtype == torch.int32, name,
             "base_r/base_c must be int32 (B,) tensors")
    _require(kx.dtype == torch.int32 and ky.dtype == torch.int32
             and tuple(kx.shape) == (B, 8) and tuple(ky.shape) == (B, 8),
             name, "kx and ky must be int32 (B, 8) tensors")
    if _on_cpu(name, ref, base_r, base_c, kx, ky):
        return convolve_8tap_plane_plain(ref, base_r, base_c, kx, ky, bh,
                                         bw)
    _require(bh == bw and bh in (8, 16, 32, 64), name,
             "the plane form takes square blocks of 8, 16, 32 or 64")
    ref = ref.contiguous()
    base_r = base_r.contiguous()
    base_c = base_c.contiguous()
    kx = _aligned16(kx)
    ky = _aligned16(ky)
    out = torch.empty((B, bh, bw), dtype=torch.uint8, device=ref.device)
    if B:
        _launch(name, "avl_convolve_8tap_plane", out.data_ptr(),
                ref.data_ptr(), base_r.data_ptr(), base_c.data_ptr(),
                kx.data_ptr(), ky.data_ptr(), B, ref.shape[0], ref.shape[1],
                bh)
    return out


# ---------------------------------------------------------------------------
# K4: quantizer


def quantize_b_vec_plain(coeff, zbin, rnd, quant, qshift, deq,
                         log_scale: int):
    """aom_quantize_b over (..., n) coefficients with per-position
    parameter vectors (n,), or with a row of them per frame, (F, n) for
    coefficients (F, ..., n); int32 math that wraps like the reference."""
    if zbin.dim() == 2:
        shape = (zbin.shape[0],) + (1,) * (coeff.dim() - 2) + (-1,)
        zbin, rnd, quant, qshift, deq = (p.reshape(shape) for p in
                                         (zbin, rnd, quant, qshift, deq))
    ac = coeff.abs()
    sign = torch.where(coeff < 0, -1, 1).to(torch.int32)
    above = ac >= zbin
    tmp = (ac + rnd).clamp(-32768, 32767)
    t = ((((tmp * quant) >> 16) + tmp) * qshift) >> (16 - log_scale)
    t = torch.where(above, t, 0)
    return sign * t, sign * ((t * deq) >> log_scale)


def quantize_b_vec(coeff, zbin, rnd, quant, qshift, deq, log_scale: int):
    """K4 (replaces pallas_kernels.quantize_b_vec): int32 coeff (..., n)
    and int32 parameter vectors (n,) -> (qcoeff, dqcoeff) int32.  With
    parameter rows (F, n) and coeff (F, ..., n) each frame's coefficients
    take its own row (a quantizer per frame), in the same launch."""
    name = "quantize_b_vec"
    n = coeff.shape[-1]
    params = (zbin, rnd, quant, qshift, deq)
    _require(coeff.dtype == torch.int32
             and all(p.dtype == torch.int32 for p in params), name,
             "coeff and parameters must be int32")
    rows = zbin.shape[:-1]
    _require(all(tuple(p.shape) == (n,) for p in params)
             or (coeff.dim() >= 2 and all(tuple(p.shape) == (coeff.shape[0],
                                                             n)
                                          for p in params)), name,
             f"parameter vectors must have shape ({n},), or "
             f"({coeff.shape[0] if coeff.dim() else 'F'}, {n}) for a row a "
             "frame of coeff's first axis")
    _require(0 <= int(log_scale) <= 2, name, "log_scale must be 0..2")
    if _on_cpu(name, coeff, *params):
        return quantize_b_vec_plain(coeff, *params, int(log_scale))
    coeff = coeff.contiguous()
    params = [p.contiguous() for p in params]
    q = torch.empty_like(coeff)
    dq = torch.empty_like(coeff)
    total = coeff.numel()
    if total:
        per_row = total // rows[0] if rows else total
        _launch(name, "avl_quantize_b", q.data_ptr(), dq.data_ptr(),
                coeff.data_ptr(), *[p.data_ptr() for p in params], total,
                n, int(log_scale), per_row)
    return q, dq


# ---------------------------------------------------------------------------
# K4, fused entry: one wave of the wavefront KEY

#: the luma modes a wave tries, in the order of their costs
WAVE_MODES = (c.DC_PRED, c.V_PRED, c.H_PRED, c.SMOOTH_PRED,
              c.SMOOTH_V_PRED, c.SMOOTH_H_PRED, c.PAETH_PRED)
#: int16 values of a result row: mode, 3 eobs, 2 unused, 256 + 64 + 64 levels
WAVE_ROW = 390
#: log2(x) as the reference evaluates it: its jaxpr is log(x) / log(2),
#: which XLA computes as a multiply by the float32 reciprocal of log(2)
INV_LN2 = float(np.float32(1.0) / np.float32(np.log(2.0)))
#: where each part of wave_tables() starts (csrc/wave_encode.cu has the
#: same offsets): stage tables [stage][position][kind, src0, src1, w0, w1]
#: of the forward DCT at the column and at the row cos bit and of the
#: inverse, for n 16 and n 8; the scans; the smooth weights; the modes; and
#: per size the forward cos bits (col, row), the forward shifts, the inverse
#: shifts and the number of stages
WAVE_TABLE_OFFSETS = {"fdct16_col": 0, "fdct16_row": 560, "idct16": 1120,
                      "fdct8_col": 1680, "fdct8_row": 1880, "idct8": 2080,
                      "scan_y": 2280, "scan_c": 2536, "smooth16": 2600,
                      "modes": 2616, "params16": 2624, "params8": 2632,
                      "total": 2640}


@lru_cache(maxsize=None)
def wave_tables() -> np.ndarray:
    """Everything constant that the wave kernel reads, as one int32 array
    laid out by WAVE_TABLE_OFFSETS.  The stage tables are those of
    common/txfm1d.py at the cos bits of common/txfm2d.py, as ops/txfm.py
    runs them.  The scans are given as positions of the kernel's
    coefficient layout: it keeps the coefficient of flat index c * n + r at
    position r * n + c (the forward transform's output before the final
    transpose, which is where the inverse reads it)."""
    out = np.zeros(WAVE_TABLE_OFFSETS["total"], np.int32)

    def put(key, values):
        a = np.asarray(values, np.int64).reshape(-1)
        o = WAVE_TABLE_OFFSETS[key]
        out[o:o + a.size] = a

    for n, tx in ((16, c.TX_16X16), (8, c.TX_8X8)):
        idx = n.bit_length() - 3
        cb_col = T2._FWD_COS_BIT_COL[idx][idx]
        cb_row = T2._FWD_COS_BIT_ROW[idx][idx]
        put(f"fdct{n}_col", T1.fdct_stages(n, cb_col))
        put(f"fdct{n}_row", T1.fdct_stages(n, cb_row))
        inv = T1.idct_stages(n, T1.INV_COS_BIT)
        put(f"idct{n}", inv)
        assert len(inv) == len(T1.fdct_stages(n, cb_col))
        put(f"params{n}", [cb_col, cb_row, *T2.FWD_SHIFT[tx],
                           *T2.INV_SHIFT[tx], len(inv)])
        scan = np.asarray(tables.scan(tx, c.DCT_DCT), np.int64)
        put("scan_y" if n == 16 else "scan_c", scan % n * n + scan // n)
    put("smooth16", SMOOTH_WEIGHTS[16])
    put("modes", WAVE_MODES)
    out.setflags(write=False)
    return out


@lru_cache(maxsize=None)
def _wave_tables_on(device: torch.device):
    return torch.as_tensor(wave_tables().copy(), device=device)


def wave_encode_plain(rows, ry, ru, rv, src_y, src_u, src_v, order,
                      start: int, count: int, pq, lam: float):
    """wave_encode as a composition of torch ops on any device: the three
    planes of the wave through ops/wavefront.py, the quantizer through
    quantize_b_vec."""
    from .wavefront import wave_step
    return wave_step(rows, ry, ru, rv, src_y, src_u, src_v, order, start,
                     count, pq, lam)


def wave_encode(rows, ry, ru, rv, src_y, src_u, src_v, order, start: int,
                count: int, pq, lam: float):
    """K4's fused entry for the wavefront KEY (replaces
    pallas_kernels._quant_kernel's inline twin wavefront._quantize_jnp with
    the plane_encode and wave body around it): codes the blocks
    order[start:start + count] of every frame of a batch in one launch.

    src_y (N, H, W), src_u, src_v (N, H/2, W/2) uint8 source planes; ry,
    ru, rv recon planes of the same shapes, read at the blocks' edges
    (which earlier waves wrote) and written at the blocks; rows (N, nblk,
    390) int16, written at the blocks' indices in the emitter's layout
    (mode, 3 eobs, 2 zeros, the levels of y, u, v wrapped to int16); order
    (nblk,) int32 block indices r * (W/16) + c sorted by wave; pq (3, 5, 2)
    int32 (ops/wavefront.py pq_array of each plane).  Returns the float32
    costs (N, count, 7) of the luma modes in WAVE_MODES order."""
    name = "quantize_b_vec"
    planes = (ry, ru, rv, src_y, src_u, src_v)
    _require(all(p.dim() == 3 and p.dtype == torch.uint8
                 and p.is_contiguous() for p in planes), name,
             "wave_encode: planes must be contiguous (N, h, w) uint8")
    N, H, W = src_y.shape
    _require(H % 16 == 0 and W % 16 == 0 and H > 0 and W > 0, name,
             "wave_encode: luma sides must be multiples of 16")
    nblk = (H // 16) * (W // 16)
    _require(ry.shape == src_y.shape
             and all(tuple(p.shape) == (N, H // 2, W // 2)
                     for p in (ru, rv, src_u, src_v)), name,
             "wave_encode: recon and source planes of one 4:2:0 geometry")
    _require(rows.dtype == torch.int16 and rows.is_contiguous()
             and tuple(rows.shape) == (N, nblk, WAVE_ROW), name,
             f"wave_encode: rows must be contiguous int16 ({N}, {nblk}, "
             f"{WAVE_ROW})")
    _require(order.dtype == torch.int32 and tuple(order.shape) == (nblk,)
             and order.is_contiguous(), name,
             f"wave_encode: order must be contiguous int32 ({nblk},)")
    _require(0 <= start and 0 < count and start + count <= nblk, name,
             "wave_encode: start and count must lie inside order")
    _require(pq.dtype == torch.int32 and tuple(pq.shape) == (3, 5, 2)
             and pq.is_contiguous(), name,
             "wave_encode: pq must be contiguous int32 (3, 5, 2)")
    if _on_cpu(name, rows, *planes, order, pq):
        return wave_encode_plain(rows, ry, ru, rv, src_y, src_u, src_v,
                                 order, start, count, pq, lam)
    _require(N <= 65535, name, "wave_encode takes at most 65535 frames")
    tab = _wave_tables_on(rows.device)
    costs = torch.empty((N, count, len(WAVE_MODES)), dtype=torch.float32,
                        device=rows.device)
    _launch(name, "avl_wave_encode", rows.data_ptr(), costs.data_ptr(),
            ry.data_ptr(), ru.data_ptr(), rv.data_ptr(), src_y.data_ptr(),
            src_u.data_ptr(), src_v.data_ptr(), order.data_ptr(),
            pq.data_ptr(), tab.data_ptr(), tab.numel(), int(start),
            int(count), N, H, W, float(lam), INV_LN2)
    return costs


# ---------------------------------------------------------------------------
# K4, fused entry: the residual coding of a P frame's plane

#: pixel-SSE per dq^2 of one coefficient, per tx size (TX_8X8..TX_64X64)
TX_SSE_K = {c.TX_8X8: 0.0163, c.TX_16X16: 0.0182, c.TX_32X32: 0.0734,
            c.TX_64X64: 0.2914}
#: the transform sizes code_residual takes, with their side
RESIDUAL_TX = {c.TX_8X8: 8, c.TX_16X16: 16, c.TX_32X32: 32, c.TX_64X64: 64}
#: the fields of a size's parameter row in residual_tables(): where its
#: stage tables and scan start, the forward cos bits (col, row), the forward
#: shifts, the inverse shifts, the stages of the forward and of the inverse,
#: the quantizer's log scale and the coefficients kept a block
RESIDUAL_PARAM_FIELDS = ("fdct_col", "fdct_row", "idct", "scan", "cos_col",
                         "cos_row", "fwd_shift0", "fwd_shift1", "fwd_shift2",
                         "inv_shift0", "inv_shift1", "fwd_stages",
                         "inv_stages", "log_scale", "n_coef")
#: where each part of residual_tables() starts: a parameter row of 16 int32
#: for each of n 8, 16, 32, 64 (row s for n = 8 << s; csrc/code_residual.cu
#: reads every other offset from it), then per n the stage tables
#: [stage][position][kind, src0, src1, w0, w1] of the forward DCT at the
#: column and at the row cos bit and of the inverse, and the scan
RESIDUAL_TABLE_OFFSETS = {
    "params": 0,
    "fdct8_col": 64, "fdct8_row": 264, "idct8": 464, "scan8": 664,
    "fdct16_col": 728, "fdct16_row": 1288, "idct16": 1848, "scan16": 2408,
    "fdct32_col": 2664, "fdct32_row": 4104, "idct32": 5544, "scan32": 6984,
    "fdct64_col": 8008, "fdct64_row": 11528, "idct64": 15048,
    "scan64": 18568, "total": 19592}


@lru_cache(maxsize=None)
def residual_tables() -> np.ndarray:
    """Everything constant that the residual kernel reads, as one int32
    array laid out by RESIDUAL_TABLE_OFFSETS.  The stage tables are those
    of common/txfm1d.py at the cos bits of common/txfm2d.py, as ops/txfm.py
    runs them.  The scans are given as positions of the kernel's
    coefficient layout: a block of side n keeps the coefficient of raster
    index c * s + r (s = min(n, 32), the side of what the block keeps) at
    position r * n + c."""
    off = RESIDUAL_TABLE_OFFSETS
    out = np.zeros(off["total"], np.int32)

    def put(key, values):
        a = np.asarray(values, np.int64).reshape(-1)
        o = off[key]
        out[o:o + a.size] = a

    for s, (tx, n) in enumerate(RESIDUAL_TX.items()):
        idx = n.bit_length() - 3
        cb_col = T2._FWD_COS_BIT_COL[idx][idx]
        cb_row = T2._FWD_COS_BIT_ROW[idx][idx]
        fwd = T1.fdct_stages(n, cb_col)
        inv = T1.idct_stages(n, T1.INV_COS_BIT)
        put(f"fdct{n}_col", fwd)
        put(f"fdct{n}_row", T1.fdct_stages(n, cb_row))
        put(f"idct{n}", inv)
        ns = min(n, 32)
        scan = np.asarray(tables.scan(tx, c.DCT_DCT), np.int64)
        put(f"scan{n}", scan % ns * n + scan // ns)
        row = [off[f"fdct{n}_col"], off[f"fdct{n}_row"], off[f"idct{n}"],
               off[f"scan{n}"], cb_col, cb_row, *T2.FWD_SHIFT[tx],
               *T2.INV_SHIFT[tx], len(fwd), len(inv), CF._tx_scale(tx),
               ns * ns]
        assert len(row) == len(RESIDUAL_PARAM_FIELDS)
        out[16 * s:16 * s + len(row)] = row
    out.setflags(write=False)
    return out


@lru_cache(maxsize=None)
def _residual_tables_on(device: torch.device):
    return torch.as_tensor(residual_tables().copy(), device=device)


@lru_cache(maxsize=None)
def _scans_on(tx: int, device: torch.device):
    """(scan, its inverse, the DC mask) of tx's DCT_DCT scan on device."""
    scan = torch.tensor(np.asarray(tables.scan(tx, c.DCT_DCT)),
                        dtype=torch.int64, device=device)
    return (scan, torch.argsort(scan),
            torch.arange(scan.numel(), device=device) == 0)


def rd_dropout_plain(qc, dqc, scan, inv_scan, lam, tx_size: int,
                     rbits=1.0):
    """Trellis-lite tail dropout (the reference's _rd_dropout): cut the
    scan tail where the suffix sum of (K*dq^2 - lam*bits) over dropped
    nonzeros is most negative (lam: a scalar, or each block's (B,))."""
    from .wavefront import log2_f32
    K = TX_SSE_K.get(int(tx_size), 0.02)
    qs = qc.index_select(-1, scan)
    ds = dqc.index_select(-1, scan).to(torch.float32)
    n = qs.shape[-1]
    idx = torch.arange(n, device=qc.device)
    nz = qs != 0
    marked = torch.where(nz, idx, -1)
    prev_incl = torch.cummax(marked, dim=-1).values
    prev_excl = torch.cat([torch.full_like(prev_incl[..., :1], -1),
                           prev_incl[..., :-1]], -1)
    gap = (idx - prev_excl - 1).to(torch.float32)
    lvl_bits = 1.7 + 2.0 * log2_f32(qs.abs().to(torch.float32) + 1.0)
    save = torch.where(nz, rbits + lvl_bits + 0.55 * gap, 0.0)
    cost = torch.where(nz, K * ds * ds, 0.0)
    if isinstance(lam, torch.Tensor) and lam.dim():
        lam = lam[:, None]
    net = cost - lam * save
    suffix = net.flip(-1).cumsum(-1).flip(-1)
    best, at = suffix.min(-1, keepdim=True)
    cut = torch.where(best < 0, at, n)
    mask = (idx < cut).index_select(-1, inv_scan)
    return qc * mask, dqc * mask


def code_residual_plain(src, pred, tx: int, pq, lam, dropout: bool = True):
    """code_residual as a composition of torch ops on any device: the
    transforms of ops/txfm.py, the quantizer through quantize_b_vec
    (ops/wavefront.py quantize), rd_dropout_plain, the rate estimate of
    ops/wavefront.py est_bits."""
    from .wavefront import est_bits, quantize
    scan, iscan, dc = _scans_on(tx, src.device)
    resid = src - pred.to(torch.int32)
    coeff = fwd_txfm2d_batched(resid, tx, c.DCT_DCT)
    q, dq = (t.reshape(coeff.shape) for t in quantize(
        coeff.reshape(pq.shape[0], -1, coeff.shape[-1]), pq,
        CF._tx_scale(tx), dc))
    if dropout:
        q, dq = rd_dropout_plain(q, dq, scan, iscan, lam, tx)
    bits, eob = est_bits(q, scan)
    rec = inv_txfm2d_add_batched(dq, pred, tx, c.DCT_DCT)
    rec = torch.where((eob > 0)[:, None, None], rec, pred)
    return q, eob, rec, bits


def code_residual(src, pred, tx: int, pq, lam, dropout: bool = True):
    """K4's fused entry for the P frames (replaces pallas_kernels
    ._quant_kernel's inline twin wavefront._quantize_jnp with the residual
    coding of inter_tpu._p_frame_core and _eval_merge_level around it):
    codes one plane's blocks at transform size tx in one launch.

    src (B, n, n) int32 or uint8 source blocks and pred (B, n, n) uint8
    predictions, n = 8, 16, 32, 64 for tx TX_8X8 .. TX_64X64 (DCT_DCT); pq
    (F, 5, 2) int32 (ops/wavefront.py pq_array of each frame), block b
    taking row b // (B / F); lam (B,) float32, each block's RD multiplier;
    dropout: cut each block's scan tail (False where AVL_NO_DROPOUT is set;
    the caller reads it).  Returns (q (B, n_coef) int32 levels in raster
    order (tx64: its 32x32 corner), eob (B,) int64 in scan order, rec (B,
    n, n) uint8 (pred where eob is 0), bits (B,) float32)."""
    name = "quantize_b_vec"
    _require(tx in RESIDUAL_TX, name,
             "code_residual: tx must be TX_8X8, TX_16X16, TX_32X32 or "
             "TX_64X64")
    n = RESIDUAL_TX[tx]
    _require(src.dim() == 3 and tuple(src.shape[1:]) == (n, n)
             and src.dtype in (torch.int32, torch.uint8), name,
             f"code_residual: src must be int32 or uint8 (B, {n}, {n})")
    B = src.shape[0]
    _require(pred.dtype == torch.uint8 and pred.shape == src.shape, name,
             f"code_residual: pred must be uint8 ({B}, {n}, {n})")
    _require(pq.dtype == torch.int32 and pq.dim() == 3
             and tuple(pq.shape[1:]) == (5, 2) and pq.shape[0] > 0
             and B % pq.shape[0] == 0, name,
             "code_residual: pq must be int32 (F, 5, 2) with F dividing B")
    _require(lam.dtype == torch.float32 and tuple(lam.shape) == (B,), name,
             f"code_residual: lam must be float32 ({B},)")
    if _on_cpu(name, src, pred, pq, lam):
        return code_residual_plain(src, pred, tx, pq, lam, dropout)
    src, pred, pq, lam = (t.contiguous() for t in (src, pred, pq, lam))
    tab = _residual_tables_on(src.device)
    q = torch.empty((B, min(n, 32) ** 2), dtype=torch.int32,
                    device=src.device)
    eob = torch.empty(B, dtype=torch.int64, device=src.device)
    rec = torch.empty_like(pred)
    bits = torch.empty(B, dtype=torch.float32, device=src.device)
    if B:
        _launch(name, "avl_code_residual", q.data_ptr(), eob.data_ptr(),
                rec.data_ptr(), bits.data_ptr(), src.data_ptr(),
                int(src.dtype == torch.uint8), pred.data_ptr(),
                pq.data_ptr(), lam.data_ptr(), tab.data_ptr(), tab.numel(),
                n, B, B // pq.shape[0], float(np.float32(TX_SSE_K[tx])),
                INV_LN2, int(bool(dropout)))
    return q, eob, rec, bits
