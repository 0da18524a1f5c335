"""AV1 1D integer transforms (inverse + forward) — table-driven engine.

The normative butterfly networks (AV1 spec §7.13.2; reference behavior:
av1/common/av1_inv_txfm1d.c, av1/encoder/av1_fwd_txfm1d.c) are expressed as
per-stage op tables generated from the transforms' recursive structure:

  idct2M = perm ++ interleave(copy·idctM-body, odd-ladder(M)) ++ combine

with the odd ladder alternating add/sub stages (group size 2,4,...) and
mirror-pair rotations whose angles follow a = (64/r)·(1 + 4·bitrev(j, r/4)).
The same tables drive the scalar numpy engine (host reference) and the
batched JAX engine (TPU path), so bit-exactness transfers.

Op kinds per output element:
  COPY   out[i] = s0 * in[i0]                       (no clamp, no round)
  ADDSUB out[i] = clamp(s0*in[i0] + s1*in[i1])      (stage-range clamp)
  BTF    out[i] = round2(w0*in[i0] + w1*in[i1], cb) (no clamp)
where w = ±cospi[idx] resolved at table-build time.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np

K_COPY, K_ADDSUB, K_BTF = 0, 1, 2

INV_COS_BIT = 12
NEW_SQRT2_BITS = 12
NEW_SQRT2 = 5793      # 2^12 * sqrt(2)
NEW_INV_SQRT2 = 2896  # 2^12 / sqrt(2)


@lru_cache(maxsize=None)
def cospi_arr(bit: int) -> tuple:
    """cospi[j] = round(cos(j*pi/128) * 2^bit) (av1_txfm.c:18 data rule)."""
    return tuple(int(math.floor(math.cos(j * math.pi / 128) * (1 << bit)
                                + 0.5)) for j in range(64))


_SINPI = {  # round(sqrt(2)*sin(j*pi/9)*2/3 * 2^bit), adjusted so j1+j2==j4
    10: (0, 330, 621, 836, 951),
    11: (0, 660, 1241, 1672, 1901),
    12: (0, 1321, 2482, 3344, 3803),
    13: (0, 2642, 4964, 6689, 7606),
}


def sinpi_arr(bit: int) -> tuple:
    """ADST4 sine constants (av1_txfm.c:62 data rule)."""
    return _SINPI[bit]


def _bitrev(i: int, n: int) -> int:
    bits = n.bit_length() - 1
    out = 0
    for b in range(bits):
        out = (out << 1) | ((i >> b) & 1)
    return out


# ---------------------------------------------------------------------------
# Stage-table generation: inverse DCT
# ---------------------------------------------------------------------------


def _idct_perm(n: int) -> list:
    if n == 1:
        return [0]
    half = _idct_perm(n // 2)
    return [2 * p for p in half] + \
        [2 * _bitrev(i, n // 2) + 1 for i in range(n // 2)]


def _copy(i):
    return (K_COPY, i, 0, 1, 0)


def _addsub(i0, s0, i1, s1):
    return (K_ADDSUB, i0, i1, s0, s1)


def _btf(w0, i0, w1, i1):
    return (K_BTF, i0, i1, w0, w1)


def _ladder_stages(m: int, base: int, cospi) -> list:
    """Odd-part ladder for idct(2m): stages operate on [base, base+m)."""
    c = cospi
    stages = []
    # initial mirror rotations
    ops = [None] * m
    for i in range(m // 2):
        a = (32 // m) * (1 + 4 * _bitrev(i, max(m // 2, 1)))
        lo, hi = base + i, base + m - 1 - i
        ops[i] = _btf(c[64 - a], lo, -c[a], hi)
        ops[m - 1 - i] = _btf(c[a], lo, c[64 - a], hi)
    stages.append(ops)
    g = 2
    while g <= m // 2:
        # addsub stage, groups of g, alternating pos/neg
        ops = [None] * m
        for i in range(m):
            grp, k = divmod(i, g)
            mirror = base + grp * g + (g - 1 - k)
            me = base + i
            pos = (grp % 2) == 0
            if pos:
                ops[i] = _addsub(me, 1, mirror, 1) if k < g // 2 \
                    else _addsub(mirror, 1, me, -1)
            else:
                ops[i] = _addsub(me, -1, mirror, 1) if k < g // 2 \
                    else _addsub(mirror, 1, me, 1)
        stages.append(ops)
        # merge rotations on mirror pairs
        ops = [_copy(base + i) for i in range(m)]
        r = m // g
        for i in range(m // 2):
            k = i % (2 * g)
            if not (g // 2 <= k < 3 * g // 2):
                continue
            j = i // (2 * g)
            a = (64 // r) * (1 + 4 * _bitrev(j, max(r // 4, 1)))
            lo, hi = base + i, base + m - 1 - i
            if k < g:  # form A
                ops[i] = _btf(-c[a], lo, c[64 - a], hi)
                ops[m - 1 - i] = _btf(c[64 - a], lo, c[a], hi)
            else:      # form B
                ops[i] = _btf(-c[64 - a], lo, -c[a], hi)
                ops[m - 1 - i] = _btf(-c[a], lo, c[64 - a], hi)
        stages.append(ops)
        g *= 2
    return stages


def _idct_body(n: int, cospi) -> list:
    """Stages after the input permutation (absolute indices 0..n-1)."""
    c = cospi
    if n == 4:
        s2 = [_btf(c[32], 0, c[32], 1), _btf(c[32], 0, -c[32], 1),
              _btf(c[48], 2, -c[16], 3), _btf(c[16], 2, c[48], 3)]
        s3 = [_addsub(0, 1, 3, 1), _addsub(1, 1, 2, 1),
              _addsub(1, 1, 2, -1), _addsub(0, 1, 3, -1)]
        return [s2, s3]
    m = n // 2
    sub = _idct_body(m, cospi)
    ladder = _ladder_stages(m, m, cospi)
    assert len(ladder) == len(sub) + 1
    stages = []
    # stage 2: lower copies + ladder init
    stages.append([_copy(i) for i in range(m)] + ladder[0])
    for k in range(len(sub)):
        stages.append(sub[k] + ladder[k + 1])
    # final combine
    final = []
    for i in range(m):
        final.append(_addsub(i, 1, n - 1 - i, 1))
    for i in range(m, n):
        final.append(_addsub(n - 1 - i, 1, i, -1))
    stages.append(final)
    return stages


@lru_cache(maxsize=None)
def idct_stages(n: int, cos_bit: int = INV_COS_BIT) -> tuple:
    c = cospi_arr(cos_bit)
    perm = [_copy(p) for p in _idct_perm(n)]
    return tuple([tuple(s) for s in [perm] + _idct_body(n, c)])


# ---------------------------------------------------------------------------
# Inverse ADST 8/16 (av1_inv_txfm1d.c:713,821 structure)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def iadst_stages(n: int, cos_bit: int = INV_COS_BIT) -> tuple:
    assert n in (8, 16)
    c = cospi_arr(cos_bit)
    stages = []
    # stage 1: perm [n-1, 0, n-3, 2, ...]
    perm = []
    for k in range(n // 2):
        perm += [n - 1 - 2 * k, 2 * k]
    stages.append([_copy(p) for p in perm])
    # stage 2: pair rotations, angles base + step*k
    step = 64 // n * 2  # 16 for n=8, 8 for n=16
    base_a = step // 4  # 4 for n=8, 2 for n=16
    ops = []
    for k in range(n // 2):
        a = base_a + step * k
        ops.append(_btf(c[a], 2 * k, c[64 - a], 2 * k + 1))
        ops.append(_btf(c[64 - a], 2 * k, -c[a], 2 * k + 1))
    stages.append(ops)
    # stage 3: half addsub
    stages.append([_addsub(i, 1, i + n // 2, 1) for i in range(n // 2)] +
                  [_addsub(i - n // 2, 1, i, -1) for i in range(n // 2, n)])
    # stage 4: rotations on the upper half
    ops = [_copy(i) for i in range(n // 2)]
    h = n // 2
    qa = 64 // n * 2  # 16 for n=8? no: n=8 -> angle 16; n=16 -> 8
    # rotation angles: pairs (h+2t, h+2t+1) with angles 16,48 style:
    # for n=8: (4,5): (c16,c48 / c48,-c16); (6,7): (-c48,c16 / c16,c48)
    # for n=16: (8,9): 8; (10,11): 40; (12,13): -56/8; (14,15): -24/40
    if n == 8:
        ops += [_btf(c[16], 4, c[48], 5), _btf(c[48], 4, -c[16], 5),
                _btf(-c[48], 6, c[16], 7), _btf(c[16], 6, c[48], 7)]
        stages.append(ops)
        # stage 5: addsub distance 2 within halves
        stages.append([
            _addsub(0, 1, 2, 1), _addsub(1, 1, 3, 1),
            _addsub(0, 1, 2, -1), _addsub(1, 1, 3, -1),
            _addsub(4, 1, 6, 1), _addsub(5, 1, 7, 1),
            _addsub(4, 1, 6, -1), _addsub(5, 1, 7, -1)])
        # stage 6: c32 rotations on (2,3), (6,7)
        stages.append([
            _copy(0), _copy(1),
            _btf(c[32], 2, c[32], 3), _btf(c[32], 2, -c[32], 3),
            _copy(4), _copy(5),
            _btf(c[32], 6, c[32], 7), _btf(c[32], 6, -c[32], 7)])
        # stage 7: output shuffle with negation
        out = [(0, 1), (4, -1), (6, 1), (2, -1), (3, 1), (7, -1), (5, 1),
               (1, -1)]
        stages.append([(K_COPY, src, 0, sgn, 0) for (src, sgn) in out])
    else:
        ops += [_btf(c[8], 8, c[56], 9), _btf(c[56], 8, -c[8], 9),
                _btf(c[40], 10, c[24], 11), _btf(c[24], 10, -c[40], 11),
                _btf(-c[56], 12, c[8], 13), _btf(c[8], 12, c[56], 13),
                _btf(-c[24], 14, c[40], 15), _btf(c[40], 14, c[24], 15)]
        stages.append(ops)
        # stage 5: addsub distance 4 within halves of 8
        s5 = []
        for b in (0, 8):
            s5 += [_addsub(b + i, 1, b + i + 4, 1) for i in range(4)]
            s5 += [_addsub(b + i, 1, b + i + 4, -1) for i in range(4)]
        stages.append(s5)
        # stage 6: 16/48 rotations on (4..7) and (12..15)
        ops = [_copy(i) for i in range(4)]
        ops += [_btf(c[16], 4, c[48], 5), _btf(c[48], 4, -c[16], 5),
                _btf(-c[48], 6, c[16], 7), _btf(c[16], 6, c[48], 7)]
        ops += [_copy(i) for i in range(8, 12)]
        ops += [_btf(c[16], 12, c[48], 13), _btf(c[48], 12, -c[16], 13),
                _btf(-c[48], 14, c[16], 15), _btf(c[16], 14, c[48], 15)]
        stages.append(ops)
        # stage 7: addsub distance 2 within quads
        s7 = []
        for b in (0, 4, 8, 12):
            s7 += [_addsub(b, 1, b + 2, 1), _addsub(b + 1, 1, b + 3, 1),
                   _addsub(b, 1, b + 2, -1), _addsub(b + 1, 1, b + 3, -1)]
        stages.append(s7)
        # stage 8: c32 rotations on (2,3),(6,7),(10,11),(14,15)
        ops = []
        for b in (0, 4, 8, 12):
            ops += [_copy(b), _copy(b + 1),
                    _btf(c[32], b + 2, c[32], b + 3),
                    _btf(c[32], b + 2, -c[32], b + 3)]
        stages.append(ops)
        # stage 9: output shuffle
        out = [(0, 1), (8, -1), (12, 1), (4, -1), (6, 1), (14, -1),
               (10, 1), (2, -1), (3, 1), (11, -1), (15, 1), (7, -1),
               (5, 1), (13, -1), (9, 1), (1, -1)]
        stages.append([(K_COPY, src, 0, sgn, 0) for (src, sgn) in out])
    return tuple(tuple(s) for s in stages)


# ---------------------------------------------------------------------------
# Scalar (numpy) engine
# ---------------------------------------------------------------------------


def _clamp(x, bits):
    lo = -(1 << (bits - 1))
    hi = (1 << (bits - 1)) - 1
    return np.minimum(np.maximum(x, lo), hi)


def _round2(x, bits):
    return (x + (1 << (bits - 1))) >> bits


_COMPILED: dict = {}


def _compile(stages):
    """Each stage of an op table as index and weight vectors (cached by
    the table, which the builders cache): (is_copy, is_addsub, i0, i1,
    w0, w1)."""
    hit = _COMPILED.get(id(stages))
    if hit is not None and hit[0] is stages:
        return hit[1]
    comp = []
    for stage in stages:
        k, i0, i1, w0, w1 = (np.array(col, np.int64)
                             for col in zip(*stage))
        comp.append((k == K_COPY, k == K_ADDSUB, i0, i1, w0, w1))
    _COMPILED[id(stages)] = (stages, comp)
    return comp


def run_stages(x: np.ndarray, stages, cos_bit: int,
               stage_range) -> np.ndarray:
    """Run op-table stages on x (..., N) int64. stage_range: per-stage clamp
    bits (index aligned with stages, i.e. stage_range[s] applies to
    stages[s]).  Each stage is one vector step: out[..., i] is
    w0 * x[i0] (a copy), clamp(w0 * x[i0] + w1 * x[i1]) (an add-sub) or
    round2(w0 * x[i0] + w1 * x[i1], cos_bit) (a butterfly)."""
    buf = x.astype(np.int64)
    for s, (copy, addsub, i0, i1, w0, w1) in enumerate(_compile(stages)):
        a = w0 * buf[..., i0]
        t = a + w1 * buf[..., i1]
        buf = np.where(copy, a, np.where(addsub, _clamp(t, stage_range[s]),
                                         _round2(t, cos_bit)))
    return buf


def iadst4(x: np.ndarray, cos_bit: int = INV_COS_BIT) -> np.ndarray:
    """Inverse ADST4 (non-butterfly form, av1_inv_txfm1d.c:656)."""
    sp = sinpi_arr(cos_bit)
    x = x.astype(np.int64)
    x0, x1, x2, x3 = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
    s0 = sp[1] * x0
    s1 = sp[2] * x0
    s2 = sp[3] * x1
    s3 = sp[4] * x2
    s4 = sp[1] * x2
    s5 = sp[2] * x3
    s6 = sp[4] * x3
    s7 = (x0 - x2) + x3
    s0 = s0 + s3
    s1 = s1 - s4
    s3 = s2
    s2 = sp[3] * s7
    s0 = s0 + s5
    s1 = s1 - s6
    o0 = s0 + s3
    o1 = s1 + s3
    o2 = s2
    o3 = (s0 + s1) - s3
    out = np.stack([_round2(o0, cos_bit), _round2(o1, cos_bit),
                    _round2(o2, cos_bit), _round2(o3, cos_bit)], axis=-1)
    # all-zero shortcut of the reference yields zeros anyway
    return out


def iidentity(x: np.ndarray, n: int) -> np.ndarray:
    x = x.astype(np.int64)
    if n == 4:
        return _round2(NEW_SQRT2 * x, NEW_SQRT2_BITS)
    if n == 8:
        return x * 2
    if n == 16:
        return _round2(NEW_SQRT2 * 2 * x, NEW_SQRT2_BITS)
    if n == 32:
        return x * 4
    raise ValueError(n)


def inv_txfm1d(x: np.ndarray, kind: str, n: int, stage_range,
               cos_bit: int = INV_COS_BIT) -> np.ndarray:
    """kind in {'dct','adst','identity'}; x (..., n) -> (..., n)."""
    if kind == "identity":
        return iidentity(x, n)
    if kind == "adst":
        if n == 4:
            return iadst4(x, cos_bit)
        stages = iadst_stages(n, cos_bit)
    else:
        stages = idct_stages(n, cos_bit)
    return run_stages(x, stages, cos_bit, stage_range)


# ---------------------------------------------------------------------------
# Forward transforms: transpose-reverse of the inverse graphs
# (av1/encoder/av1_fwd_txfm1d.c — no stage clamping, debug range checks only)
# ---------------------------------------------------------------------------


def _transpose_stage(stage):
    """Transpose one butterfly stage (linear map) of the op table."""
    n = len(stage)
    contrib = [[] for _ in range(n)]
    for i, (kind, i0, i1, w0, w1) in enumerate(stage):
        contrib[i0].append((i, w0, kind))
        if kind != K_COPY:
            contrib[i1].append((i, w1, kind))
    out = []
    for tgt in range(n):
        lst = contrib[tgt]
        assert 1 <= len(lst) <= 2, (tgt, lst)
        if len(lst) == 1:
            (src, w, kind) = lst[0]
            assert kind == K_COPY and w in (1, -1)
            out.append((K_COPY, src, 0, w, 0))
        else:
            (s0, w0, k0), (s1, w1, k1) = lst
            assert k0 == k1 and k0 in (K_ADDSUB, K_BTF)
            out.append((k0, s0, s1, w0, w1))
    return out


@lru_cache(maxsize=None)
def fdct_stages(n: int, cos_bit: int = 13) -> tuple:
    inv = idct_stages(n, cos_bit)
    return tuple(tuple(_transpose_stage(list(s))) for s in reversed(inv))


@lru_cache(maxsize=None)
def fadst_stages(n: int, cos_bit: int = 13) -> tuple:
    assert n in (8, 16)
    inv = iadst_stages(n, cos_bit)
    return tuple(tuple(_transpose_stage(list(s))) for s in reversed(inv))


def fadst4(x: np.ndarray, cos_bit: int = 13) -> np.ndarray:
    """Forward ADST4 (sinpi form, av1_fwd_txfm1d.c)."""
    sp = sinpi_arr(cos_bit)
    x = x.astype(np.int64)
    x0, x1, x2, x3 = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
    s0 = sp[1] * x0
    s1 = sp[4] * x0
    s2 = sp[2] * x1
    s3 = sp[1] * x1
    s4 = sp[3] * x2
    s5 = sp[4] * x3
    s6 = sp[2] * x3
    s7 = (x0 + x1) - x3
    t0 = s0 + s2
    t1 = sp[3] * s7
    t2 = s1 - s3
    t3 = s4
    t0 = t0 + s5
    t2 = t2 + s6
    o0 = t0 + t3
    o1 = t1
    o2 = t2 - t3
    o3 = (t2 - t0) + t3
    return np.stack([_round2(o0, cos_bit), _round2(o1, cos_bit),
                     _round2(o2, cos_bit), _round2(o3, cos_bit)], axis=-1)


def fidentity(x: np.ndarray, n: int) -> np.ndarray:
    return iidentity(x, n)  # same scaling rule both directions


_NO_CLAMP = [64] * 16


def fwd_txfm1d(x: np.ndarray, kind: str, n: int,
               cos_bit: int = 13) -> np.ndarray:
    if kind == "identity":
        return fidentity(x, n)
    if kind == "adst":
        if n == 4:
            return fadst4(x, cos_bit)
        stages = fadst_stages(n, cos_bit)
    else:
        stages = fdct_stages(n, cos_bit)
    return run_stages(x, stages, cos_bit, _NO_CLAMP)
