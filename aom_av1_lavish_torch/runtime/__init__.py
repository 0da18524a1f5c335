"""Native runtime: builds and loads the C fast paths (ctypes).

The C sources live in this package; they are compiled on demand into
``_build/`` (gcc -O2).  Python remains the reference implementation; the
native paths must match it byte-exactly (tests/test_native_entropy.py).
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD = os.path.join(_DIR, "_build")

_lib = None


class AvlDec(ctypes.Structure):
    """Mirror of the C avl_dec range-decoder state (coeff_dec.c)."""
    _fields_ = [("data", ctypes.POINTER(ctypes.c_uint8)),
                ("pos", ctypes.c_int32), ("end", ctypes.c_int32),
                ("dif", ctypes.c_uint32), ("rng", ctypes.c_uint32),
                ("cnt", ctypes.c_int32), ("tell_offs", ctypes.c_int32)]


def get_lib():
    """Compile (if needed) and load the native entropy library."""
    global _lib
    if _lib is not None:
        return _lib
    # unity build: lossless_tile.c #includes entropy_enc.c
    src = os.path.join(_DIR, "lossless_tile.c")
    deps = [src, os.path.join(_DIR, "entropy_enc.c"),
            os.path.join(_DIR, "inter_tile.c"),
            os.path.join(_DIR, "coeff_dec.c"),
            os.path.join(_DIR, "lossless_dec.c"),
            os.path.join(_DIR, "txfm_inv.c")]
    so = os.path.join(_BUILD, "libavl_runtime.so")
    if (not os.path.exists(so)
            or os.path.getmtime(so) < max(os.path.getmtime(d)
                                          for d in deps)):
        os.makedirs(_BUILD, exist_ok=True)
        # built under a per-process name and renamed into place, so that
        # processes that build at the same time never load a half-written
        # library
        tmp = f"{so}.{os.getpid()}.tmp"
        subprocess.run(
            ["gcc", "-O3", "-march=native", "-shared", "-fPIC", "-o", tmp,
             src, os.path.join(_DIR, "inter_tile.c"),
             os.path.join(_DIR, "coeff_dec.c"),
             os.path.join(_DIR, "lossless_dec.c"),
             os.path.join(_DIR, "txfm_inv.c")],
            check=True, capture_output=True)
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    u16p = ctypes.POINTER(ctypes.c_uint16)
    lib.avl_read_coeffs_txb.restype = ctypes.c_int
    lib.avl_read_coeffs_txb.argtypes = [
        ctypes.POINTER(AvlDec), ctypes.POINTER(ctypes.c_int16),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
        u16p, ctypes.c_int, u16p, u16p, u16p, u16p, u16p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.avl_inv_txfm2d_add.restype = ctypes.c_int
    vp = ctypes.c_void_p
    lib.avl_inv_txfm2d_add.argtypes = [
        vp, vp, vp,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, vp, vp,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.avl_fwd_txfm2d.restype = ctypes.c_int
    lib.avl_fwd_txfm2d.argtypes = [
        vp, vp, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, vp, vp,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.avl_quantize_b.restype = ctypes.c_int
    lib.avl_quantize_b.argtypes = [
        vp, vp, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        vp, vp, vp, vp]
    lib.avl_encode_tile.restype = ctypes.c_int
    lib.avl_encode_tile.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint16), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int16),
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
    lib.avl_encode_lossless_tile.restype = ctypes.c_int
    lib.avl_encode_lossless_tile.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint16), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int16),
        ctypes.c_int, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
    lib.avl_encode_intra16_tile.restype = ctypes.c_int
    lib.avl_encode_intra16_tile.argtypes = [
        ctypes.POINTER(ctypes.c_int16), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_uint16),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_int16),
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
    lib.avl_encode_inter16_tile.restype = ctypes.c_int
    lib.avl_encode_inter16_tile.argtypes = [
        ctypes.POINTER(ctypes.c_int16), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(ctypes.c_uint16),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_int16),
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
    lib.avl_encode_inter_tile.restype = ctypes.c_int
    lib.avl_encode_inter_tile.argtypes = [
        ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_int16),
        ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(ctypes.c_uint16),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_int16),
        ctypes.POINTER(ctypes.c_int16),
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.avl_decode_lossless_tile.restype = ctypes.c_int
    lib.avl_decode_lossless_tile.argtypes = [
        u8p, ctypes.c_int, ctypes.POINTER(ctypes.c_uint16),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int16), u8p, u8p, u8p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    _lib = lib
    return _lib


def native_available() -> bool:
    try:
        get_lib()
        return True
    except Exception:
        return False


class FcArena:
    """FrameContext flattened into one uint16 arena with offset lookup."""

    def __init__(self, fc):
        names = sorted(fc._d.keys())
        self.offsets = {}
        parts = []
        off = 0
        for n in names:
            a = fc._d[n]
            self.offsets[n] = (off, a.shape)
            parts.append(a.reshape(-1).astype(np.uint16))
            off += a.size
        self.arena = np.concatenate(parts) if parts else \
            np.zeros(0, np.uint16)
        self._off_cache = {}

    def write_back(self, fc, arena: np.ndarray) -> None:
        """Scatter an adapted arena back into fc._d (CDFs + in-band
        adaptation counters) — the encoder's frame-end context for
        primary_ref carry (av1_common_int.h:985)."""
        for n, (off, shape) in self.offsets.items():
            size = int(np.prod(shape))
            fc._d[n][...] = arena[off:off + size].reshape(shape) \
                .astype(fc._d[n].dtype)

    def offset(self, name: str, *idx) -> int:
        """Arena offset of the row fc.<name>[idx...] (row = last dim)."""
        key = (name,) + idx
        v = self._off_cache.get(key)
        if v is not None:
            return v
        base, shape = self.offsets[name]
        assert len(idx) == len(shape) - 1, (name, idx, shape)
        flat = 0
        for d, i in enumerate(idx):
            flat = flat * shape[d] + i
        v = base + flat * shape[-1]
        self._off_cache[key] = v
        return v


class OpStream:
    """Accumulates the per-tile symbol op stream for avl_encode_tile."""

    def __init__(self, arena: FcArena):
        self.arena = arena
        self.ops = []
        self.cdfsets = []
        self._cdfset_idx = {}
        self.qcoeff = []
        self.q_off = 0
        self.scans = {}
        self.scan_data = []
        self.scan_off = 0

    def symbol(self, sym: int, name: str, *idx, nsymbs: int,
               adapt: bool = True):
        self.ops.append((0, self.arena.offset(name, *idx), nsymbs, int(sym),
                         int(adapt), 0, 0, 0))

    def raw_symbol(self, sym: int, arena_off: int, nsymbs: int,
                   adapt: bool = True):
        self.ops.append((0, arena_off, nsymbs, int(sym), int(adapt),
                         0, 0, 0))

    def bit(self, b: int):
        self.ops.append((1, int(b), 0, 0, 0, 0, 0, 0))

    def gather_split(self, sym: int, ctx: int, is_128: bool,
                     horz_alike: bool):
        """Split-vs-rect binary derived from the live partition cdf row
        (resolved inside C against the adapted state)."""
        off = self.arena.offset("partition_cdf", ctx)
        self.ops.append((3, off, int(is_128), int(horz_alike), int(sym),
                         0, 0, 0))

    def cdfset_for(self, plane_type: int, txs_ctx: int,
                   eob_ms: int) -> int:
        key = (plane_type, txs_ctx, eob_ms)
        if key in self._cdfset_idx:
            return self._cdfset_idx[key]
        a = self.arena
        base = [
            a.offset("txb_skip_cdf", txs_ctx, 0),
            a.offset(_EOB_CDF_NAME[eob_ms], plane_type, 0),
            a.offset("eob_extra_cdf", txs_ctx, plane_type, 0),
            a.offset("coeff_base_eob_cdf", txs_ctx, plane_type, 0),
            a.offset("coeff_base_cdf", txs_ctx, plane_type, 0),
            a.offset("coeff_br_cdf", min(txs_ctx, 3), plane_type, 0),
            a.offset("dc_sign_cdf", plane_type, 0),
            0,
        ]
        idx = len(self.cdfsets)
        self.cdfsets.append(base)
        self._cdfset_idx[key] = idx
        return idx

    def scan_offset(self, adj_tx_size: int, tx_type: int) -> int:
        key = (adj_tx_size, tx_type)
        if key not in self.scans:
            from ..bitstream import tables
            s = tables.scan(adj_tx_size, tx_type).astype(np.int16)
            self.scans[key] = self.scan_off
            self.scan_data.append(s)
            self.scan_off += len(s)
        return self.scans[key]

    def txb(self, qcoeff: np.ndarray, width: int, height: int, bhl: int,
            tx_class: int, skip_ctx: int, dc_sign_ctx: int,
            cdfset_idx: int, scan_off: int, eob_ms: int):
        self.qcoeff.append(qcoeff.astype(np.int32).ravel())
        geom = (width << 20) | (height << 8) | (bhl << 4) | tx_class
        self.ops.append((2, self.q_off, geom, skip_ctx, dc_sign_ctx,
                         cdfset_idx, scan_off, eob_ms))
        self.q_off += qcoeff.size

    def run(self, max_bytes: int | None = None) -> bytes:
        lib = get_lib()
        ops = np.asarray(self.ops, dtype=np.int32).reshape(-1, 8)
        arena = self.arena.arena.copy()
        cdfsets = (np.asarray(self.cdfsets, dtype=np.int32).reshape(-1, 8)
                   if self.cdfsets else np.zeros((1, 8), np.int32))
        qc = (np.concatenate(self.qcoeff) if self.qcoeff
              else np.zeros(1, np.int32)).astype(np.int32)
        scans = (np.concatenate(self.scan_data) if self.scan_data
                 else np.zeros(1, np.int16)).astype(np.int16)
        cap = max_bytes or (len(ops) * 16 + qc.size * 4 + 4096)
        out = np.zeros(cap, dtype=np.uint8)
        n = lib.avl_encode_tile(
            ops.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(ops),
            arena.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            cdfsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            qc.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            scans.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
        assert 0 < n <= cap
        self.final_arena = arena   # adapted CDF state after the tile
        return bytes(out[:n])


_EOB_CDF_NAME = {
    0: "eob_flag_cdf16", 1: "eob_flag_cdf32", 2: "eob_flag_cdf64",
    3: "eob_flag_cdf128", 4: "eob_flag_cdf256", 5: "eob_flag_cdf512",
    6: "eob_flag_cdf1024",
}


def encode_lossless_tile(fc, analysis, mi_rows: int, mi_cols: int,
                         num_planes: int = 3, sb_mi: int = 16,
                         mi_row0: int = 0, mi_col0: int = 0) -> bytes:
    """Full-native lossless tile encode (avl_encode_lossless_tile).

    analysis: per-plane (qcoeff (h4, w4, 16), zero) from
    ops/lossless.analyze_*_for_encoder (whole-frame arrays).  mi_rows/
    mi_cols are the TILE's mi dims; mi_row0/mi_col0 its origin (must be
    SB-aligned).  Byte-exact with the Python walk in encoder/encoder.py
    (LosslessEncoder._encode_tile)."""
    lib = get_lib()
    arena_obj = FcArena(fc)
    a = arena_obj.offset

    def cdfset(plane_type):
        return [a("txb_skip_cdf", 0, 0),
                a("eob_flag_cdf16", plane_type, 0),
                a("eob_extra_cdf", 0, plane_type, 0),
                a("coeff_base_eob_cdf", 0, plane_type, 0),
                a("coeff_base_cdf", 0, plane_type, 0),
                a("coeff_br_cdf", 0, plane_type, 0),
                a("dc_sign_cdf", plane_type, 0), 0]

    part_base, part_shape = arena_obj.offsets["partition_cdf"]
    offs = np.asarray(
        [part_base, part_shape[-1], a("skip_txfm_cdfs", 0),
         a("kf_y_cdf", 0, 0), a("uv_mode_cdf", 0, 0),
         a("uv_mode_cdf", 1, 0)], dtype=np.int32)
    cdfsets = np.asarray([cdfset(0), cdfset(1)], dtype=np.int32)
    from ..bitstream import tables
    scan4 = np.ascontiguousarray(tables.scan(0, 0), dtype=np.int16)
    qs = []
    for i in range(3):
        q = analysis[min(i, len(analysis) - 1)][0]
        qs.append(np.ascontiguousarray(q, dtype=np.int32))
    w4y = qs[0].shape[1]
    w4c = qs[1].shape[1] if num_planes > 1 else 0
    arena = arena_obj.arena.copy()
    cap = int(sum(q.size for q in qs) * 4 + mi_rows * mi_cols * 4 + 4096)
    out = np.zeros(cap, dtype=np.uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)

    def qptr(i, w4, ss):
        off = ((mi_row0 * 4 >> ss) >> 2) * w4 + ((mi_col0 * 4 >> ss) >> 2)
        return ctypes.cast(qs[i].ctypes.data + off * 16 * 4, i32p)

    n = lib.avl_encode_lossless_tile(
        qptr(0, w4y, 0), qptr(1, w4c, 1), qptr(2, w4c, 1),
        mi_rows, mi_cols, w4y, w4c,
        num_planes, arena.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        offs.ctypes.data_as(i32p), cdfsets.ctypes.data_as(i32p),
        scan4.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), sb_mi,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
    assert 0 < n <= cap
    return bytes(out[:n])


def encode_inter16_tile(fc, res_buf, mi_rows: int, mi_cols: int,
                        ref_lut, sign_bias, allow_hp: int,
                        sb_mi: int = 16, reduced_tx_set: int = 0) -> bytes:
    """Full-native inter tile encode with square {16, 32, 64} leaves
    (avl_encode_inter_tile): partition walk from the device DP's level
    map, skip / intra_inter / single-ref / mode / MV symbols with the
    spatial ref-MV stack (av1_find_mv_refs, variable neighbor widths),
    and coefficient coding at TX_16X16/32X32/64X64.  res_buf: the raw
    result dict (r16/r32/r64/lvl, ops/inter_tpu.py layout) or a legacy
    (B, 390) int16 array (uniform 16x16).  ref_lut: device ref_idx ->
    AV1 ref frame.  Byte-exact with encoder/inter.py's Python emitter
    (restricted case); adapts `fc` in place (tile-end CDF state for
    primary_ref carry)."""
    from ..bitstream import constants as c
    from ..bitstream import tables
    from ..common import coeffs as CF
    from ..common import txtype as TT
    lib = get_lib()
    arena_obj = FcArena(fc)
    a = arena_obj.offset

    def cdfset(plane_type, tx_size, eob_name):
        txs = CF.txsize_entropy_ctx(tx_size)
        return [a("txb_skip_cdf", txs, 0),
                a(eob_name, plane_type, 0),
                a("eob_extra_cdf", txs, plane_type, 0),
                a("coeff_base_eob_cdf", txs, plane_type, 0),
                a("coeff_base_cdf", txs, plane_type, 0),
                a("coeff_br_cdf", min(txs, 3), plane_type, 0),
                a("dc_sign_cdf", plane_type, 0), 0]

    # inter tx-type symbols for DCT_DCT (skip-gated in code_txb): the
    # 16x16 set and the 32x32 DCT_IDTX set (64-dim is DCTONLY)
    def tx_type_sym(tx_size):
        st = TT.ext_tx_set_type(tx_size, True, bool(reduced_tx_set))
        if TT.NUM_EXT_TX_SET[st] <= 1:
            return -1, 0, 0
        eset = TT.inter_ext_tx_idx(st)
        sqr = c.TX_SIZE_SQR[tx_size]
        return (a("inter_ext_tx_cdf", eset, sqr),
                TT.NUM_EXT_TX_SET[st], TT.EXT_TX_IND[st][c.DCT_DCT])

    tt_off, tt_n, tt_sym = tx_type_sym(c.TX_16X16)
    tt32_off, tt32_n, tt32_sym = tx_type_sym(c.TX_32X32)

    part_base, part_shape = arena_obj.offsets["partition_cdf"]
    sr_base, sr_shape = arena_obj.offsets["single_ref_cdf"]
    offs = [part_base, part_shape[-1],
            a("skip_txfm_cdfs", 0),
            a("intra_inter_cdf", 0),
            sr_base, sr_shape[1] * sr_shape[2], sr_shape[2],
            a("newmv_cdf", 0), a("zeromv_cdf", 0), a("refmv_cdf", 0),
            a("drl_cdf", 0),
            a("nmv_joints_cdf")]
    for comp in (0, 1):
        p = f"nmv_comp{comp}_"
        offs += [a(p + "sign_cdf"), a(p + "classes_cdf"),
                 a(p + "class0_cdf"), a(p + "bits_cdf", 0),
                 a(p + "class0_fp_cdf", 0), a(p + "fp_cdf"),
                 a(p + "class0_hp_cdf"), a(p + "hp_cdf"), 0]
    offs += [tt_off, tt_n, tt_sym, int(allow_hp),
             tt32_off, tt32_n, tt32_sym]
    offs = np.asarray(offs, dtype=np.int32)
    assert offs.shape[0] == 37
    cdfsets = np.asarray(
        [cdfset(0, c.TX_16X16, "eob_flag_cdf256"),
         cdfset(1, c.TX_8X8, "eob_flag_cdf64"),
         cdfset(0, c.TX_32X32, "eob_flag_cdf1024"),
         cdfset(1, c.TX_16X16, "eob_flag_cdf256"),
         cdfset(0, c.TX_64X64, "eob_flag_cdf1024"),
         cdfset(1, c.TX_32X32, "eob_flag_cdf1024")], dtype=np.int32)
    scan16 = np.ascontiguousarray(
        tables.scan(c.TX_16X16, c.DCT_DCT), dtype=np.int16)
    scan8 = np.ascontiguousarray(
        tables.scan(c.TX_8X8, c.DCT_DCT), dtype=np.int16)
    scan32 = np.ascontiguousarray(
        tables.scan(c.TX_32X32, c.DCT_DCT), dtype=np.int16)
    if isinstance(res_buf, dict):
        res = np.ascontiguousarray(res_buf["r16"], dtype=np.int16)
        lvl = np.ascontiguousarray(res_buf["lvl"], dtype=np.uint8)
        r32 = np.ascontiguousarray(res_buf["r32"], dtype=np.int16)
        r64 = np.ascontiguousarray(res_buf["r64"], dtype=np.int16)
    else:
        res = np.ascontiguousarray(res_buf, dtype=np.int16)
        lvl = np.zeros((mi_rows // 4, mi_cols // 4), np.uint8)
        r32 = np.zeros((0, 1542), np.int16)
        r64 = np.zeros((0, 3078), np.int16)
    assert res.shape == ((mi_rows // 4) * (mi_cols // 4), 390)
    assert r32.shape[1] == 1542 and r64.shape[1] == 3078
    sb = np.asarray(sign_bias, dtype=np.int8)
    arena = arena_obj.arena.copy()
    cap = int(res.size * 2 + r32.size * 2 + r64.size * 2 + 65536)
    out = np.zeros(cap, dtype=np.uint8)
    i16p = ctypes.POINTER(ctypes.c_int16)
    n = lib.avl_encode_inter_tile(
        res.ctypes.data_as(i16p),
        lvl.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        r32.ctypes.data_as(i16p), r64.ctypes.data_as(i16p),
        mi_rows, mi_cols, sb_mi,
        int(ref_lut[0]), int(ref_lut[1] if len(ref_lut) > 1
                             else ref_lut[0]),
        sb.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        arena.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        cdfsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        scan16.ctypes.data_as(i16p), scan8.ctypes.data_as(i16p),
        scan32.ctypes.data_as(i16p),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
    assert 0 < n <= cap
    arena_obj.write_back(fc, arena)
    return bytes(out[:n])


def encode_intra16_tile(fc, res_buf, mi_rows: int, mi_cols: int,
                        sb_mi: int = 16,
                        reduced_tx_set: int = 0) -> bytes:
    """Full-native uniform-16x16 KEY-frame tile encode
    (avl_encode_intra16_tile): partition walk, skip, kf y mode with
    neighbour-mode contexts, angle-delta, DC chroma, intra tx-type, and
    coefficient coding.  res_buf rows: [y_mode, eob_y, eob_u, eob_v,
    0, 0, qy*256, qu*64, qv*64] (raster coefficients).  Byte-exact with
    encoder/lossy.py's Python emitter (restricted wavefront case);
    adapts `fc` in place."""
    from ..bitstream import constants as c
    from ..bitstream import tables
    from ..common import coeffs as CF
    from ..common import txtype as TT
    lib = get_lib()
    arena_obj = FcArena(fc)
    a = arena_obj.offset

    def cdfset(plane_type, tx_size, eob_name):
        txs = CF.txsize_entropy_ctx(tx_size)
        return [a("txb_skip_cdf", txs, 0),
                a(eob_name, plane_type, 0),
                a("eob_extra_cdf", txs, plane_type, 0),
                a("coeff_base_eob_cdf", txs, plane_type, 0),
                a("coeff_base_cdf", txs, plane_type, 0),
                a("coeff_br_cdf", min(txs, 3), plane_type, 0),
                a("dc_sign_cdf", plane_type, 0), 0]

    st = TT.ext_tx_set_type(c.TX_16X16, False, bool(reduced_tx_set))
    tt_base, tt_n, tt_sym = -(17 * 12) - 1, 0, 0
    if TT.NUM_EXT_TX_SET[st] > 1:
        eset = TT.intra_ext_tx_idx(st)
        sqr = c.TX_SIZE_SQR[c.TX_16X16]
        tt_base = a("intra_ext_tx_cdf", eset, sqr, 0)
        tt_n = TT.NUM_EXT_TX_SET[st]
        tt_sym = TT.EXT_TX_IND[st][c.DCT_DCT]

    part_base, part_shape = arena_obj.offsets["partition_cdf"]
    ioffs = np.asarray(
        [part_base, part_shape[-1],
         a("skip_txfm_cdfs", 0),
         a("kf_y_cdf", 0, 0),
         a("angle_delta_cdf", 0),
         a("uv_mode_cdf", 1, 0),
         tt_base, tt_n, tt_sym], dtype=np.int32)
    cdfsets = np.asarray(
        [cdfset(0, c.TX_16X16, "eob_flag_cdf256"),
         cdfset(1, c.TX_8X8, "eob_flag_cdf64")], dtype=np.int32)
    scan16 = np.ascontiguousarray(
        tables.scan(c.TX_16X16, c.DCT_DCT), dtype=np.int16)
    scan8 = np.ascontiguousarray(
        tables.scan(c.TX_8X8, c.DCT_DCT), dtype=np.int16)
    res = np.ascontiguousarray(res_buf, dtype=np.int16)
    assert res.shape == ((mi_rows // 4) * (mi_cols // 4), 390)
    arena = arena_obj.arena.copy()
    cap = int(res.size * 2 + 65536)
    out = np.zeros(cap, dtype=np.uint8)
    i16p = ctypes.POINTER(ctypes.c_int16)
    n = lib.avl_encode_intra16_tile(
        res.ctypes.data_as(i16p), mi_rows, mi_cols, sb_mi,
        arena.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        ioffs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        cdfsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        scan16.ctypes.data_as(i16p), scan8.ctypes.data_as(i16p),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
    assert 0 < n <= cap
    arena_obj.write_back(fc, arena)
    return bytes(out[:n])


def native_coeff_tail(rd, scan, tx_class, bhl, width, height, raw_w,
                      raw_h, eob_cdf, eob_syms, eob_extra, base_eob,
                      base, br, dc_sign, dqv_dc, dqv_ac, shift, bd,
                      iqm, dqcoeff):
    """Run the post-all_zero coeff parse in C, synchronizing the Python
    RangeDecoder state both ways.  Returns (eob, cul_level, dc_val)."""
    lib = get_lib()
    buf = getattr(rd, "_cbuf", None)
    if buf is None:
        buf = ctypes.cast(ctypes.c_char_p(rd.data),
                          ctypes.POINTER(ctypes.c_uint8))
        rd._cbuf = buf
    st = AvlDec(buf, rd.pos, rd.end, rd.dif, rd.rng, rd.cnt,
                rd.tell_offs)
    info = (ctypes.c_int32 * 2)()

    def p16(a):
        return ctypes.cast(a.ctypes.data, ctypes.POINTER(ctypes.c_uint16))

    eob = lib.avl_read_coeffs_txb(
        ctypes.byref(st),
        ctypes.cast(scan.ctypes.data, ctypes.POINTER(ctypes.c_int16)),
        tx_class, bhl, width, height, raw_w, raw_h,
        p16(eob_cdf), eob_syms, p16(eob_extra), p16(base_eob), p16(base),
        p16(br), p16(dc_sign), dqv_dc, dqv_ac, shift, bd,
        ctypes.cast(iqm.ctypes.data, ctypes.POINTER(ctypes.c_uint8))
        if iqm is not None else None,
        ctypes.cast(dqcoeff.ctypes.data, ctypes.POINTER(ctypes.c_int32)),
        info)
    rd.pos, rd.dif, rd.rng = st.pos, st.dif, st.rng
    rd.cnt, rd.tell_offs = st.cnt, st.tell_offs
    return eob, int(info[0]), int(info[1])


# --- native inverse transform (txfm_inv.c) ---------------------------------

_TXFM_TABLES = {}


def txfm_table(kind: str, n: int) -> np.ndarray:
    """Flattened 1-D inverse op table [n_stages, counts..., ops(5 each)]
    shared with the Python engine (common/txfm1d.py)."""
    key = (kind, n)
    t = _TXFM_TABLES.get(key)
    if t is None:
        from ..common import txfm1d as T1
        stages = (T1.idct_stages(n, T1.INV_COS_BIT) if kind == "dct"
                  else T1.iadst_stages(n, T1.INV_COS_BIT))
        flat = [len(stages)] + [len(s) for s in stages]
        for s in stages:
            for op in s:
                flat.extend(op)
        t = np.asarray(flat, dtype=np.int32)
        _TXFM_TABLES[key] = t
    return t


def native_inv_txfm2d_add(coeff, pred, w, h, aw, ah, kind_row, kind_col,
                          row_tbl, col_tbl, flip_lr, flip_ud, rect1,
                          sh0, sh1, range_row, range_col, bd):
    """pred: contiguous (h, w) uint8/uint16, modified in place."""
    lib = get_lib()
    is8 = pred.dtype == np.uint8
    pp = pred.ctypes.data
    lib.avl_inv_txfm2d_add(
        coeff.ctypes.data, pp if is8 else None,
        None if is8 else pp,
        w, h, aw, ah, kind_row, kind_col,
        row_tbl.ctypes.data if row_tbl is not None else None,
        col_tbl.ctypes.data if col_tbl is not None else None,
        flip_lr, flip_ud, rect1, sh0, sh1, range_row, range_col, bd)
    return pred


def fwd_txfm_table(kind: str, n: int, cos_bit: int = 13) -> np.ndarray:
    """Flattened forward op table (txfm1d.fdct/fadst_stages); the
    butterfly weights bake in cos_bit, so it keys the cache."""
    key = ("fwd-" + kind, n, cos_bit)
    t = _TXFM_TABLES.get(key)
    if t is None:
        from ..common import txfm1d as T1
        stages = (T1.fdct_stages(n, cos_bit) if kind == "dct"
                  else T1.fadst_stages(n, cos_bit))
        flat = [len(stages)] + [len(s) for s in stages]
        for s in stages:
            for op in s:
                flat.extend(op)
        t = np.asarray(flat, dtype=np.int32)
        _TXFM_TABLES[key] = t
    return t


def native_fwd_txfm2d(resid, w, h, aw, ah, kind_col, kind_row, col_tbl,
                      row_tbl, cb_col, cb_row, flip_ud, flip_lr,
                      s0, s1, s2, rect1):
    lib = get_lib()
    out = np.empty(aw * ah, dtype=np.int32)
    lib.avl_fwd_txfm2d(
        resid.ctypes.data, out.ctypes.data, w, h, aw, ah, kind_col,
        kind_row,
        col_tbl.ctypes.data if col_tbl is not None else None,
        row_tbl.ctypes.data if row_tbl is not None else None,
        cb_col, cb_row, flip_ud, flip_lr, s0, s1, s2, rect1)
    return out


def native_quantize_b(coeff, scan, pq, log_scale, qm, iqm):
    lib = get_lib()
    n = len(scan)
    qcoeff = np.empty(n, dtype=np.int32)
    dqcoeff = np.empty(n, dtype=np.int32)
    eob = lib.avl_quantize_b(
        coeff.ctypes.data, scan.ctypes.data, n,
        pq.zbin[0], pq.zbin[1], pq.round[0], pq.round[1],
        pq.quant[0], pq.quant[1], pq.quant_shift[0], pq.quant_shift[1],
        pq.dequant[0], pq.dequant[1], log_scale,
        qm.ctypes.data if qm is not None else None,
        iqm.ctypes.data if iqm is not None else None,
        qcoeff.ctypes.data, dqcoeff.ctypes.data)
    return qcoeff, dqcoeff, eob


def decode_lossless_tile(fc, data: bytes, planes, vis_wy: int, vis_hy: int,
                         mi_rows: int, mi_cols: int, num_planes: int,
                         sb_mi: int):
    """Full-native lossless tile decode (avl_decode_lossless_tile).

    planes: padded uint8 (h+pad, w+pad) arrays written in place at
    origin (0, 0).  Returns bits consumed, or None when the stream
    shape is outside the fast path (caller re-decodes in Python)."""
    lib = get_lib()
    arena_obj = FcArena(fc)
    a = arena_obj.offset

    def cdfset(pt):
        return [a("txb_skip_cdf", 0, 0),
                a("eob_flag_cdf16", pt, 0),
                a("eob_extra_cdf", 0, pt, 0),
                a("coeff_base_eob_cdf", 0, pt, 0),
                a("coeff_base_cdf", 0, pt, 0),
                a("coeff_br_cdf", 0, pt, 0),
                a("dc_sign_cdf", pt, 0), 0]

    part_base, part_shape = arena_obj.offsets["partition_cdf"]
    offs = np.asarray(
        [part_base, part_shape[-1], a("skip_txfm_cdfs", 0),
         a("kf_y_cdf", 0, 0), a("uv_mode_cdf", 0, 0),
         a("uv_mode_cdf", 1, 0)], dtype=np.int32)
    cdfsets = np.asarray([cdfset(0), cdfset(1)], dtype=np.int32)
    from ..bitstream import tables
    scan4 = np.ascontiguousarray(tables.scan(0, 0), dtype=np.int16)
    arena = arena_obj.arena.copy()
    buf = np.frombuffer(data, dtype=np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    ps = []
    for i in range(3):
        pl = planes[min(i, len(planes) - 1)]
        if pl.dtype != np.uint8 or pl.strides[1] != 1:
            return None
        ps.append(pl)
    n = lib.avl_decode_lossless_tile(
        buf.ctypes.data_as(u8p), len(data),
        arena.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        offs.ctypes.data_as(i32p), cdfsets.ctypes.data_as(i32p),
        scan4.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        ps[0].ctypes.data_as(u8p), ps[1].ctypes.data_as(u8p),
        ps[2].ctypes.data_as(u8p),
        ps[0].strides[0], ps[1].strides[0],
        vis_wy, vis_hy, mi_rows, mi_cols, num_planes, sb_mi)
    return None if n < 0 else int(n)
