"""Device low-delay encoder: batched device P-frames + wavefront key frames.

Device side (ops/inter.py) runs motion search, motion compensation and
transform coding for ALL 16x16 blocks of a P-frame in one batched pass (inter
blocks have no neighbor-recon dependency, so no wavefront is needed).  The
host walks the fixed partition tree and drives the native entropy coder.
"""

from __future__ import annotations

import numpy as np

from .. import resolve_device
from ..bitstream import constants as c
from ..common import blockd
from ..common import txtype as TT
from .inter import InterFrameEncoder, make_inter_frame_header
from .lossy import make_lossy_frame_header
from .encoder import make_sequence_header
from .tpu_intra import TorchAllIntraEncoder


class TpuInterFrameEncoder(InterFrameEncoder):
    """Fixed 16x16 inter blocks, whole-frame device encode; searches
    every ref in ref_list on device, each block picks its best.  A frame
    that is handed no chain results encodes itself on `device` (the card
    when None, resolved only then)."""

    #: deblock level comes from the q-derived estimate in the header
    #: (picklpf.c LPF_PICK_FROM_Q), not the host trial search — the
    #: device paths are dispatch-bound and the search costs 5 full-frame
    #: host filters
    lf_search = False
    #: set by the GOP encoder for device-chained frames whose recon was
    #: already deblocked inside the device program
    _recon_prefiltered = False

    def __init__(self, sh, fh, refs, use_native=None,
                 ref_list=(c.LAST_FRAME,), device=None):
        super().__init__(sh, fh, refs, use_native=use_native,
                         block_size=c.BLOCK_16X16, ref_list=ref_list)
        self.device = device
        self._results = None
        self._res_raw = None

    def _filter_recon(self, search: bool = True):
        if self._recon_prefiltered:
            # chained device frame: in-loop filters already applied on
            # device (deblock) / disabled (cdef, lr) — the host recon
            # here is either the fetched filtered frame or a stale
            # buffer the group never reads
            return
        super()._filter_recon(search=search)

    def encode_frame(self, planes, use_jax: bool = True) -> bytes:
        w = self.mi_cols * 4
        h = self.mi_rows * 4
        assert w % 16 == 0 and h % 16 == 0, \
            "TPU preset needs a 16px-aligned mi grid (use inter.py otherwise)"
        if not getattr(self, "_external_results", False):
            self._results = None
            self._res_raw = None
        from .lossy import LossyAllIntraEncoder
        return super(LossyAllIntraEncoder, self).encode_frame(
            planes, use_jax=False)

    # --- native tile fast path -----------------------------------------

    def _raw16(self):
        """(B, 390) 16x16-leaf raster buffer (dict and legacy forms)."""
        raw = self._res_raw
        return raw["r16"] if isinstance(raw, dict) else raw

    def _lvl_map(self):
        """(nby, nbx) partition level map (0=16, 1=32, 2=64 leaf) or
        None for fixed-16x16 results."""
        raw = self._res_raw
        return raw.get("lvl") if isinstance(raw, dict) else None

    def _native_tile_ok(self) -> bool:
        """The C walker (runtime/inter_tile.c) covers exactly the
        restricted syntax this encoder emits; anything else falls back
        to the Python emitter."""
        if self.use_native is False or self._res_raw is None:
            return False
        from ..runtime import native_available
        fh, sh = self.fh, self.sh
        return (native_available()
                and fh.tx_mode == c.TX_MODE_LARGEST
                and not fh.delta_q_present
                and not fh.segmentation_enabled
                and not getattr(fh, "skip_mode_flag", 0)
                and fh.reference_mode != c.REFERENCE_MODE_SELECT
                and not fh.is_motion_mode_switchable
                and not sh.enable_interintra_compound
                and not fh.is_filter_switchable
                and not fh.force_integer_mv
                and not fh.allow_ref_frame_mvs
                # loop-filter params are frame-header-only syntax: the
                # tile walker never codes an LF-dependent symbol, so any
                # uniform (delta-free) level is fine
                and not fh.loop_filter_delta_enabled
                and fh.tile_cols_log2 == 0 and fh.tile_rows_log2 == 0
                and self.sb_mi == 16
                and self.num_planes == 3
                and self.mi_rows % 4 == 0 and self.mi_cols % 4 == 0
                and len(self.ref_list) <= 2)

    def _fill_native_grids(self):
        """Vectorized mirror of the emit-time grid bookkeeping the rest
        of the frame pipeline reads (mi_skip for CDEF search, per-8x8
        frame MVs for future frames' motion-field projection), covering
        the variable {16,32,64} leaf map."""
        res = self._raw16()
        nby, nbx = self.mi_rows // 4, self.mi_cols // 4
        skip_blk = ((res[:, 3] == 0) & (res[:, 4] == 0)
                    & (res[:, 5] == 0)).reshape(nby, nbx)
        bsz_blk = np.full((nby, nbx), c.BLOCK_16X16, np.uint8)
        mvr = res[:, 0].reshape(nby, nbx).astype(np.int16)
        mvc = res[:, 1].reshape(nby, nbx).astype(np.int16)
        refi = res[:, 2].reshape(nby, nbx).astype(np.int32)
        lvl = self._lvl_map()
        if lvl is not None and lvl.any():
            raw = self._res_raw
            for level, rbuf, bsz, f in (
                    (1, raw["r32"], c.BLOCK_32X32, 2),
                    (2, raw["r64"], c.BLOCK_64X64, 4)):
                if not rbuf.shape[0]:
                    continue
                n1, n2 = nby // f, nbx // f
                g = rbuf.reshape(n1, n2, -1)
                m = lvl[:n1 * f:f, :n2 * f:f] == level   # (n1, n2)
                for arr, col in ((mvr, 0), (mvc, 1), (refi, 2)):
                    src = np.repeat(np.repeat(
                        g[:, :, col], f, 0), f, 1).astype(arr.dtype)
                    mfull = np.repeat(np.repeat(m, f, 0), f, 1)
                    arr[:n1 * f, :n2 * f][mfull] = src[mfull]
                sk = ((g[:, :, 3] == 0) & (g[:, :, 4] == 0)
                      & (g[:, :, 5] == 0))
                mfull = np.repeat(np.repeat(m, f, 0), f, 1)
                skip_blk[:n1 * f, :n2 * f][mfull] = np.repeat(
                    np.repeat(sk, f, 0), f, 1)[mfull]
                bsz_blk[:n1 * f, :n2 * f][mfull] = bsz
        self.mi_skip[:nby * 4, :nbx * 4] = np.repeat(
            np.repeat(skip_blk, 4, 0), 4, 1)
        self.mi_bsize[:nby * 4, :nbx * 4] = np.repeat(
            np.repeat(bsz_blk, 4, 0), 4, 1)
        # av1_copy_frame_mvs mirror (per 8x8 unit)
        refs = np.asarray([int(self.ref_list[i])
                           for i in range(len(self.ref_list))]
                          + [int(self.ref_list[0])], np.int32)
        ref_blk = refs[refi]
        side = np.asarray(self.ref_side, np.int32)[ref_blk]
        big = (np.abs(mvr.astype(np.int32)) > 4095) \
            | (np.abs(mvc.astype(np.int32)) > 4095)
        valid = (side == 0) & ~big
        st_ref = np.where(valid, ref_blk, -1).astype(np.int8)
        st_r = np.where(valid, mvr, 0).astype(np.int16)
        st_c = np.where(valid, mvc, 0).astype(np.int16)
        self.frame_mvs_ref[:nby * 2, :nbx * 2] = np.repeat(
            np.repeat(st_ref, 2, 0), 2, 1)
        self.frame_mvs[:nby * 2, :nbx * 2, 0] = np.repeat(
            np.repeat(st_r, 2, 0), 2, 1)
        self.frame_mvs[:nby * 2, :nbx * 2, 1] = np.repeat(
            np.repeat(st_c, 2, 0), 2, 1)

    def _encode_tile(self) -> bytes:
        self._ensure_device_encode()
        if not self._native_tile_ok():
            return super()._encode_tile()
        from ..bitstream.tables import FrameContext
        from ..runtime import encode_inter16_tile
        fc = (self.fc0.copy() if getattr(self, "fc0", None) is not None
              else FrameContext(self.fh.base_q_idx))
        data = encode_inter16_tile(
            fc, self._res_raw, self.mi_rows, self.mi_cols,
            [int(r) for r in self.ref_list], self.sign_bias,
            int(self.fh.allow_high_precision_mv), sb_mi=self.sb_mi,
            reduced_tx_set=int(self.fh.reduced_tx_set))
        self.fc = fc
        self._fill_native_grids()
        return data

    def _ensure_device_encode(self):
        if ((self._res_raw is not None or self._results is not None)
                and getattr(self, "_external_recon", None) is not None):
            ry, ru, rv = self._external_recon
            self.recon[0][:ry.shape[0], :ry.shape[1]] = ry
            self.recon[1][:ru.shape[0], :ru.shape[1]] = ru
            self.recon[2][:rv.shape[0], :rv.shape[1]] = rv
            self._external_recon = None
        if self._res_raw is None and self._results is None:
            from ..ops.inter import DeviceInterEncoder
            dev = DeviceInterEncoder(self.fh.base_q_idx, device=self.device)
            ref_planes = [self.refs[self.fh.ref_frame_idx[r - 1]]
                          for r in self.ref_list]
            self._res_raw = dev.encode_frame_raw(
                [self.src[0][:self.mi_rows * 4, :self.mi_cols * 4],
                 self.src[1][:self.mi_rows * 2, :self.mi_cols * 2],
                 self.src[2][:self.mi_rows * 2, :self.mi_cols * 2]],
                ref_planes)
            ry, ru, rv = dev.recon
            self.recon[0][:ry.shape[0], :ry.shape[1]] = ry
            self.recon[1][:ru.shape[0], :ru.shape[1]] = ru
            self.recon[2][:rv.shape[0], :rv.shape[1]] = rv

    def _results_dicts(self):
        """Per-block dict view of the raw device results — built only
        when the Python emitter fallback actually walks them (the
        native C walker consumes _res_raw directly; at 1080p the dict
        packing alone costs ~50 ms/frame of pure host overhead)."""
        if self._results is None:
            from ..ops.inter import pack_frame_results
            self._results = pack_frame_results(self._raw16(),
                                               self.mi_cols * 4)
        return self._results

    def _search(self, mi_row, mi_col, bsize):
        """Realize the device partition DP's tree (lvl map: 0=16x16
        leaf, 1=merged 32x32, 2=merged 64x64)."""
        self._ensure_device_encode()
        if mi_row >= self.mi_rows or mi_col >= self.mi_cols:
            return 0.0, None
        lvl = self._lvl_map()
        n4 = blockd.mi_size_wide(bsize)
        if (lvl is not None and bsize in (c.BLOCK_64X64, c.BLOCK_32X32)
                and mi_row + n4 <= self.mi_rows
                and mi_col + n4 <= self.mi_cols
                and lvl[mi_row // 4, mi_col // 4] == (
                    2 if bsize == c.BLOCK_64X64 else 1)):
            return 0.0, ("NONE", mi_row, mi_col, bsize,
                         [self._leaf_merged(mi_row, mi_col, bsize)])
        if bsize == c.BLOCK_16X16:
            return 0.0, ("NONE", mi_row, mi_col, bsize,
                         [self._leaf(mi_row, mi_col)])
        hbs = blockd.mi_size_wide(bsize) // 2
        sub = blockd.partition_subsize(bsize, c.PARTITION_SPLIT)
        kids = []
        for (r, cc) in ((mi_row, mi_col), (mi_row, mi_col + hbs),
                        (mi_row + hbs, mi_col), (mi_row + hbs,
                                                 mi_col + hbs)):
            _, k = self._search(r, cc, sub)
            kids.append(k)
        return 0.0, ("SPLIT", mi_row, mi_col, bsize, kids)

    def _tx_type_sym(self, tx_size):
        """Luma inter tx-type symbol spec for DCT_DCT at tx_size (None
        when the ext-tx set is DCT-only, e.g. 32x32+)."""
        st = TT.ext_tx_set_type(tx_size, True,
                                bool(self.fh.reduced_tx_set))
        if TT.NUM_EXT_TX_SET[st] <= 1:
            return None
        eset = TT.inter_ext_tx_idx(st)
        sqr = c.TX_SIZE_SQR[tx_size]
        return (("inter_ext_tx_cdf", eset, sqr),
                TT.EXT_TX_IND[st][c.DCT_DCT], TT.NUM_EXT_TX_SET[st])

    def _leaf(self, mi_row, mi_col):
        res = self._results_dicts()[(mi_row // 4, mi_col // 4)]
        py = mi_row * 4
        px = mi_col * 4
        txbs = [dict(plane=0, tx_size=c.TX_16X16, tx_type=c.DCT_DCT,
                     tx_type_sym=self._tx_type_sym(c.TX_16X16),
                     qcoeff=res["qy"],
                     eob=res["eoby"], plane_bsize=c.BLOCK_16X16,
                     py=py, px=px, recon=None, acol=px >> 2, lrow=py >> 2)]
        for plane, (q, eob) in ((1, (res["qu"], res["eobu"])),
                                (2, (res["qv"], res["eobv"]))):
            cx, cy = px >> 1, py >> 1
            txbs.append(dict(
                plane=plane, tx_size=c.TX_8X8, tx_type=c.DCT_DCT,
                tx_type_sym=None, qcoeff=q, eob=eob,
                plane_bsize=c.BLOCK_8X8, py=cy, px=cx,
                recon=None, acol=cx >> 2, lrow=cy >> 2))
        return dict(mi_row=mi_row, mi_col=mi_col, bsize=c.BLOCK_16X16,
                    is_inter=1, mode=0, mv=res["mv"],
                    ref=self.ref_list[res.get("ref_idx", 0)],
                    ref_mv_idx=0,
                    txbs=txbs, is_chroma_ref=True, y_mode=c.DC_PRED,
                    uv_mode=c.DC_PRED, cfl=None)

    def _leaf_merged(self, mi_row, mi_col, bsize):
        """Leaf dict for a device-merged 32x32 or 64x64 block (raster
        row from the r32/r64 result buffer)."""
        r16, c16 = mi_row // 4, mi_col // 4
        nbx = self.mi_cols // 4
        if bsize == c.BLOCK_32X32:
            row = self._res_raw["r32"][
                (r16 // 2) * (nbx // 2) + c16 // 2]
            tx_y, tx_uv = c.TX_32X32, c.TX_16X16
            pb_uv = c.BLOCK_16X16
            ny, nc = 1024, 256
        else:
            row = self._res_raw["r64"][
                (r16 // 4) * (nbx // 4) + c16 // 4]
            tx_y, tx_uv = c.TX_64X64, c.TX_32X32
            pb_uv = c.BLOCK_32X32
            ny, nc = 1024, 1024
        py = mi_row * 4
        px = mi_col * 4
        txbs = [dict(plane=0, tx_size=tx_y, tx_type=c.DCT_DCT,
                     tx_type_sym=self._tx_type_sym(tx_y),
                     qcoeff=row[6:6 + ny], eob=int(row[3]),
                     plane_bsize=bsize, py=py, px=px, recon=None,
                     acol=px >> 2, lrow=py >> 2)]
        for plane, (q, eob) in (
                (1, (row[6 + ny:6 + ny + nc], int(row[4]))),
                (2, (row[6 + ny + nc:6 + ny + 2 * nc], int(row[5])))):
            cx, cy = px >> 1, py >> 1
            txbs.append(dict(
                plane=plane, tx_size=tx_uv, tx_type=c.DCT_DCT,
                tx_type_sym=None, qcoeff=q, eob=eob,
                plane_bsize=pb_uv, py=cy, px=cx,
                recon=None, acol=cx >> 2, lrow=cy >> 2))
        return dict(mi_row=mi_row, mi_col=mi_col, bsize=bsize,
                    is_inter=1, mode=0, mv=(int(row[0]), int(row[1])),
                    ref=self.ref_list[int(row[2])],
                    ref_mv_idx=0,
                    txbs=txbs, is_chroma_ref=True, y_mode=c.DC_PRED,
                    uv_mode=c.DC_PRED, cfl=None)


class TpuLowDelayEncoder:
    """Key frame (wavefront intra) + P-frames (batched inter), all on
    `device` (the card when None, and an error when there is none), with
    native entropy coding."""

    def __init__(self, width, height, qindex=60, use_native=None,
                 deblock=True, device=None):
        self.device = resolve_device(device)
        self.sh = make_sequence_header(width, height)
        self.qindex = qindex
        self.use_native = use_native
        self.deblock = deblock
        self.slots = [None] * 8
        self.frame_idx = 0

    def encode_frame(self, planes) -> bytes:
        if self.frame_idx == 0:
            fh = make_lossy_frame_header(self.sh, self.qindex,
                                         deblock=self.deblock)
            enc = TorchAllIntraEncoder(self.sh, fh,
                                       use_native=self.use_native,
                                       device=self.device)
        else:
            fh = make_inter_frame_header(self.sh, self.qindex,
                                         deblock=self.deblock)
            enc = TpuInterFrameEncoder(self.sh, fh, self.slots,
                                       use_native=self.use_native,
                                       device=self.device)
        payload = enc.encode_frame(planes)
        w, h = self.sh.max_frame_width, self.sh.max_frame_height
        cw = (w + 1) >> 1
        ch = (h + 1) >> 1
        out = (enc.recon[0][:h, :w].copy(),
               enc.recon[1][:ch, :cw].copy(),
               enc.recon[2][:ch, :cw].copy())
        for slot in range(8):
            if fh.refresh_frame_flags & (1 << slot):
                self.slots[slot] = out
        self.frame_idx += 1
        return payload


def encode_tpu_lowdelay_ivf(path: str, frames, width: int, height: int,
                            qindex: int = 60, fps=(30, 1), device=None,
                            **kw) -> None:
    from ..bitstream.ivf import write_ivf
    enc = TpuLowDelayEncoder(width, height, qindex=qindex, device=device,
                             **kw)
    payloads = []
    for i, f in enumerate(frames):
        payloads.append((enc.encode_frame(f), i))
    write_ivf(path, payloads, width, height, fps[0], fps[1])
