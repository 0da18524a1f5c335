"""Real-time (RTC) encode path: variance-based partitioning + non-RD
pickmode.

Re-designs the reference's RT pipeline —
av1/encoder/var_based_part.c av1_choose_var_based_partitioning and
av1/encoder/nonrd_pickmode.c av1_nonrd_pick_inter_mode_sb — on top of
the conformant emit machinery of InterFrameEncoder.  No RD trials: the
partition comes from a source-vs-reference variance tree with
q-dependent thresholds, and per-block modes are chosen by SAD among a
tiny candidate set, coding the residual directly at the largest tx.
"""

from __future__ import annotations

import numpy as np

from ..bitstream import constants as c
from ..common import blockd
from ..common import interpred as IP
from ..common import mvref as MR
from .inter import InterFrameEncoder


class RealtimeEncoder(InterFrameEncoder):
    #: LPF_PICK_FROM_Q (picklpf.c at REALTIME speeds): no LF level search
    lf_search = False
    """Non-RD inter encoder (cpu-used 7-10 class)."""

    def __init__(self, *a, **kw):
        kw.setdefault("search_range", 16)
        super().__init__(*a, **kw)
        self._var8 = None

    # --- variance-based partitioning -----------------------------------

    def _var_threshold(self) -> float:
        """Partition threshold from q (set_vbp_thresholds analog)."""
        from ..common import quant as Q
        qstep = Q.ac_quant_qtx(self.fh.base_q_idx, 0, self.bd) / 8.0
        return 40.0 * qstep

    def _build_var_partition(self):
        """Per-SB split decisions from the source-vs-LAST difference
        variance pyramid (av1_choose_var_based_partitioning)."""
        ref_slot = self.fh.ref_frame_idx[c.LAST_FRAME - 1]
        ref = self.refs[ref_slot][0]
        h = self.mi_rows * 4
        w = self.mi_cols * 4
        src = self.src[0][:h, :w].astype(np.int32)
        rh, rw = min(ref.shape[0], h), min(ref.shape[1], w)
        diff = np.zeros((h, w), np.int32)
        diff[:rh, :rw] = src[:rh, :rw] - ref[:rh, :rw].astype(np.int32)
        # 8x8 variance grid of the difference
        b = 8
        hb, wb = h // b, w // b
        d = diff[:hb * b, :wb * b].reshape(hb, b, wb, b)
        mean = d.mean(axis=(1, 3))
        var8 = (d.astype(np.float64) ** 2).mean(axis=(1, 3)) - mean ** 2
        self._var8 = var8
        self._thr = self._var_threshold()

    def _region_var(self, mi_row, mi_col, bsize) -> float:
        b8r = mi_row >> 1
        b8c = mi_col >> 1
        n = blockd.mi_size_wide(bsize) >> 1
        v = self._var8[b8r:b8r + max(n, 1), b8c:b8c + max(n, 1)]
        return float(v.max()) if v.size else 0.0

    def _split_plan(self, mi_row, mi_col, bsize):
        hbs = blockd.mi_size_wide(bsize) // 2
        sub = blockd.partition_subsize(bsize, c.PARTITION_SPLIT)
        kids = []
        for (r, cc) in ((mi_row, mi_col), (mi_row, mi_col + hbs),
                        (mi_row + hbs, mi_col),
                        (mi_row + hbs, mi_col + hbs)):
            _, k = self._search(r, cc, sub)
            kids.append(k)
        return 0.0, ("SPLIT", mi_row, mi_col, bsize, kids)

    def _search(self, mi_row, mi_col, bsize):
        """Variance tree instead of RD: split while the difference
        variance exceeds the q-scaled threshold (down to 16x16)."""
        if mi_row >= self.mi_rows or mi_col >= self.mi_cols:
            return 0.0, None
        if self._var8 is None:   # src exists once pad_planes ran
            self._build_var_partition()
        bw = blockd.mi_size_wide(bsize)
        hbs = bw // 2
        if not self._fits(mi_row, mi_col, bsize):
            # frame-edge structure: same slab chooser as the RD path
            has_rows = mi_row + hbs < self.mi_rows
            has_cols = mi_col + hbs < self.mi_cols
            fits_rows = mi_row + bw <= self.mi_rows
            fits_cols = mi_col + bw <= self.mi_cols
            sub_h = blockd.partition_subsize(bsize, c.PARTITION_HORZ)
            sub_v = blockd.partition_subsize(bsize, c.PARTITION_VERT)
            if (bsize > c.BLOCK_8X8 and not has_rows and fits_cols
                    and self._subsize_valid(sub_h)):
                cost, bplan = self._trial_block(mi_row, mi_col, sub_h)
                return cost, ("HORZ", mi_row, mi_col, bsize, [bplan])
            if (bsize > c.BLOCK_8X8 and not has_cols and fits_rows
                    and self._subsize_valid(sub_v)):
                cost, bplan = self._trial_block(mi_row, mi_col, sub_v)
                return cost, ("VERT", mi_row, mi_col, bsize, [bplan])
            return self._split_plan(mi_row, mi_col, bsize)
        if (bsize > c.BLOCK_16X16
                and self._region_var(mi_row, mi_col, bsize) > self._thr):
            return self._split_plan(mi_row, mi_col, bsize)
        cost, bplan = self._trial_block(mi_row, mi_col, bsize)
        return cost, ("NONE", mi_row, mi_col, bsize, [bplan])

    # --- non-RD pickmode ------------------------------------------------

    #: AOME_SET_ACTIVEMAP (aom_active_map_t analog): per-16x16 active
    #: flags; fully-inactive blocks are coded as zero-MV skip (the
    #: reference lowers the map onto SEG_LVL_SKIP segmentation,
    #: av1/encoder/aq_cyclicrefresh.c av1_cyclic_refresh / encoder.c
    #: av1_apply_active_map — same coded result: no residual, no motion)
    active_map = None
    #: AOME_SET_STATIC_THRESHOLD: source-vs-prediction SAD per pixel
    #: below this forces skip coding (encodeframe.c sb_has_motion /
    #: nonrd_pickmode's early skip)
    static_threshold = 0

    def _trial_block(self, mi_row, mi_col, bsize):
        """av1_nonrd_pick_inter_mode_sb analog: SAD-pick among
        {NEAREST, GLOBAL(0,0), NEW via small diamond}, then code the
        residual once with the largest tx."""
        ctx = self._refmv_context(mi_row, mi_col, bsize)
        ref = self.ref_list[0]
        if self.active_map is not None:
            r16, c16 = mi_row // 4, mi_col // 4
            n = max(1, blockd.mi_size_wide(bsize) // 4)
            region = self.active_map[r16:r16 + n, c16:c16 + n]
            if region.size and not region.any():
                mv = (0, 0)
                dist, bits, txbs = self._code_inter_planes(
                    mi_row, mi_col, bsize, mv, ref, force_skip=True)
                self._apply_txbs(0, [t for t in txbs
                                     if t["plane"] == 0])
                for plane in (1, 2):
                    self._apply_txbs(plane, [t for t in txbs
                                             if t["plane"] == plane])
                is_chroma_ref = blockd.is_chroma_reference(
                    mi_row, mi_col, bsize, self.ss_x, self.ss_y) \
                    and self.num_planes > 1
                return dist, dict(
                    mi_row=mi_row, mi_col=mi_col, bsize=bsize,
                    is_inter=1, mode=0, mv=mv, ref=ref, ref_mv_idx=0,
                    txbs=txbs, gm_warp=False,
                    is_chroma_ref=is_chroma_ref, y_mode=c.DC_PRED,
                    uv_mode=c.DC_PRED, cfl=None)
        gm_mv = self._gm_mv(ref, bsize, mi_row, mi_col)
        _, _, _, _, mv_list = MR.find_mv_refs(ctx, ref,
                                              gm=self._gm_info(gm_mv))
        nearest = MR.lower_mv_precision(mv_list[0], 0, 0)
        near = MR.lower_mv_precision(mv_list[1], 0, 0)

        y0, x0 = mi_row * 4, mi_col * 4
        h = min(blockd.block_high(bsize), self.mi_rows * 4 - y0)
        w = min(blockd.block_wide(bsize), self.mi_cols * 4 - x0)
        src = self.src[0][y0:y0 + h, x0:x0 + w].astype(np.int32)
        rp = self._ref_pad(ref, 0)
        P = IP.PAD

        def sad_fullpel(mv):
            dy, dx = mv[0] >> 3, mv[1] >> 3
            blk = rp[P + y0 + dy:P + y0 + dy + h,
                     P + x0 + dx:P + x0 + dx + w].astype(np.int32)
            return int(np.abs(blk - src).sum())

        cands = {(nearest[0] & ~7, nearest[1] & ~7),
                 (near[0] & ~7, near[1] & ~7), (0, 0)}
        best_mv, best_sad = None, None
        for mv in cands:
            s = sad_fullpel(mv)
            if best_sad is None or s < best_sad:
                best_mv, best_sad = mv, s
        # one-step diamond refinement at full pel
        step = 8
        while step >= 8:
            improved = False
            for (dy, dx) in ((-step, 0), (step, 0), (0, -step),
                             (0, step)):
                mv = (best_mv[0] + dy, best_mv[1] + dx)
                if abs(mv[0]) > 1024 or abs(mv[1]) > 1024:
                    continue
                s = sad_fullpel(mv)
                if s < best_sad:
                    best_mv, best_sad = mv, s
                    improved = True
            if not improved:
                step >>= 1

        mv = best_mv
        force_skip = bool(
            self.static_threshold
            and best_sad <= self.static_threshold * h * w // 16)
        dist, bits, txbs = self._code_inter_planes(mi_row, mi_col, bsize,
                                                   mv, ref,
                                                   force_skip=force_skip)
        self._apply_txbs(0, [t for t in txbs if t["plane"] == 0])
        for plane in (1, 2):
            self._apply_txbs(plane,
                             [t for t in txbs if t["plane"] == plane])
        is_chroma_ref = blockd.is_chroma_reference(
            mi_row, mi_col, bsize, self.ss_x, self.ss_y) \
            and self.num_planes > 1
        return dist, dict(
            mi_row=mi_row, mi_col=mi_col, bsize=bsize, is_inter=1,
            mode=0, mv=mv, ref=ref, ref_mv_idx=0, txbs=txbs,
            gm_warp=False, is_chroma_ref=is_chroma_ref,
            y_mode=c.DC_PRED, uv_mode=c.DC_PRED, cfl=None)

    def encode_frame(self, planes, use_jax: bool = False) -> bytes:
        self._var8 = None
        return super().encode_frame(planes, use_jax=use_jax)


def _cyclic_refresh_map(frame_idx: int, sb_rows: int, sb_cols: int,
                        qindex: int, boost: int = 24,
                        refresh_pct: int = 20) -> "np.ndarray":
    """aq_cyclicrefresh.c:536 analog: a rotating ~refresh_pct% slice of
    superblocks is coded at a boosted (lower) qindex each inter frame,
    so every SB gets refreshed periodically without key frames."""
    import numpy as np
    n = sb_rows * sb_cols
    per = max(1, n * refresh_pct // 100)
    start = ((frame_idx - 1) * per) % n
    qmap = np.full((sb_rows, sb_cols), qindex, np.int32)
    idx = (np.arange(per) + start) % n
    qmap.flat[idx] = max(1, qindex - boost)
    return qmap


def encode_realtime_tpu_ivf(path: str, frames, width: int, height: int,
                            qindex: int = 90, fps=(30, 1),
                            device=None) -> None:
    """Device realtime path: wavefront intra key + streaming device
    P-frames with device-resident references (ops/inter
    DeviceRtEncoder) and the native tile emitter, on `device` (the card
    when None).  Strict low delay — one frame in, one packet out; only
    the result rows cross the device boundary per frame.

    Device substitute for the reference's nonrd pickmode hot loop
    (av1/encoder/nonrd_pickmode.c:3035): the "fast mode decision" is an
    exhaustive batched search."""
    from ..bitstream.ivf import write_ivf
    from ..ops.inter import DeviceRtEncoder, rt_frames
    from ..utils.profiler import profile
    from .encoder import make_sequence_header
    from .inter import make_inter_frame_header
    from .lossy import make_lossy_frame_header
    from .tpu_inter import TpuInterFrameEncoder
    from .tpu_intra import TorchAllIntraEncoder

    assert width % 16 == 0 and height % 16 == 0
    sh = make_sequence_header(width, height)
    dev = DeviceRtEncoder(qindex, device=device)
    payloads = []
    slots = [None] * 8

    @profile("encode/rt_emit")
    def emit(i, f, handle):
        # the header and the encoder's set-up read no rows: build them
        # while the step is still on the device, then wait for the rows
        fh = make_inter_frame_header(sh, qindex, deblock=False)
        enc = TpuInterFrameEncoder(sh, fh, slots)
        enc._results = None     # dicts built lazily on emitter fallback
        enc._external_results = True
        enc._external_recon = None
        enc._res_raw = dev.realize(handle)
        payloads.append((enc.encode_frame(f), i))

    # each P frame is emitted right after its own step, before the next
    # frame is pulled: on a paced source its packet never waits for the
    # next camera frame
    for i, f in enumerate(rt_frames(frames)):
        if i == 0:
            fh = make_lossy_frame_header(sh, qindex)
            enc = TorchAllIntraEncoder(sh, fh, device=dev.device)
            enc.lf_search = False
            payloads.append((enc.encode_frame(f), i))
            rec = (enc.recon[0][:height, :width],
                   enc.recon[1][:height >> 1, :width >> 1],
                   enc.recon[2][:height >> 1, :width >> 1])
            slots[0] = tuple(p.copy() for p in rec)
            dev.reset_ref(rec)
            continue
        emit(i, f, dev.encode_frame_async(f))
    write_ivf(path, payloads, width, height, fps[0], fps[1])


def encode_realtime_ivf(path: str, frames, width: int, height: int,
                        qindex: int = 90, fps=(30, 1),
                        aq_mode: int = 0, denoise: bool = False,
                        active_map=None, static_threshold: int = 0,
                        **kw) -> None:
    """RTC low-delay encode: keyframe (speed-1 RD intra) + non-RD
    P-frames.  aq_mode 3 = cyclic refresh (rotating SB q boost);
    denoise = RT temporal denoiser (av1_temporal_denoiser.c analog);
    active_map: per-16x16 active flags (AOME_SET_ACTIVEMAP) — inactive
    blocks code as zero-MV skip on inter frames."""
    from ..bitstream.ivf import write_ivf
    from .encoder import make_sequence_header
    from .inter import make_inter_frame_header
    from .lossy import LossyAllIntraEncoder, make_lossy_frame_header

    sh = make_sequence_header(width, height)
    slots = [None] * 8
    payloads = []
    sb = 64
    sb_rows = -(-height // sb)
    sb_cols = -(-width // sb)
    for i, f in enumerate(frames):
        if i == 0:
            fh = make_lossy_frame_header(sh, qindex)
            # RT speed features (speed_features.c REALTIME defaults at
            # high speed): nonrd-style intra = tiny mode set, square
            # partitions only, no trellis, no tx-type search
            kkw = dict(mode_set=(c.DC_PRED, c.V_PRED, c.H_PRED,
                                 c.SMOOTH_PRED),
                       speed=1, rect_parts=False, trellis=False,
                       tx_search=False, enable_cfl=False,
                       block_size=c.BLOCK_32X32)
            kkw.update(kw)
            enc = LossyAllIntraEncoder(sh, fh, **kkw)
            enc.lf_search = False
        else:
            fh = make_inter_frame_header(sh, qindex, aq=aq_mode == 3)
            enc = RealtimeEncoder(sh, fh, slots, trellis=False, **kw)
            if active_map is not None:
                enc.active_map = np.asarray(active_map, np.uint8)
            enc.static_threshold = int(static_threshold)
            if aq_mode == 3:
                enc.sb_qmap = _cyclic_refresh_map(i, sb_rows, sb_cols,
                                                  qindex)
            if denoise and slots[0] is not None:
                from .denoiser import denoise_frame, estimate_noise_level
                lvl, _ = estimate_noise_level(f[0], slots[0][0])
                f = denoise_frame(f, slots[0], lvl)
        payloads.append((enc.encode_frame(f), i))
        w4, h4 = sh.max_frame_width, sh.max_frame_height
        cw, ch = (w4 + 1) >> 1, (h4 + 1) >> 1
        out = (enc.recon[0][:h4, :w4].copy(),
               enc.recon[1][:ch, :cw].copy(),
               enc.recon[2][:ch, :cw].copy())
        for slot in range(8):
            if fh.refresh_frame_flags & (1 << slot):
                slots[slot] = out
    write_ivf(path, payloads, width, height, fps[0], fps[1])
