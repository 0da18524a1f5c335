"""Temporal SVC (scalable video coding) encoding.

Re-designs the reference's SVC controller (av1/encoder/svc_layercontext.c
av1_update_layer_context / aom_svc_params) for temporal layers: a dyadic
layer pattern where enhancement-layer frames are non-references, frame
OBUs carry temporal_id extension headers, and the sequence header
advertises the layer structure through operating_point_idc.  A decoder
(ours via max_temporal_layer, or any conformant one dropping high tids)
can decode the base layer alone bit-exactly.
"""

from __future__ import annotations

from ..bitstream import constants as c
from ..bitstream import headers as H
from .encoder import make_sequence_header
from .inter import InterFrameEncoder, make_inter_frame_header
from .lossy import LossyAllIntraEncoder, make_lossy_frame_header


def temporal_layer_of(frame_idx: int, layers: int) -> int:
    """Dyadic pattern: layer = number of trailing period bits set."""
    if layers <= 1 or frame_idx == 0:
        return 0
    period = 1 << (layers - 1)
    pos = frame_idx % period
    for lvl in range(layers - 1, 0, -1):
        if pos % (1 << (layers - lvl)) == (1 << (layers - lvl - 1)):
            return lvl
    return 0


def _retag(payload: bytes, tid: int, sid: int = 0) -> bytes:
    """Re-wrap a temporal unit's OBUs with a temporal/spatial-id
    extension."""
    out = bytearray()
    for t, p in H.split_obus(payload):
        if t in (c.OBU_FRAME, c.OBU_FRAME_HEADER, c.OBU_TILE_GROUP):
            out += H.wrap_obu(t, p, temporal_id=tid, spatial_id=sid)
        else:
            out += H.wrap_obu(t, p)
    return bytes(out)


def encode_svc_ivf(path: str, frames, width: int, height: int,
                   temporal_layers: int = 2, qindex: int = 90,
                   layer_q_boost: int = 12, fps=(30, 1), **kw) -> None:
    """Temporal-SVC low-delay encode.

    Base layer (tid 0) frames reference and refresh slot 0; enhancement
    frames reference the most recent lower-layer frame and refresh
    nothing (so dropping them never breaks the chain).  Enhancement
    layers run at a higher q (standard SVC rate ladder)."""
    from ..bitstream.ivf import write_ivf
    assert 1 <= temporal_layers <= 3
    sh = make_sequence_header(width, height)
    # operating_point_idc: spatial layer 0 + all temporal layers
    sh.operating_point_idc = (1 << 8) | ((1 << temporal_layers) - 1)
    slots = [None] * 8
    slot_time = [-1] * 8     # frame index stored in each slot
    slot_tid = [9] * 8
    payloads = []
    for i, f in enumerate(frames):
        tid = temporal_layer_of(i, temporal_layers)
        q = min(255, qindex + layer_q_boost * tid)
        if i == 0:
            fh = make_lossy_frame_header(sh, q)
            enc = LossyAllIntraEncoder(sh, fh, **kw)
        else:
            refresh = 0 if (tid == temporal_layers - 1 and tid > 0) \
                else (1 << tid)
            # LAST = newest stored frame from a lower-or-equal layer
            cands = [s for s in range(8)
                     if slot_time[s] >= 0 and slot_tid[s] <= tid]
            ref_slot = max(cands, key=lambda s: slot_time[s])
            fh = make_inter_frame_header(
                sh, q, refresh_frame_flags=refresh,
                ref_frame_idx=(ref_slot,) * 7)
            enc = InterFrameEncoder(sh, fh, slots, **kw)
        payload = enc.encode_frame(f)
        w4, h4 = sh.max_frame_width, sh.max_frame_height
        cw, ch = (w4 + 1) >> 1, (h4 + 1) >> 1
        out = (enc.recon[0][:h4, :w4].copy(),
               enc.recon[1][:ch, :cw].copy(),
               enc.recon[2][:ch, :cw].copy())
        for slot in range(8):
            if fh.refresh_frame_flags & (1 << slot):
                slots[slot] = out
                slot_time[slot] = i
                slot_tid[slot] = tid
        payloads.append((_retag(payload, tid), i))
    write_ivf(path, payloads, width, height, fps[0], fps[1])


# ---------------------------------------------------------------------------
# Spatial SVC (svc_layercontext.c spatial layers / examples/svc_encoder_rtc.c)

def _downscale_plane(plane, out_w: int, out_h: int):
    """Source downsampling for the base layer (non-normative; reference
    analog av1_resize_plane): separable bilinear via the superres
    downscaler run in both directions."""
    import numpy as np
    from ..common.resize import downscale_plane_horz
    t = downscale_plane_horz(plane, out_w)
    t = downscale_plane_horz(np.ascontiguousarray(t.T), out_h)
    return np.ascontiguousarray(t.T)


def encode_svc_spatial_ivf(path: str, frames, width: int, height: int,
                           qindex: int = 80, base_q_boost: int = 14,
                           fps=(30, 1), **kw) -> None:
    """Two-spatial-layer SVC encode (L2T1).

    Each temporal unit carries the base layer at half resolution
    (spatial_id 0, ref slot 1) followed by the enhancement layer at full
    resolution (spatial_id 1, ref slot 0).  The enhancement layer uses
    inter-layer prediction: GOLDEN points at the *current* base-layer
    recon, motion-compensated through the scaled-reference convolve
    (spec is_scaled path), plus normal temporal prediction from the
    previous enhancement frame via LAST.  Decoding only spatial layer 0
    (operating-point drop) yields a valid half-resolution stream.

    Reference: av1/encoder/svc_layercontext.c layer contexts + ref map,
    examples/svc_encoder_rtc.c L2T1 pattern."""
    import numpy as np
    from ..bitstream.ivf import write_ivf
    assert width % 2 == 0 and height % 2 == 0
    bw, bh = width // 2, height // 2
    assert bw % 2 == 0 and bh % 2 == 0, "chroma halves must be integral"
    sh = make_sequence_header(width, height)
    # one operating point spanning both spatial layers at tid 0
    sh.operating_point_idc = (0b11 << 8) | 0b1
    slots = [None] * 8
    payloads = []

    def store(enc, fh):
        w_, h_ = fh.frame_width, fh.frame_height
        cw, ch = (w_ + 1) >> 1, (h_ + 1) >> 1
        out = (enc.recon[0][:h_, :w_].copy(),
               enc.recon[1][:ch, :cw].copy(),
               enc.recon[2][:ch, :cw].copy())
        flags = 0xFF if (fh.frame_type == c.KEY_FRAME and fh.show_frame) \
            else fh.refresh_frame_flags
        for s in range(8):
            if flags & (1 << s):
                slots[s] = out

    for i, f in enumerate(frames):
        q0 = min(255, qindex + base_q_boost)
        base_f = (_downscale_plane(f[0], bw, bh),
                  _downscale_plane(f[1], bw // 2, bh // 2),
                  _downscale_plane(f[2], bw // 2, bh // 2))
        # --- spatial layer 0 (half resolution) ---
        if i == 0:
            fh0 = make_lossy_frame_header(sh, q0, width=bw, height=bh)
            enc0 = LossyAllIntraEncoder(sh, fh0, **kw)
        else:
            fh0 = make_inter_frame_header(
                sh, q0, refresh_frame_flags=1 << 1,
                ref_frame_idx=(1,) * 7, width=bw, height=bh)
            enc0 = InterFrameEncoder(sh, fh0, slots, **kw)
        p0 = enc0.encode_frame(base_f)
        store(enc0, fh0)
        # --- spatial layer 1 (full resolution, inter-layer GOLDEN) ---
        ref_idx = [1] * 7
        if i > 0:
            ref_idx[c.LAST_FRAME - 1] = 0
        fh1 = make_inter_frame_header(
            sh, qindex, refresh_frame_flags=1 << 0,
            ref_frame_idx=tuple(ref_idx))
        ref_list = (c.LAST_FRAME, c.GOLDEN_FRAME) if i > 0 \
            else (c.GOLDEN_FRAME,)
        enc1 = InterFrameEncoder(sh, fh1, slots, ref_list=ref_list, **kw)
        p1 = enc1.encode_frame(f)
        store(enc1, fh1)
        tu = _retag(p0, 0, 0) + _retag(p1, 0, 1)
        payloads.append((tu, i))
    write_ivf(path, payloads, width, height, fps[0], fps[1])


def encode_svc_layered_ivf(path: str, frames, width: int, height: int,
                           spatial_layers: int = 3,
                           temporal_layers: int = 3,
                           qindex: int = 80, base_q_boost: int = 10,
                           layer_q_boost: int = 10, fps=(30, 1),
                           **kw) -> None:
    """General LxTy SVC encode (x spatial <= 3, y temporal <= 3) — the
    svc_encoder_rtc.c L3T3 pattern (av1/encoder/svc_layercontext.c:646
    layer contexts / ref-map management).

    Per temporal unit: spatial layers bottom-up at 1:2:4 resolutions;
    each layer predicts temporally from its own newest allowed slot
    (dyadic tid rules) and inter-layer from the CURRENT frame of the
    layer below (scaled GOLDEN).  Slot map (8 slots):
      s*2 + {0,1}: layer s frames of tid 0 / tid 1
      6, 7:        scratch chain for droppable top-tid frames so upper
                   spatial layers can still inter-layer predict
    Dropping the top temporal layer never breaks any chain; dropping
    upper spatial layers leaves lower ones decodable (operating-point
    drop, obu.c:172)."""
    import numpy as np
    from ..bitstream.ivf import write_ivf
    S, T = spatial_layers, temporal_layers
    assert 1 <= S <= 3 and 1 <= T <= 3
    scale = 1 << (S - 1)
    assert width % (2 * scale) == 0 and height % (2 * scale) == 0
    sh = make_sequence_header(width, height)
    sh.operating_point_idc = (((1 << S) - 1) << 8) | ((1 << T) - 1)
    slots = [None] * 8
    slot_time = [-1] * 8
    slot_tid = [9] * 8
    payloads = []

    def layer_dims(s):
        f = 1 << (S - 1 - s)
        return width // f, height // f

    def srcs_of(f):
        out = [None] * S
        out[S - 1] = f
        for s in range(S - 2, -1, -1):
            w_, h_ = layer_dims(s)
            out[s] = (_downscale_plane(f[0], w_, h_),
                      _downscale_plane(f[1], w_ // 2, h_ // 2),
                      _downscale_plane(f[2], w_ // 2, h_ // 2))
        return out

    def store(enc, fh, slot, i, tid):
        if slot is None:
            return
        w_, h_ = fh.frame_width, fh.frame_height
        cw, ch = (w_ + 1) >> 1, (h_ + 1) >> 1
        slots[slot] = (enc.recon[0][:h_, :w_].copy(),
                       enc.recon[1][:ch, :cw].copy(),
                       enc.recon[2][:ch, :cw].copy())
        slot_time[slot] = i
        slot_tid[slot] = tid

    for i, f in enumerate(frames):
        tid = temporal_layer_of(i, T)
        srcs = srcs_of(f)
        tu = b""
        below_slot = None   # slot holding the CURRENT lower layer
        for s in range(S):
            w_, h_ = layer_dims(s)
            q = min(255, qindex + layer_q_boost * tid
                    + base_q_boost * (S - 1 - s))
            top_tid = tid == T - 1 and tid > 0 and T > 2
            if top_tid:
                refresh_slot = 6 + s if s < 2 else None
            else:
                refresh_slot = s * 2 + min(tid, 1)
            refresh = (1 << refresh_slot) if refresh_slot is not None \
                else 0
            if i == 0 and s == 0:
                fh = make_lossy_frame_header(sh, q, width=w_, height=h_)
                enc = LossyAllIntraEncoder(sh, fh, **kw)
                p = enc.encode_frame(srcs[s])
                # key frames refresh everything
                for sl in range(8):
                    store(enc, fh, sl, i, 0)
                tu += _retag(p, tid, s)
                below_slot = 0
                continue
            ref_idx = [0] * 7
            ref_list = []
            own = [sl for sl in (s * 2, s * 2 + 1)
                   if slot_time[sl] >= 0 and slot_tid[sl] <= tid]
            if i > 0 and own:
                last_slot = max(own, key=lambda sl: slot_time[sl])
                ref_idx[c.LAST_FRAME - 1] = last_slot
                ref_list.append(c.LAST_FRAME)
            if s > 0 and below_slot is not None:
                ref_idx[c.GOLDEN_FRAME - 1] = below_slot
                ref_list.append(c.GOLDEN_FRAME)
            assert ref_list, "layer frame with no reference"
            fh = make_inter_frame_header(
                sh, q, refresh_frame_flags=refresh,
                ref_frame_idx=tuple(ref_idx), width=w_, height=h_)
            enc = InterFrameEncoder(sh, fh, slots,
                                    ref_list=tuple(ref_list), **kw)
            p = enc.encode_frame(srcs[s])
            store(enc, fh, refresh_slot, i, tid)
            if refresh_slot is not None:
                below_slot = refresh_slot
            else:
                below_slot = None
            tu += _retag(p, tid, s)
        payloads.append((tu, i))
    write_ivf(path, payloads, width, height, fps[0], fps[1])
