"""Standalone RTC rate-control oracle (no encode).

Re-design of the reference's C++ WebRTC-style controller
(av1/ratectrl_rtc.cc, AV1RateControlRtcConfig av1/ratectrl_rtc.h:35):
external callers (e.g. a hardware encoder or a transport stack) feed
frame events and read back QP + loop-filter levels per frame, while the
encode itself happens elsewhere.  Wraps encoder/ratectrl.py's buffer
model and the deblock-level heuristic the encoder uses.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..common.loopfilter import pick_filter_level_from_q
from .ratectrl import MODE_CBR, RateControl, RateControlConfig


@dataclass
class RateControlRtcConfig:
    """AV1RateControlRtcConfig mirror (ratectrl_rtc.h:35)."""
    width: int = 352
    height: int = 288
    target_bandwidth_kbps: int = 400
    framerate: float = 30.0
    max_quantizer: int = 255
    min_quantizer: int = 4
    buf_initial_sz_ms: int = 500
    buf_optimal_sz_ms: int = 600
    buf_sz_ms: int = 1000
    # temporal layers: per-layer rate share (fractions summing to 1)
    ts_number_layers: int = 1
    ts_rate_share: tuple = (1.0,)


@dataclass
class RateControlRtcFrameParams:
    """Per-frame input (AV1FrameParamsRTC)."""
    frame_type: str = "inter"       # "key" | "inter"
    temporal_layer_id: int = 0


class RateControlRtc:
    """Per-frame QP/loopfilter oracle (AV1RateControlRTC mirror:
    ComputeQP -> GetQP/GetLoopfilterLevel -> PostEncodeUpdate)."""

    def __init__(self, cfg: RateControlRtcConfig):
        self.cfg = cfg
        self._layers = []
        n = max(1, cfg.ts_number_layers)
        share = cfg.ts_rate_share if len(cfg.ts_rate_share) == n \
            else tuple(1.0 / n for _ in range(n))
        for li in range(n):
            # each temporal layer runs its own leaky bucket at its
            # cumulative rate (svc_layercontext.c analog)
            rate = cfg.target_bandwidth_kbps * 1000 * sum(share[:li + 1])
            fps = cfg.framerate * (2 ** (li + 1 - n)) if n > 1 \
                else cfg.framerate
            self._layers.append(RateControl(RateControlConfig(
                target_bps=int(rate), fps=fps, width=cfg.width,
                height=cfg.height, mode=MODE_CBR,
                worst_q=cfg.max_quantizer, best_q=cfg.min_quantizer,
                buf_initial_ms=cfg.buf_initial_sz_ms,
                buf_optimal_ms=cfg.buf_optimal_sz_ms,
                buf_sz_ms=cfg.buf_sz_ms, recode=False)))
        self._qp = cfg.min_quantizer
        self._kind = "inter"
        self._layer = 0

    def compute_qp(self, fp: RateControlRtcFrameParams) -> None:
        """av1_rc_pick_q_and_bounds for the frame event."""
        self._layer = min(fp.temporal_layer_id, len(self._layers) - 1)
        self._kind = "key" if fp.frame_type == "key" else "inter"
        self._qp = self._layers[self._layer].pick_q(self._kind)

    def get_qp(self) -> int:
        return self._qp

    def get_loopfilter_level(self) -> int:
        return pick_filter_level_from_q(self._qp,
                                        frame_is_key=self._kind == "key")

    def post_encode_update(self, encoded_frame_size_bytes: int) -> None:
        self._layers[self._layer].postencode(
            self._kind, self._qp, encoded_frame_size_bytes * 8)
