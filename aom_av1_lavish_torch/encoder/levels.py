"""AV1 level definitions + enforcement (av1/encoder/level.c analog).

The level table is normative data from AV1 spec Annex A.3; the picker
mirrors av1_update_level_info / get_min_level semantics for the
parameters this encoder controls (picture size, display/decode rate,
bitrate).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class LevelSpec:
    idx: int                 # seq_level_idx
    name: str
    max_picture_size: int    # luma samples
    max_h_size: int
    max_v_size: int
    max_display_rate: int    # samples/s
    max_decode_rate: int
    main_mbps: float
    high_mbps: float         # 0 = high tier not defined
    min_compression: float
    max_tiles: int
    max_tile_cols: int


# AV1 spec Annex A.3 (levels 2.0 .. 6.3; 7.x/8.x are reserved)
LEVELS = (
    LevelSpec(0, "2.0", 147456, 2048, 1152, 4423680, 5529600,
              1.5, 0, 2, 8, 4),
    LevelSpec(1, "2.1", 278784, 2816, 1584, 8363520, 10454400,
              3.0, 0, 2, 8, 4),
    LevelSpec(4, "3.0", 665856, 4352, 2448, 19975680, 24969600,
              6.0, 0, 2, 16, 6),
    LevelSpec(5, "3.1", 1065024, 5504, 3096, 31950720, 39938400,
              10.0, 0, 2, 16, 6),
    LevelSpec(8, "4.0", 2359296, 6144, 3456, 70778880, 77856768,
              12.0, 30.0, 4, 32, 8),
    LevelSpec(9, "4.1", 2359296, 6144, 3456, 141557760, 155713536,
              20.0, 50.0, 4, 32, 8),
    LevelSpec(12, "5.0", 8912896, 8192, 4352, 267386880, 273715200,
              30.0, 100.0, 6, 64, 8),
    LevelSpec(13, "5.1", 8912896, 8192, 4352, 534773760, 547430400,
              40.0, 160.0, 8, 64, 8),
    LevelSpec(14, "5.2", 8912896, 8192, 4352, 1069547520, 1094860800,
              60.0, 240.0, 8, 64, 8),
    LevelSpec(15, "5.3", 8912896, 8192, 4352, 1069547520, 1176502272,
              60.0, 240.0, 8, 64, 8),
    LevelSpec(16, "6.0", 35651584, 16384, 8704, 1069547520, 1176502272,
              60.0, 240.0, 8, 128, 16),
    LevelSpec(17, "6.1", 35651584, 16384, 8704, 2139095040, 2189721600,
              100.0, 480.0, 8, 128, 16),
    LevelSpec(18, "6.2", 35651584, 16384, 8704, 4278190080, 4379443200,
              160.0, 800.0, 8, 128, 16),
    LevelSpec(19, "6.3", 35651584, 16384, 8704, 4278190080, 4706009088,
              160.0, 800.0, 8, 128, 16),
)

LEVEL_MAX = 31   # "maximum parameters" escape level


def check_level(level_idx: int, width: int, height: int,
                fps: float, bitrate_bps: float = 0.0,
                tier: int = 0) -> list:
    """Violations of the given level for a stream's parameters
    (av1_update_level_info checks); empty list = conformant."""
    if level_idx == LEVEL_MAX:
        return []
    spec = next((s for s in LEVELS if s.idx == level_idx), None)
    if spec is None:
        return [f"seq_level_idx {level_idx} is reserved"]
    out = []
    pic = width * height
    if pic > spec.max_picture_size:
        out.append(f"picture size {pic} > {spec.max_picture_size}")
    if width > spec.max_h_size:
        out.append(f"width {width} > {spec.max_h_size}")
    if height > spec.max_v_size:
        out.append(f"height {height} > {spec.max_v_size}")
    if pic * fps > spec.max_display_rate:
        out.append(f"display rate {pic * fps:.0f} > "
                   f"{spec.max_display_rate}")
    if bitrate_bps:
        cap = (spec.high_mbps if tier and spec.high_mbps
               else spec.main_mbps) * 1e6
        # av1 level bitrate limit applies a 1.5x buffer factor on CBR
        if bitrate_bps > cap:
            out.append(f"bitrate {bitrate_bps:.0f} > {cap:.0f}")
    return out


def pick_level(width: int, height: int, fps: float,
               bitrate_bps: float = 0.0, tier: int = 0) -> int:
    """Smallest level whose limits cover the stream (get_min_level)."""
    for spec in LEVELS:
        if not check_level(spec.idx, width, height, fps, bitrate_bps,
                           tier):
            return spec.idx
    return LEVEL_MAX
