"""Speed features: the --cpu-used 0..9 preset table.

Re-designs av1/encoder/speed_features.c (av1_set_speed_features_framesize
_independent, speed_features.c:2240) as one declarative table mapping a
speed level to the pruning/search knobs this encoder actually has.  Each
level must be monotonically cheaper than the previous one; quality may
only degrade.

Levels 0-6 drive the good-quality GOP encoder; 7-9 additionally shrink
the search geometry (the dedicated realtime path lives in
encoder/nonrd.py and is selected by usage, not cpu-used, like the
reference's REALTIME config).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..bitstream import constants as c

#: full intra mode set (lossy.ALL_Y_MODES mirror; avoids an import cycle)
_ALL_MODES = tuple(range(c.INTRA_MODES))
#: directional + core smooth set (winner-mode pool of the mid speeds:
#: DC..D67 directionals + SMOOTH + PAETH, drops SMOOTH_V/SMOOTH_H)
_MID_MODES = tuple(range(9)) + (c.SMOOTH_PRED, c.PAETH_PRED)
#: core set (av1 intra_default at high speeds: DC/V/H/SMOOTH/PAETH)
_FAST_MODES = (c.DC_PRED, c.V_PRED, c.H_PRED, c.SMOOTH_PRED,
               c.PAETH_PRED)


@dataclass(frozen=True)
class SpeedFeatures:
    """Knob bundle one cpu-used level resolves to."""
    cpu_used: int
    ext_parts: bool          # AB + 4:1 partition shapes in the RD search
    rect_parts: bool         # HORZ/VERT partition candidates
    ml_partition_prune: int  # lossy `speed` knob (>=1: ML pruning)
    mode_set: tuple          # intra luma candidate modes
    tx_search: bool          # tx-type RD search on the winner
    tx_select: bool          # TX_MODE_SELECT depth search
    trellis: bool            # coeff trellis (optimize_txb)
    motion_modes: bool       # OBMC / WARPED_CAUSAL trials
    comp_search: bool        # explicit compound-average trials
    compound_types: bool     # wedge / diffwtd masked-compound RD
    interintra: bool         # interintra (smooth + wedge) RD
    interp_search: bool      # frame interp-filter search
    search_method: str       # fullpel pattern
    search_range: int        # fullpel search radius
    enable_tpl: bool         # TPL model pass
    enable_tf: bool          # ARF temporal filtering
    min_block: int           # partition search floor (BLOCK_*)


_TABLE = {
    0: SpeedFeatures(0, True, True, 0, _ALL_MODES, True, True, True,
                     True, True, True, True, True, "bigdia", 24, True,
                     True, c.BLOCK_8X8),
    1: SpeedFeatures(1, False, True, 1, _ALL_MODES, True, True, True,
                     True, True, True, True, True, "bigdia", 20, True,
                     True, c.BLOCK_8X8),
    2: SpeedFeatures(2, False, True, 1, _ALL_MODES, False, True, True,
                     True, True, True, False, False, "diamond", 16, True,
                     True, c.BLOCK_8X8),
    3: SpeedFeatures(3, False, True, 1, _MID_MODES, False, True, True,
                     True, False, False, False, False, "diamond", 16,
                     True, True, c.BLOCK_16X16),
    4: SpeedFeatures(4, False, True, 1, _MID_MODES, False, True, True,
                     False, False, False, False, False, "hex", 16, True,
                     True, c.BLOCK_16X16),
    5: SpeedFeatures(5, False, True, 1, _FAST_MODES, False, True, False,
                     False, False, False, False, False, "hex", 12, True,
                     True, c.BLOCK_16X16),
    6: SpeedFeatures(6, False, True, 1, _FAST_MODES, False, False, False,
                     False, False, False, False, False, "hex", 12, False,
                     True, c.BLOCK_16X16),
    7: SpeedFeatures(7, False, False, 1, _FAST_MODES, False, False,
                     False, False, False, False, False, False, "hex", 8,
                     False, True, c.BLOCK_16X16),
    8: SpeedFeatures(8, False, False, 1, (c.DC_PRED, c.V_PRED, c.H_PRED),
                     False, False, False, False, False, False, False,
                     False, "hex", 8, False, False, c.BLOCK_16X16),
    9: SpeedFeatures(9, False, False, 1, (c.DC_PRED,), False, False,
                     False, False, False, False, False, False, "diamond",
                     4, False, False, c.BLOCK_16X16),
}


def speed_features_for(cpu_used: int) -> SpeedFeatures:
    """Resolve a cpu-used level (clamped to 0..9) to its knob bundle."""
    return _TABLE[max(0, min(9, int(cpu_used)))]


def adjust_framesize(sf: SpeedFeatures, width: int,
                     height: int) -> SpeedFeatures:
    """Resolution-dependent knob adjustment
    (av1_set_speed_features_framesize_dependent, speed_features.c:2202):
    large frames shrink the search geometry and partition depth at the
    same cpu-used — per-pixel cost must not grow with resolution."""
    from dataclasses import replace
    area = width * height
    if area >= 1920 * 1080:
        return replace(
            sf,
            search_range=min(sf.search_range, 12),
            min_block=max(sf.min_block, c.BLOCK_16X16),
            compound_types=False, interintra=False,
            ext_parts=False)
    if area >= 1280 * 720:
        return replace(
            sf,
            search_range=min(sf.search_range, 16),
            min_block=(max(sf.min_block, c.BLOCK_8X8)
                       if sf.cpu_used >= 3 else sf.min_block),
            ext_parts=sf.ext_parts and sf.cpu_used == 0)
    return sf


def adjust_qindex(sf: SpeedFeatures, qindex: int) -> SpeedFeatures:
    """Q-dependent knob adjustment
    (..._qindex_dependent, speed_features.c:2385): at very coarse q the
    residual is mostly zero, so the coefficient-side searches (trellis,
    tx-type) stop paying for themselves."""
    from dataclasses import replace
    if qindex >= 200:
        return replace(sf, trellis=False, tx_search=False)
    if qindex >= 160 and sf.cpu_used >= 2:
        return replace(sf, tx_search=False)
    return sf
