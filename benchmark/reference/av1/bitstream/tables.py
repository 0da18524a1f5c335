"""Load the normative AV1 constant tables (default CDFs, scans, quant LUTs).

Data lives in data/av1_tables.npz (regenerate with tools/dump_tables.c +
tools/convert_tables.py).  Shapes follow the reference FRAME_CONTEXT layout
(av1/common/entropymode.h:47-140); every CDF row carries a trailing
adaptation-counter slot (CDF_SIZE(n) == n + 1).
"""

from __future__ import annotations

import os
from functools import lru_cache

import numpy as np

from . import constants as c

_DATA = os.path.join(os.path.dirname(__file__), "..", "..", "data",
                     "av1_tables.npz")

# name -> logical shape (flat arrays in the npz)
_SHAPES = {
    "newmv_cdf": (c.NEWMV_MODE_CONTEXTS, 3),
    "zeromv_cdf": (c.GLOBALMV_MODE_CONTEXTS, 3),
    "refmv_cdf": (c.REFMV_MODE_CONTEXTS, 3),
    "drl_cdf": (c.DRL_MODE_CONTEXTS, 3),
    "inter_compound_mode_cdf": (c.INTER_MODE_CONTEXTS, c.INTER_COMPOUND_MODES + 1),
    "compound_type_cdf": (c.BLOCK_SIZES_ALL, c.MASKED_COMPOUND_TYPES + 1),
    "wedge_idx_cdf": (c.BLOCK_SIZES_ALL, 17),
    "interintra_cdf": (c.BLOCK_SIZE_GROUPS, 3),
    "wedge_interintra_cdf": (c.BLOCK_SIZES_ALL, 3),
    "interintra_mode_cdf": (c.BLOCK_SIZE_GROUPS, c.INTERINTRA_MODES + 1),
    "motion_mode_cdf": (c.BLOCK_SIZES_ALL, c.MOTION_MODES + 1),
    "obmc_cdf": (c.BLOCK_SIZES_ALL, 3),
    "palette_y_size_cdf": (c.PALETTE_BSIZE_CTXS, c.PALETTE_SIZES + 1),
    "palette_uv_size_cdf": (c.PALETTE_BSIZE_CTXS, c.PALETTE_SIZES + 1),
    "palette_y_color_index_cdf": (
        c.PALETTE_SIZES, c.PALETTE_COLOR_INDEX_CONTEXTS, c.PALETTE_COLORS + 1),
    "palette_uv_color_index_cdf": (
        c.PALETTE_SIZES, c.PALETTE_COLOR_INDEX_CONTEXTS, c.PALETTE_COLORS + 1),
    "palette_y_mode_cdf": (c.PALETTE_BSIZE_CTXS, c.PALETTE_Y_MODE_CONTEXTS, 3),
    "palette_uv_mode_cdf": (c.PALETTE_UV_MODE_CONTEXTS, 3),
    "comp_inter_cdf": (c.COMP_INTER_CONTEXTS, 3),
    "single_ref_cdf": (c.REF_CONTEXTS, c.SINGLE_REFS - 1, 3),
    "comp_ref_type_cdf": (c.COMP_REF_TYPE_CONTEXTS, 3),
    "uni_comp_ref_cdf": (c.UNI_COMP_REF_CONTEXTS, c.UNIDIR_COMP_REFS - 1, 3),
    "comp_ref_cdf": (c.REF_CONTEXTS, c.FWD_REFS - 1, 3),
    "comp_bwdref_cdf": (c.REF_CONTEXTS, c.BWD_REFS - 1, 3),
    "txfm_partition_cdf": (c.TXFM_PARTITION_CONTEXTS, 3),
    "compound_index_cdf": (c.COMP_INDEX_CONTEXTS, 3),
    "comp_group_idx_cdf": (c.COMP_GROUP_IDX_CONTEXTS, 3),
    "skip_mode_cdfs": (c.SKIP_MODE_CONTEXTS, 3),
    "skip_txfm_cdfs": (c.SKIP_CONTEXTS, 3),
    "intra_inter_cdf": (c.INTRA_INTER_CONTEXTS, 3),
    "nmv_joints_cdf": (c.MV_JOINTS + 1,),
    "intrabc_cdf": (3,),
    "seg_pred_cdf": (c.SEG_TEMPORAL_PRED_CTXS, 3),
    "seg_spatial_pred_cdf": (c.SPATIAL_PREDICTION_PROBS, c.MAX_SEGMENTS + 1),
    "filter_intra_cdfs": (c.BLOCK_SIZES_ALL, 3),
    "filter_intra_mode_cdf": (c.FILTER_INTRA_MODES + 1,),
    "switchable_restore_cdf": (c.RESTORE_SWITCHABLE_TYPES + 1,),
    "wiener_restore_cdf": (3,),
    "sgrproj_restore_cdf": (3,),
    "y_mode_cdf": (c.BLOCK_SIZE_GROUPS, c.INTRA_MODES + 1),
    "uv_mode_cdf": (2, c.INTRA_MODES, c.UV_INTRA_MODES + 1),
    "partition_cdf": (c.PARTITION_CONTEXTS, c.EXT_PARTITION_TYPES + 1),
    "switchable_interp_cdf": (c.SWITCHABLE_FILTER_CONTEXTS,
                              c.SWITCHABLE_FILTERS + 1),
    "kf_y_cdf": (c.KF_MODE_CONTEXTS, c.KF_MODE_CONTEXTS, c.INTRA_MODES + 1),
    "angle_delta_cdf": (c.DIRECTIONAL_MODES, 2 * c.MAX_ANGLE_DELTA + 2),
    "tx_size_cdf": (c.MAX_TX_CATS, c.TX_SIZE_CONTEXTS, c.MAX_TX_DEPTH + 2),
    "delta_q_cdf": (c.DELTA_Q_PROBS + 2,),
    "delta_lf_multi_cdf": (c.FRAME_LF_COUNT, c.DELTA_LF_PROBS + 2),
    "delta_lf_cdf": (c.DELTA_LF_PROBS + 2,),
    "intra_ext_tx_cdf": (c.EXT_TX_SETS_INTRA, c.EXT_TX_SIZES, c.INTRA_MODES,
                         c.TX_TYPES + 1),
    "inter_ext_tx_cdf": (c.EXT_TX_SETS_INTER, c.EXT_TX_SIZES, c.TX_TYPES + 1),
    "cfl_sign_cdf": (c.CFL_JOINT_SIGNS + 1,),
    "cfl_alpha_cdf": (c.CFL_ALPHA_CONTEXTS, c.CFL_ALPHABET_SIZE + 1),
    # nmv components
    "nmv_comp0_classes_cdf": (c.MV_CLASSES + 1,),
    "nmv_comp0_class0_fp_cdf": (c.CLASS0_SIZE, c.MV_FP_SIZE + 1),
    "nmv_comp0_fp_cdf": (c.MV_FP_SIZE + 1,),
    "nmv_comp0_sign_cdf": (3,),
    "nmv_comp0_class0_hp_cdf": (3,),
    "nmv_comp0_hp_cdf": (3,),
    "nmv_comp0_class0_cdf": (3,),
    "nmv_comp0_bits_cdf": (c.MV_OFFSET_BITS, 3),
    "nmv_comp1_classes_cdf": (c.MV_CLASSES + 1,),
    "nmv_comp1_class0_fp_cdf": (c.CLASS0_SIZE, c.MV_FP_SIZE + 1),
    "nmv_comp1_fp_cdf": (c.MV_FP_SIZE + 1,),
    "nmv_comp1_sign_cdf": (3,),
    "nmv_comp1_class0_hp_cdf": (3,),
    "nmv_comp1_hp_cdf": (3,),
    "nmv_comp1_class0_cdf": (3,),
    "nmv_comp1_bits_cdf": (c.MV_OFFSET_BITS, 3),
    # banded coefficient CDFs: leading dim = TOKEN_CDF_Q_CTXS
    "av1_default_txb_skip_cdfs": (4, c.TX_SIZES, c.TXB_SKIP_CONTEXTS, 3),
    "av1_default_eob_extra_cdfs": (4, c.TX_SIZES, c.PLANE_TYPES,
                                   c.EOB_COEF_CONTEXTS, 3),
    "av1_default_dc_sign_cdfs": (4, c.PLANE_TYPES, c.DC_SIGN_CONTEXTS, 3),
    "av1_default_coeff_lps_multi_cdfs": (4, c.TX_SIZES, c.PLANE_TYPES,
                                         c.LEVEL_CONTEXTS, c.BR_CDF_SIZE + 1),
    "av1_default_coeff_base_multi_cdfs": (4, c.TX_SIZES, c.PLANE_TYPES,
                                          c.SIG_COEF_CONTEXTS, 5),
    "av1_default_coeff_base_eob_multi_cdfs": (4, c.TX_SIZES, c.PLANE_TYPES,
                                              c.SIG_COEF_CONTEXTS_EOB, 4),
    "av1_default_eob_multi16_cdfs": (4, c.PLANE_TYPES, 2, 6),
    "av1_default_eob_multi32_cdfs": (4, c.PLANE_TYPES, 2, 7),
    "av1_default_eob_multi64_cdfs": (4, c.PLANE_TYPES, 2, 8),
    "av1_default_eob_multi128_cdfs": (4, c.PLANE_TYPES, 2, 9),
    "av1_default_eob_multi256_cdfs": (4, c.PLANE_TYPES, 2, 10),
    "av1_default_eob_multi512_cdfs": (4, c.PLANE_TYPES, 2, 11),
    "av1_default_eob_multi1024_cdfs": (4, c.PLANE_TYPES, 2, 12),
    "dc_quant_qtx": (3, 256),
    "resize_filter_normative": (64, 8),
    "ac_quant_qtx": (3, 256),
}


@lru_cache(maxsize=1)
def _raw():
    return np.load(_DATA)


@lru_cache(maxsize=None)
def get(name: str) -> np.ndarray:
    """Return a table reshaped to its logical shape (read-only)."""
    arr = _raw()[name]
    shape = _SHAPES.get(name)
    if shape is not None:
        assert arr.size == int(np.prod(shape)), (name, arr.size, shape)
        arr = arr.reshape(shape)
    arr.setflags(write=False)
    return arr


@lru_cache(maxsize=None)
def scan(tx_size: int, tx_type: int) -> np.ndarray:
    """Coefficient scan order for (tx_size, tx_type); length = visible coeffs."""
    return get(f"scan_{tx_size}_{tx_type}")


@lru_cache(maxsize=None)
def iscan(tx_size: int, tx_type: int) -> np.ndarray:
    return get(f"iscan_{tx_size}_{tx_type}")


def coef_q_ctx(base_qindex: int) -> int:
    """Quality band for coefficient default CDFs (entropy.c get_q_ctx)."""
    if base_qindex <= 20:
        return 0
    if base_qindex <= 60:
        return 1
    if base_qindex <= 120:
        return 2
    return 3


class FrameContext:
    """Mutable per-frame CDF state: dict of numpy arrays initialized from
    the defaults, adapted in place during encode/decode (host path).

    Attribute access (fc.partition_cdf etc.) returns the mutable array.
    """

    _MODE_FIELDS = [
        k for k in _SHAPES
        if not k.startswith(("av1_default_", "dc_quant", "ac_quant"))
    ]

    _COEF_MAP = {
        "txb_skip_cdf": "av1_default_txb_skip_cdfs",
        "eob_extra_cdf": "av1_default_eob_extra_cdfs",
        "dc_sign_cdf": "av1_default_dc_sign_cdfs",
        "coeff_br_cdf": "av1_default_coeff_lps_multi_cdfs",
        "coeff_base_cdf": "av1_default_coeff_base_multi_cdfs",
        "coeff_base_eob_cdf": "av1_default_coeff_base_eob_multi_cdfs",
        "eob_flag_cdf16": "av1_default_eob_multi16_cdfs",
        "eob_flag_cdf32": "av1_default_eob_multi32_cdfs",
        "eob_flag_cdf64": "av1_default_eob_multi64_cdfs",
        "eob_flag_cdf128": "av1_default_eob_multi128_cdfs",
        "eob_flag_cdf256": "av1_default_eob_multi256_cdfs",
        "eob_flag_cdf512": "av1_default_eob_multi512_cdfs",
        "eob_flag_cdf1024": "av1_default_eob_multi1024_cdfs",
    }

    def __init__(self, base_qindex: int = 0) -> None:
        d = {}
        for k in self._MODE_FIELDS:
            d[k] = np.array(get(k), dtype=np.uint16)
        # intrabc MVs (ndvc) start from the same defaults as nmvc
        for comp in (0, 1):
            for f in ("classes_cdf", "class0_fp_cdf", "fp_cdf", "sign_cdf",
                      "class0_hp_cdf", "hp_cdf", "class0_cdf", "bits_cdf"):
                d[f"ndv_comp{comp}_{f}"] = np.array(
                    get(f"nmv_comp{comp}_{f}"), dtype=np.uint16)
        d["ndv_joints_cdf"] = np.array(get("nmv_joints_cdf"), dtype=np.uint16)
        qctx = coef_q_ctx(base_qindex)
        for field, src in self._COEF_MAP.items():
            d[field] = np.array(get(src)[qctx], dtype=np.uint16)
        self._d = d

    def __getattr__(self, name: str) -> np.ndarray:
        if name == "_d":
            # not set yet (e.g. during unpickling, before __dict__ is
            # restored): must raise instead of recursing through _d
            raise AttributeError(name)
        try:
            return self._d[name]
        except KeyError:
            raise AttributeError(name) from None

    def copy(self) -> "FrameContext":
        out = object.__new__(FrameContext)
        out._d = {k: v.copy() for k, v in self._d.items()}
        return out

    def reset_counters(self) -> None:
        """Zero every CDF adaptation counter (av1_reset_cdf_symbol_counters,
        entropy.c:86) - required when a frame context is stored for later
        frames.  The counter lives at cdf[nsymbs], which for tables read
        with fewer symbols than the row holds is NOT the last slot."""
        for k, v in self._d.items():
            if k == "partition_cdf":
                v[:4, 4] = 0
                v[4:16, 10] = 0
                v[16:, 8] = 0
            elif k == "uv_mode_cdf":
                v[0, :, 13] = 0
                v[1, :, 14] = 0
            elif k == "tx_size_cdf":
                v[0, :, 2] = 0
                v[1:, :, 3] = 0
            elif k == "intra_ext_tx_cdf":
                v[1, ..., 7] = 0
                v[2, ..., 5] = 0
            elif k == "inter_ext_tx_cdf":
                v[1, ..., 16] = 0
                v[2, ..., 12] = 0
                v[3, ..., 2] = 0
            elif k in ("palette_y_color_index_cdf",
                       "palette_uv_color_index_cdf"):
                for j in range(v.shape[0]):
                    v[j, :, j + 2] = 0
            else:
                v[..., -1] = 0
