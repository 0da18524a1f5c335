"""Decoder inspection + bit accounting.

Re-designs the reference's introspection surface (av1/decoder/inspection.c
ifd_inspect — per-mi mode/mv/tx/q grids for tools like the bitstream
analyzer — and av1/decoder/accounting.c symbol bit accounting) as a
frame-hook API:

    for info in inspect_ivf("in.ivf"):
        info.mode_grid, info.mv_grid, info.qindex_grid, ...
        info.accounting   # {"coeffs_y": bits, "coeffs_uv": bits,
                          #  "overhead": bits, "total": bits}
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class FrameInspection:
    """Per-frame mi-grid snapshot (insp_frame_data analog)."""
    frame_type: int
    show_frame: int
    base_qindex: int
    width: int
    height: int
    mi_rows: int
    mi_cols: int
    mode_grid: np.ndarray          # luma mode (intra) / inter mode per mi
    ref_grid: np.ndarray           # ref_frame[0] per mi (0 = intra)
    mv_grid: np.ndarray            # (mi_rows, mi_cols, 2, 2) 1/8-pel
    bsize_grid: np.ndarray
    tx_wide_grid: np.ndarray       # tx width in px per mi
    tx_high_grid: np.ndarray
    skip_grid: np.ndarray
    skip_mode_grid: np.ndarray     # per-mi skip_mode (derived compound)
    qindex_grid: np.ndarray
    seg_grid: np.ndarray
    cdef_strengths: tuple
    filter_level: tuple
    accounting: dict = field(default_factory=dict)


def _snapshot(dec, fh, out) -> FrameInspection:
    g = dec.g
    m = g.m
    r, c_ = dec.mi_rows, dec.mi_cols
    acct = {}
    if dec.acct is not None:
        # accounting units are 1/8 bit (od_ec_tell_frac)
        for k, v in dec.acct.items():
            acct[k] = v / 8.0
        acct["total"] = getattr(dec, "_acct_total_bits", 0.0)
        acct["overhead"] = max(
            0.0, acct["total"] - acct.get("coeffs_y", 0.0)
            - acct.get("coeffs_uv", 0.0))
    return FrameInspection(
        frame_type=fh.frame_type, show_frame=fh.show_frame,
        base_qindex=fh.base_q_idx,
        width=dec.upscaled_width, height=fh.frame_height,
        mi_rows=r, mi_cols=c_,
        mode_grid=g.mode[m:m + r, m:m + c_].copy(),
        ref_grid=g.ref0[m:m + r, m:m + c_].copy(),
        mv_grid=g.mv[m:m + r, m:m + c_].copy(),
        bsize_grid=g.bsize[m:m + r, m:m + c_].copy(),
        tx_wide_grid=dec.tx_wide_grid[:r, :c_].copy(),
        tx_high_grid=dec.tx_high_grid[:r, :c_].copy(),
        skip_grid=dec.skip_inter_grid[:r, :c_].copy(),
        skip_mode_grid=dec.skip_mode_grid[m:m + r, m:m + c_].copy(),
        qindex_grid=dec.qindex_grid[:r, :c_].copy(),
        seg_grid=dec.seg_map[:r, :c_].copy(),
        cdef_strengths=(tuple(fh.cdef_y_pri or ()),
                        tuple(fh.cdef_uv_pri or ())),
        filter_level=tuple(fh.filter_level),
        accounting=acct)


def inspect_ivf(path: str, max_frames: int | None = None):
    """Decode an IVF file yielding FrameInspection per decoded frame
    (shown or not)."""
    from ..bitstream.ivf import read_ivf
    from . import decoder as D

    results = []

    def hook(dec, fh, out):
        results.append(_snapshot(dec, fh, out))

    state = {"slots": [None] * 8, "inspect_hook": hook}
    sh = None
    for payload, _pts in read_ivf(path):
        # record total frame bits for accounting (tile payload sizes)
        n_before = len(results)
        _frames, sh = D.decode_frame_obus(payload, sh, state)
        for info in results[n_before:]:
            if info.accounting:
                info.accounting["total"] = len(payload) * 8.0
                info.accounting["overhead"] = max(
                    0.0, info.accounting["total"]
                    - info.accounting.get("coeffs_y", 0.0)
                    - info.accounting.get("coeffs_uv", 0.0))
        if max_frames is not None and len(results) >= max_frames:
            break
    return results
