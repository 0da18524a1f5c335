"""Quality all-intra encoder with the RD search on device.

The mode/size trial sweep — the reference encoder's hot loop
(av1_rd_pick_partition, av1/encoder/partition_search.c:5310 +
av1_rd_pick_intra_mode_sb, rdopt.c:3296) — runs as batched torch tensor
ops (ops/rdo_intra.py): every candidate block of every size tries all
61 luma intra modes at once.  A bottom-up partition DP over the cost
grids (SURVEY §7(c)) picks the tree; the host then encodes each chosen
leaf exactly once against real recon (exact prediction / transform /
trellis), so the emitted stream is fully conformant — only the
*decisions* come from the device sweep.

Differences vs the host search (LossyAllIntraEncoder._search):
  * trial predictions use source neighbours, not recon neighbours
    (the approximation that makes the sweep parallel);
  * chroma enters the partition DP as a DC-mode cost (the final leaf
    still does the full DC-vs-CfL decision);
  * AB/4:1 shapes, palette, intraBC and filter-intra trials are not in
    the DP (PARTITION NONE/HORZ/VERT/SPLIT only).
"""

from __future__ import annotations

import numpy as np

from .. import resolve_device
from ..bitstream import constants as c
from ..common import blockd
from .lossy import LossyAllIntraEncoder, make_lossy_frame_header
from .encoder import make_sequence_header

_PX2BSIZE = {(blockd.block_wide(b), blockd.block_high(b)): b
             for b in range(c.BLOCK_64X64 + 1)}


class TpuRdoAllIntraEncoder(LossyAllIntraEncoder):
    """LossyAllIntraEncoder with the trial math on `device`: the card
    when None, and an error when there is none."""

    def __init__(self, sh, fh, use_native=None, block_size=c.BLOCK_16X16,
                 device=None, **kw):
        kw.setdefault("rect_parts", True)
        assert not kw.get("ext_parts"), "AB/4:1 not in the device DP"
        super().__init__(sh, fh, use_native=use_native,
                         block_size=block_size, **kw)
        assert not self.screen and not self.intrabc, \
            "screen-content tools use the host search"
        assert self.sb_size == c.BLOCK_64X64, "device DP assumes SB64"
        assert self.bd == 8, "device trials are 8-bit (HBD: host search)"
        self.device = resolve_device(device)
        self._costs = None
        self._uv_costs = None
        self._modes = None

    # -- device sweep ------------------------------------------------------

    def _min_px(self):
        return blockd.block_wide(self.min_bsize)

    def _sizes(self):
        """Square + rect trial geometries for the DP.  Small squares and
        all rects stay in the list regardless of min_bsize: the
        frame-edge rules can force 16x8/8x16 legs and 8x8/4x4 leaves
        anywhere (mirrors _search's not-fits branch)."""
        sq = [(4, 4), (8, 8), (16, 16), (32, 32), (64, 64)]
        rects = [(16, 8), (8, 16), (32, 16), (16, 32), (64, 32), (32, 64)]
        return sq + rects

    def _run_device_rdo(self):
        from ..ops.rdo_intra import IntraTrialEngine, trial_modes_full
        eng = IntraTrialEngine(self.fh.base_q_idx, bd=self.bd,
                               device=self.device)
        h, w = self.mi_rows * 4, self.mi_cols * 4

        def lam_of(py, px, bh, bw):
            return self._lam(py // 4, px // 4)

        sizes = self._sizes()

        def pad64(p, mult):
            ph = -p.shape[0] % mult
            pw = -p.shape[1] % mult
            return np.pad(p, ((0, ph), (0, pw)), mode="edge") \
                if (ph or pw) else np.ascontiguousarray(p)

        self._costs = eng.trial_plane(pad64(self.src[0][:h, :w], 64),
                                      sizes, lam_of)
        self._modes = trial_modes_full()
        # mode-signalling penalties per trial index (host cost model:
        # +4.0 luma mode bits; +1.0 + 0.9*|d| for a nonzero angle delta)
        pen = np.zeros(len(self._modes), np.float32)
        for i, (m, d) in enumerate(self._modes):
            pen[i] = 4.0 + ((1.0 + 0.9 * abs(d)) if d else 0.0)
        self._mode_pen = pen
        # chroma DC cost grids (1:1 with luma block geometry)
        self._uv_costs = {}
        if self.num_planes > 1:
            ch, cw = h >> self.ss_y, w >> self.ss_x

            def lam_uv(py, px, bh, bw):
                return self._lam((py << self.ss_y) // 4,
                                 (px << self.ss_x) // 4)

            for p in (1, 2):
                csizes = sorted({(bw >> self.ss_x, bh >> self.ss_y)
                                 for (bw, bh) in sizes
                                 if (bw >> self.ss_x) >= 4
                                 and (bh >> self.ss_y) >= 4})
                grids = eng.trial_plane(
                    pad64(self.src[p][:ch, :cw], 64 >> min(self.ss_x,
                                                           self.ss_y)),
                    csizes, lam_uv, dc_only=True)
                self._uv_costs[p] = grids

    def _leaf_cost(self, mi_row, mi_col, bw, bh):
        """(cost, mode, delta) for a NONE leaf at (mi_row, mi_col):
        device luma trials reduced over modes + chroma DC cost."""
        grid = self._costs[(bw, bh)]
        i, j = (mi_row * 4) // bh, (mi_col * 4) // bw
        lam = self._lam(mi_row, mi_col)
        tot = grid[i, j] + lam * self._mode_pen
        k = int(np.argmin(tot))
        cost = float(tot[k])
        mode, delta = self._modes[k]
        for p in (1, 2):
            if p not in self._uv_costs:
                continue
            cbw, cbh = bw >> self.ss_x, bh >> self.ss_y
            g = self._uv_costs[p].get((cbw, cbh))
            if g is None:     # sub-4 chroma (shared-ref 4x4 groups)
                continue
            ci = (mi_row * 4 >> self.ss_y) // cbh
            cj = (mi_col * 4 >> self.ss_x) // cbw
            cost += float(g[ci, cj, 0]) + lam * 1.0
        return cost, mode, delta

    # -- partition DP (mirrors LossyAllIntraEncoder._search rules) ---------

    def _dp(self, mi_row, mi_col, bsize):
        """Returns (cost, node); node leaves carry (mode, delta)."""
        if mi_row >= self.mi_rows or mi_col >= self.mi_cols:
            return 0.0, None
        bw4 = blockd.mi_size_wide(bsize)
        hbs = bw4 // 2
        has_rows = mi_row + hbs < self.mi_rows
        has_cols = mi_col + hbs < self.mi_cols
        fits = self._fits(mi_row, mi_col, bsize)
        bw = blockd.block_wide(bsize)
        bh = blockd.block_high(bsize)
        lam = self._lam(mi_row, mi_col)

        def leaf(r, cc, bs):
            cost, mode, delta = self._leaf_cost(
                r, cc, blockd.block_wide(bs), blockd.block_high(bs))
            return cost, ("LEAF", r, cc, bs, mode, delta)

        def split():
            sub = blockd.partition_subsize(bsize, c.PARTITION_SPLIT)
            kids = []
            cost = lam * 8
            for (r, cc) in ((mi_row, mi_col), (mi_row, mi_col + hbs),
                            (mi_row + hbs, mi_col),
                            (mi_row + hbs, mi_col + hbs)):
                k_cost, k_node = self._dp(r, cc, sub)
                cost += k_cost
                kids.append(k_node)
            return cost, ("SPLIT", mi_row, mi_col, bsize, kids)

        if not fits:
            fits_rows = mi_row + bw4 <= self.mi_rows
            fits_cols = mi_col + bw4 <= self.mi_cols
            sub_h = blockd.partition_subsize(bsize, c.PARTITION_HORZ)
            sub_v = blockd.partition_subsize(bsize, c.PARTITION_VERT)
            if (bsize > c.BLOCK_8X8 and not has_rows and fits_cols
                    and self._subsize_valid(sub_h)):
                k_cost, k_node = leaf(mi_row, mi_col, sub_h)
                return k_cost, ("HORZ", mi_row, mi_col, bsize, [k_node])
            if (bsize > c.BLOCK_8X8 and not has_cols and fits_rows
                    and self._subsize_valid(sub_v)):
                k_cost, k_node = leaf(mi_row, mi_col, sub_v)
                return k_cost, ("VERT", mi_row, mi_col, bsize, [k_node])
            return split()

        if bsize <= self.min_bsize or bsize == c.BLOCK_8X8:
            cost, node = leaf(mi_row, mi_col, bsize)
            return cost + lam * 2, ("NONE", mi_row, mi_col, bsize, [node])

        cost_none, node_none = leaf(mi_row, mi_col, bsize)
        best = (cost_none + lam * 2,
                ("NONE", mi_row, mi_col, bsize, [node_none]))

        if self.rect_parts:
            for part, kind in ((c.PARTITION_HORZ, "HORZ"),
                               (c.PARTITION_VERT, "VERT")):
                sub = blockd.partition_subsize(bsize, part)
                if blockd.mi_size_wide(sub) < 2 and self.ss_x:
                    continue
                if not self._subsize_valid(sub):
                    continue
                offs = ((mi_row, mi_col),
                        (mi_row + hbs, mi_col) if part == c.PARTITION_HORZ
                        else (mi_row, mi_col + hbs))
                cost = lam * 4
                legs = []
                for (r, cc) in offs:
                    k_cost, k_node = leaf(r, cc, sub)
                    cost += k_cost
                    legs.append(k_node)
                if cost < best[0]:
                    best = (cost, (kind, mi_row, mi_col, bsize, legs))

        cost_split, node_split = split()
        if best[0] <= cost_split:
            return best
        return cost_split, node_split

    # -- realize: encode chosen leaves against real recon -------------------

    def _search(self, mi_row, mi_col, bsize):
        if self._costs is None:
            self._run_device_rdo()
        cost, node = self._dp(mi_row, mi_col, bsize)
        return cost, self._realize(node)

    def _realize(self, node):
        if node is None:
            return None
        kind = node[0]
        if kind == "LEAF":
            _, r, cc, bs, mode, delta = node
            _, bplan = self._leaf_encode(r, cc, bs, mode, delta)
            return bplan
        _, mi_row, mi_col, bsize, kids = node
        out = [self._realize(k) for k in kids]
        return (kind, mi_row, mi_col, bsize, out)

    def _leaf_encode(self, mi_row, mi_col, bsize, mode, delta):
        """Final exact encode of one leaf at the device-chosen mode
        (condensed _trial_block: single luma mode + chroma DC/CfL)."""
        from ..common import intra
        up_avail = mi_row > 0
        left_avail = mi_col > 0
        if not intra.is_directional(mode) or bsize < c.BLOCK_8X8:
            delta = 0
        dist, bits, y_txbs = self._code_plane(
            0, mode, mi_row, mi_col, bsize, up_avail, left_avail,
            write_recon=False, angle_delta=delta, tx_search=self.tx_search)
        lam = self._lam(mi_row, mi_col)
        y_cost = dist + lam * (bits + 4.0)
        # uniform tx-depth refinement under TX_MODE_SELECT (host parity;
        # pruned at speed >= 1 like the reference tx-size speed features)
        if self.tx_select and self.speed == 0 and bsize > c.BLOCK_4X4:
            from ..decoder.inter import _MAX_DEPTH, depth_to_tx_size
            for depth in range(1, min(_MAX_DEPTH[bsize], 2) + 1):
                d2, b2, t2 = self._code_plane(
                    0, mode, mi_row, mi_col, bsize, up_avail, left_avail,
                    write_recon=False, angle_delta=delta,
                    tx_search=self.tx_search,
                    tx_size_override=depth_to_tx_size(depth, bsize))
                cost2 = d2 + lam * (b2 + 4.0 + 2.0 * depth)
                if cost2 < y_cost:
                    y_cost, y_txbs = cost2, t2
        self._apply_txbs(0, y_txbs)

        is_chroma_ref = blockd.is_chroma_reference(
            mi_row, mi_col, bsize, self.ss_x, self.ss_y) \
            and self.num_planes > 1
        uv_mode = c.DC_PRED
        cfl = None
        uv_cost = 0.0
        uv_txbs = []
        if is_chroma_ref:
            uv_cost, uv_mode, cfl, uv_txbs = self._pick_uv(
                mi_row, mi_col, bsize, up_avail, left_avail, y_txbs)
            for plane in (1, 2):
                self._apply_txbs(plane,
                                 [t for t in uv_txbs
                                  if t["plane"] == plane])
        return y_cost + uv_cost, dict(
            mi_row=mi_row, mi_col=mi_col, bsize=bsize, y_mode=mode,
            y_angle=delta, uv_mode=uv_mode, cfl=cfl, pal_y=None, fim=-1,
            txbs=y_txbs + uv_txbs, is_chroma_ref=is_chroma_ref)

    def encode_frame(self, planes, use_jax: bool = False) -> bytes:
        self._costs = None
        self._uv_costs = None
        return super().encode_frame(planes, use_jax=False)


def encode_tpu_rdo_ivf(path: str, frames, width: int, height: int,
                       qindex: int = 60, fps=(30, 1),
                       block_size: int = c.BLOCK_16X16,
                       enable_cdef: int = 0, enable_restoration: int = 0,
                       tx_select: bool = True, device=None, **kw) -> None:
    """Device-RDO all-intra encode to IVF (quality path), the trials on
    `device` (the card when None)."""
    from ..bitstream.ivf import write_ivf
    sh = make_sequence_header(width, height, enable_cdef=enable_cdef,
                              enable_restoration=enable_restoration)
    payloads = []
    for i, f in enumerate(frames):
        fh = make_lossy_frame_header(sh, qindex, tx_select=tx_select)
        enc = TpuRdoAllIntraEncoder(sh, fh, block_size=block_size,
                                    device=device, **kw)
        payloads.append((enc.encode_frame(f), i))
    write_ivf(path, payloads, width, height, fps[0], fps[1])
