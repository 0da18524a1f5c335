"""Frame- and tile-parallel encoding on one card (the port of the JAX
package's parallel/sharding.py).

The reference shards its work over a ('frame', 'tile') mesh of devices:
  * tile-parallel: AV1 tile columns are fully independent (prediction
    availability and entropy state reset at tile edges), so the lossless
    analyze runs per tile with no halo.  Reference analog:
    av1_encode_tiles_mt (av1/encoder/ethread.c:1506).
  * frame-parallel (FPMT, av1_compress_parallel_frames, ethread.c:1224):
    the P frames of a GF group reference only the fixed (anchor, ARF)
    pair, so they are independent of each other.

One H100 has nothing to shard.  Each mesh axis is a batch axis on the one
card: `make_mesh` returns a layout whose `devices.shape` is (n_frame,
n_tile) as the reference's mesh has it and whose every slot is the same
torch device.  A mesh and `mesh=None` run the same program, so the streams
are the same bytes (the fpmt_unit_test_cfg contract, encoder.h:2607).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from ..ops.inter import (_crop, deblock_levels, fetch_group, p_frame,
                         p_frame_deblocked, pad_ref, split_recon, to_device,
                         upload_group)
from ..ops.lossless import lossless_plane_analyze


@dataclass(frozen=True)
class Mesh:
    """A ('frame', 'tile') batch layout on one device.  `devices` is an
    (n_frame, n_tile) object array whose every entry is `device`."""

    devices: np.ndarray
    axis_names: tuple
    device: torch.device


def make_mesh(n_frame: int, n_tile: int, device=None) -> Mesh:
    """The layout of n_frame x n_tile shards on `device` (the card when
    None, and an error when there is none)."""
    device = resolve_device(device)
    devices = np.empty((n_frame, n_tile), dtype=object)
    devices.fill(device)
    return Mesh(devices, ("frame", "tile"), device)


def _device_of(mesh, device=None) -> torch.device:
    """The one device a mesh (or, with mesh None, `device`) runs on."""
    if mesh is None:
        return resolve_device(device)
    if device is not None and torch.device(device) != mesh.device:
        raise ValueError(f"device {device} is not the mesh's "
                         f"{mesh.device}")
    return mesh.device


def _tiled_analyze(ys, us, vs):
    """(F, T, H, Wt) stacked tile columns -> per-plane int16 qcoeffs + a
    frame-level rate proxy (a float32 sum, the reference's psum)."""
    qs = [lossless_plane_analyze(p)[0] for p in (ys, us, vs)]
    bits_proxy = sum(q.abs().sum(dtype=torch.float32) for q in qs)
    return (*(q.to(torch.int16) for q in qs), bits_proxy)


def make_sharded_tile_analyze(mesh: Mesh):
    """The tiled analyze on the mesh's device: numpy or tensor planes in,
    one call over the whole (frame, tile) batch."""
    def fn(ys, us, vs):
        return _tiled_analyze(*(to_device(p, mesh.device)
                                for p in (ys, us, vs)))
    return fn


class ShardedLosslessEncoder:
    """Lossless all-intra encoder over a ('frame', 'tile') batch.

    Requires width to split into equal SB-aligned tile columns (the
    general unequal-tile path lives in encoder/encoder.py).  Produces
    the same bytes as the single-device encoder.
    """

    def __init__(self, width: int, height: int, mesh: Mesh):
        from ..encoder.encoder import (make_lossless_frame_header,
                                       make_sequence_header)
        self.mesh = mesh
        self.n_tile = mesh.devices.shape[1]
        self.n_frame = mesh.devices.shape[0]
        tile_cols_log2 = max(self.n_tile - 1, 0).bit_length()
        assert (1 << tile_cols_log2) == self.n_tile, \
            "tile count must be a power of two"
        self.sh = make_sequence_header(width, height)
        self.fh = make_lossless_frame_header(
            self.sh, tile_cols_log2=tile_cols_log2)
        self.mi_cols = self.fh.mi_cols()
        self.mi_rows = self.fh.mi_rows()
        sb_cols = self.fh.sb_cols(self.sh)
        assert sb_cols % self.n_tile == 0 and width % 64 == 0 \
            and height % 8 == 0 and width % (self.n_tile * 4) == 0, \
            "sharded path needs equal SB-aligned tile columns"
        self._fn = make_sharded_tile_analyze(mesh)

    def _split_tiles(self, plane):
        H, W = plane.shape
        T = self.n_tile
        return plane.reshape(H, T, W // T).transpose(1, 0, 2)

    def encode_frames(self, frames) -> list:
        """frames: list of (y, u, v); length must be a multiple of the
        mesh frame axis.  Returns one temporal-unit payload per frame."""
        F = len(frames)
        assert F % self.n_frame == 0, \
            f"frame count {F} not a multiple of mesh axis {self.n_frame}"
        ys, us, vs = (np.stack([self._split_tiles(f[i]) for f in frames])
                      for i in range(3))
        payloads = []
        for f0 in range(0, F, self.n_frame):
            sl = slice(f0, f0 + self.n_frame)
            qy, qu, qv, _bits = self._fn(ys[sl], us[sl], vs[sl])
            qy, qu, qv = (q.cpu().numpy() for q in (qy, qu, qv))
            for fi in range(self.n_frame):
                payloads.append(self._pack_frame(
                    frames[f0 + fi], qy[fi], qu[fi], qv[fi]))
        return payloads

    def _pack_frame(self, planes, qy_t, qu_t, qv_t) -> bytes:
        """Assemble one frame's TU from per-tile qcoeffs (T, h4, wt4, 16).

        Reuses the single-device encoder for headers; the per-tile
        entropy walk runs the same native coder."""
        from ..bitstream import headers as Hd
        from ..bitstream.tables import FrameContext
        from ..encoder.encoder import LosslessEncoder, pack_tile_group
        from ..runtime import encode_lossless_tile
        enc = LosslessEncoder(self.sh, self.fh)
        enc.pad_planes(planes)
        tiles = []
        for t in range(self.n_tile):
            # tile-local analysis arrays: walker reads offset (0, 0)
            analysis = [(qy_t[t], None), (qu_t[t], None), (qv_t[t], None)]
            c0, c1 = enc.tile_mi_range(t, rows=False)
            fc = FrameContext(self.fh.base_q_idx)
            tiles.append(encode_lossless_tile(
                fc, analysis, self.mi_rows, c1 - c0, enc.num_planes,
                sb_mi=enc.sb_mi))
        tile_data = pack_tile_group(tiles, self.fh.tile_size_bytes)
        out = bytearray()
        out += Hd.temporal_delimiter()
        out += enc.sequence_header_obu()
        out += enc.frame_obu(tile_data)
        return bytes(out)


# --- the simple batched analyze of the sharding demo and tests ---------


def batched_analyze_step(y_batch):
    """Analyze a batch of luma planes: (B, H, W) uint8 -> qcoeff, zero
    flags and a global bit-cost proxy (total nonzero coefficient
    magnitude, float32)."""
    q, zero = lossless_plane_analyze(y_batch)
    return q, zero, q.abs().sum(dtype=torch.float32)


def make_sharded_analyze(mesh: Mesh):
    """The batched analyze on the mesh's device (numpy or tensor in)."""
    def fn(y_batch):
        return batched_analyze_step(to_device(y_batch, mesh.device))
    return fn


# ---------------------------------------------------------------------------
# FPMT: frame-parallel P-frame encode over the 'frame' axis
# ---------------------------------------------------------------------------


def make_sharded_p_frame_fn(mesh, H: int, W: int, n_refs: int = 1):
    """Whole-frame P-frame analysis (motion search + MC + transforms +
    merge DP, no interp-filter search, no deblock) of a batch of frames
    against shared references, as one p_frame call over the batch's frame
    axis: fn(ys, us, vs, refs_y, refs_u, refs_v, refs_y2, pq_y, pq_u, pq_v,
    lam, hp) with (F, ...) sources, (n_refs, ...) padded references and
    one frame's quantizer ((5, 2) each, a 0-d lam and an int hp) shared
    by the batch -> p_frame's result dict, the frame axis first.  The
    frames are independent given their references (the FPMT condition,
    av1/encoder/ethread.c:1224)."""
    def fn(ys, us, vs, refs_y, refs_u, refs_v, refs_y2, pq_y, pq_u, pq_v,
           lam, hp):
        nf = ys.shape[0]
        assert ys.shape[1:] == (H, W) and len(refs_y) == n_refs
        refs = [list(r) for r in (refs_y, refs_u, refs_v, refs_y2)]
        pq = [p.expand(nf, *p.shape) for p in (pq_y, pq_u, pq_v)]
        return p_frame(ys, us, vs, *refs, *pq, lam.expand(nf), [hp] * nf,
                       interp=False, merge=True)
    return fn


def fpmt_encode_group(mesh, src_frames, qindexes, last_planes,
                      arf_planes, lf_levels=None, sharpness: int = 0,
                      device=None):
    """FPMT for the GopEncoder (av1_compress_parallel_frames,
    av1/encoder/ethread.c:1224): every P frame of the group references
    only the fixed (LAST, ARF) pair, so the group runs as one program over
    its frame axis, as the reference vmaps it: one p_frame call for all
    its frames, each over both references with the merge DP and the
    interp-filter search at its own quantizer, and one deblock call, each
    frame at its own levels.  mesh=None runs the same program on `device`
    (the card when None).

    src_frames: numpy planes or tensors already on the device.  Returns
    (raws, recons) like DeviceChainEncoder.encode_chain, with a recon for
    every frame (they are not chained)."""
    dev = _device_of(mesh, device)
    srcs, (last, arf), q = upload_group(
        src_frames, [last_planes, arf_planes], qindexes, dev)
    raw, rec = p_frame_deblocked(
        srcs, [pad_ref(*last), pad_ref(*arf)], q,
        deblock_levels(lf_levels, len(src_frames), dev), sharpness, True)
    return fetch_group([raw], [rec])


class ShardedInterGopEncoder:
    """Flat-GOP frame-parallel encoder: one intra anchor + a batch of
    P frames that all reference ONLY the anchor, so their device analyses
    are independent.  The host entropy emit stays serial per frame
    (byte-stream order), producing streams byte-identical to the serial
    flat-ref encode."""

    def __init__(self, width: int, height: int, mesh: Mesh,
                 qindex: int = 60, use_native=None):
        assert width % 16 == 0 and height % 16 == 0
        from ..encoder.encoder import make_sequence_header
        self.mesh = mesh
        self.device = mesh.device
        self.n_frame = int(np.prod(mesh.devices.shape))
        self.width, self.height = width, height
        self.qindex = qindex
        self.use_native = use_native
        self.sh = make_sequence_header(width, height, enable_cdef=0)

    def _encode_anchor(self, planes):
        from ..encoder.lossy import make_lossy_frame_header
        from ..encoder.tpu_intra import TorchAllIntraEncoder
        fh = make_lossy_frame_header(self.sh, self.qindex)
        enc = TorchAllIntraEncoder(self.sh, fh, use_native=self.use_native,
                                   device=self.device)
        payload = enc.encode_frame(planes)
        w, h = self.width, self.height
        rec = (enc.recon[0][:h, :w].copy(),
               enc.recon[1][:h // 2, :w // 2].copy(),
               enc.recon[2][:h // 2, :w // 2].copy())
        return payload, rec

    def encode_frames(self, frames):
        """frames[0] = anchor (intra), frames[1:] = P batch.  Returns
        one packed TU payload per frame."""
        from ..bitstream import headers as HH
        from ..encoder.tpu_inter import (TpuInterFrameEncoder,
                                         make_inter_frame_header)
        anchor_payload, anchor_rec = self._encode_anchor(frames[0])
        pfrs = frames[1:]
        if not pfrs:
            return [anchor_payload]
        H, W = self.height, self.width
        fn = make_sharded_p_frame_fn(self.mesh, H, W, 1)
        (ys, us, vs), (anchor,), q = upload_group(
            [_crop(f, H, W) for f in pfrs], [anchor_rec], [self.qindex],
            self.device)
        ry, ru, rv, ry2 = (p[None] for p in pad_ref(*anchor))
        out = fn(ys, us, vs, ry, ru, rv, ry2, *(p[0] for p in q["pq"]),
                 q["lam"][0], q["hp"][0])
        host = {k: out[k].cpu().numpy()
                for k in ("r16", "r32", "r64", "lvl", "rec")}
        payloads = [anchor_payload]
        slots = [anchor_rec] + [None] * 7
        for i in range(len(pfrs)):
            fh = make_inter_frame_header(self.sh, self.qindex,
                                         refresh_frame_flags=0)
            enc = TpuInterFrameEncoder(self.sh, fh, slots,
                                       use_native=self.use_native,
                                       device=self.device)
            enc._results = None
            enc._external_results = True
            enc._external_recon = split_recon(host["rec"][i], H, W)
            enc._res_raw = {k: host[k][i]
                            for k in ("r16", "r32", "r64", "lvl")}
            obu = enc.encode_frame_obu(pfrs[i])
            payloads.append(HH.temporal_delimiter() + obu)
        return payloads
