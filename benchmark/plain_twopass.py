"""A plain reference of the two-pass encoder's first pass and of the
schedule its statistics give: plain PyTorch, float32 and int64, no kernel,
no batching over frames, nothing imported from the encoder.

The first pass (libaom av1/encoder/firstpass.c, av1_first_pass and
first_pass_stats; FIRSTPASS_STATS) gives each frame the error of intra and
of inter prediction, and how many of its blocks inter prediction wins and
moves.  Here, for each 16x16 block in raster order:

- intra: the DC-predicted error, sum((s - m)^2) with m the block's mean
  rounded as (sum + 128) >> 8;
- inter: an exhaustive full-pel search of +-16 pixels against the previous
  frame's luma edge-padded by 16, each candidate's SSD computed through the
  expansion sum(s^2) + sum(w^2) - 2 sum(s w) in float32 (each sum exact,
  the one rounding at sum(s^2) + sum(w^2)); the best is the first minimum
  in raster order of (dy, dx);
- the gating: the motion is kept when best + 256 < SSD at zero motion (a
  bias for zero motion), else the inter error is the zero-motion SSD; the
  block is inter when inter * 1.12 < intra (float32); it moves when it is
  inter and its motion was kept.

A frame's statistics: intra_error, the sum of intra; coded_error, the sum
of min-by-gating (inter where the block is inter, else intra); pcnt_inter
and pcnt_motion, the counts of inter and of moving blocks times the float32
reciprocal of the number of blocks; mv_mag, the summed |dy| + |dx| of the
moving blocks over their count (or over 1).  Frame 0 has no previous frame:
its coded_error is its intra_error and the rest are 0.

Departures from firstpass.c, as the encoder makes them:
- one pass over the whole frame's blocks of 16x16, no 8x8 or smaller
  blocks, no raster-order motion-vector predictor and no diamond search:
  the exhaustive +-16 window replaces the search and its start;
- the intra error is the DC predictor's only, over luma, with no intra
  mode decision and no chroma;
- the SSD is the float32 expansion above, as the system's TPU package
  computes it, where firstpass.c sums integer squared differences: the two
  differ by at most 1 where sum(s^2) + sum(w^2) >= 2^24;
- the inter/intra test is the factor 1.12 and the zero-motion bias 256,
  where firstpass.c compares against the zero-motion and golden errors
  with its own biases; no golden frame, no second reference;
- only the fields the second pass reads: no noise, no intra skip, no
  inactive zone, no new-mv count, no weights.

The schedule (libaom av1/encoder/pass2_strategy.c: find_next_key_frame and
test_candidate_kf for the key frames, define_gf_group for the groups) from
those statistics, with ratio r = max(coded, 1) / max(intra, 1) of a frame:

- key frames: frame 0; a frame kf_max frames after the last key frame;
  and, at least kf_min (4) frames after it, a frame where prediction
  breaks: r > 0.25 and r > 3 r(previous) and (pcnt_inter < 0.85 or
  r > 0.85);
- groups: from each frame after a key frame, the group is as long as the
  limit (gf_length, the frames left, the frames until the next key frame)
  allows while each next frame keeps r <= 0.65 and pcnt_inter >= 0.5 and
  the product of (1 - r) over the group's frames after its first stays at
  least 0.08; at least 3 frames, or the limit where that is smaller.

Departures from pass2_strategy.c, as the encoder makes them: the tests are
these ratios on the frame's own statistics, with no look-ahead of 16 frames
past a candidate key frame, no boost scores, no zero-motion accumulator and
no minimum or maximum GF interval from the rate; a group's length is not
cut to a multiple of anything.

The layout a schedule gives the stream, one entry a temporal unit in
display order: "key" (a shown key frame); for a group of 3 or more frames,
"arf+inter" (the hidden ARF, the group's last frame, coded with its first
shown P frame), "inter" for each next P frame, then "show_existing" (the
ARF shown); for a shorter group, "inter" for each frame.
"""

from __future__ import annotations

import dataclasses

import torch

RADIUS = 16
BLOCK = 16
ZERO_MV_BIAS = 256.0
INTER_FACTOR = 1.12


@dataclasses.dataclass
class FrameStats:
    """One frame's first-pass statistics (the fields the second pass
    reads)."""
    frame: int
    intra_error: float
    coded_error: float
    pcnt_inter: float
    pcnt_motion: float
    mv_mag: float


def _blocks(plane):
    """(H, W) -> (H/16 * W/16, 16, 16) in raster order."""
    H, W = plane.shape
    return plane.reshape(H // BLOCK, BLOCK, W // BLOCK, BLOCK) \
        .permute(0, 2, 1, 3).reshape(-1, BLOCK, BLOCK)


def intra_errors(cur):
    """Each 16x16 block's DC-predicted error (int64, raster order)."""
    blk = _blocks(cur.to(torch.int64))
    mean = (blk.sum((1, 2)) + 128) >> 8
    return ((blk - mean[:, None, None]) ** 2).sum((1, 2))


def block_values(cur, prev, rows_at_once: int = 1) -> dict:
    """Each 16x16 block's first-pass values of the luma plane `cur` against
    the luma plane `prev` (both (H, W) uint8 tensors of one shape whose
    sides are multiples of 16) -> dict of (B,) tensors in raster order:
    intra (int64), inter (float32), is_inter, moving (bool), mv_y, mv_x
    (int64).  The SSD surface is computed `rows_at_once` rows of blocks at
    a time, so that it fits."""
    H, W = cur.shape
    S = 2 * RADIUS + 1
    intra = intra_errors(cur)
    # edge padding: every index clamped into the frame
    rows = torch.arange(-RADIUS, H + RADIUS, device=cur.device).clamp(0, H - 1)
    cols = torch.arange(-RADIUS, W + RADIUS, device=cur.device).clamp(0, W - 1)
    pad = prev.to(torch.float32)[rows[:, None], cols[None, :]]
    src = cur.to(torch.float32)
    n_rows, size = H // BLOCK, BLOCK + 2 * RADIUS
    pos = torch.arange(S * S, device=cur.device)
    best, idx, zero = [], [], []
    for r0 in range(0, n_rows, rows_at_once):
        r1 = min(n_rows, r0 + rows_at_once)
        s = _blocks(src[r0 * BLOCK:r1 * BLOCK])                # (b, 16, 16)
        # each block's (48, 48) window of the padded previous frame
        win = pad[r0 * BLOCK:r1 * BLOCK + 2 * RADIUS].unfold(
            0, size, BLOCK).unfold(1, size, BLOCK).reshape(-1, size, size)
        # sum(s^2), sum(w^2) and sum(s w) of every candidate (dy, dx):
        # integers below 2^24, so exact in float32
        s2 = (s * s).sum((1, 2))[:, None, None]
        w2 = (win * win).unfold(1, BLOCK, 1).sum(-1) \
            .unfold(2, BLOCK, 1).sum(-1)                        # (b, S, S)
        cs = torch.stack([(win[:, dy:dy + BLOCK].unfold(2, BLOCK, 1)
                           * s[:, :, None, :]).sum((1, 3))
                          for dy in range(S)], 1)               # (b, S, S)
        ssd = ((s2 + w2) - 2.0 * cs).reshape(-1, S * S)
        low = ssd.min(1).values
        best.append(low)
        idx.append(torch.where(ssd == low[:, None], pos, S * S).min(1).values)
        zero.append(ssd[:, RADIUS * S + RADIUS])
    best, idx, zero = torch.cat(best), torch.cat(idx), torch.cat(zero)
    moved = best + ZERO_MV_BIAS < zero
    inter = torch.where(moved, best, zero)
    factor = torch.tensor(INTER_FACTOR, dtype=torch.float32,
                          device=cur.device)
    is_inter = inter * factor < intra.to(torch.float32)
    return dict(intra=intra, inter=inter, is_inter=is_inter,
                moving=moved & is_inter, mv_y=idx // S - RADIUS,
                mv_x=idx % S - RADIUS)


def frame_stats(i: int, values: dict) -> FrameStats:
    """Frame i's statistics from its blocks' values (frame 0's hold only
    `intra`)."""
    if "inter" not in values:
        ie = float(values["intra"].sum())
        return FrameStats(i, ie, ie, 0.0, 0.0, 0.0)
    n = values["intra"].numel()
    inv = torch.tensor(1.0, dtype=torch.float32) / torch.tensor(
        float(n), dtype=torch.float32)

    def share(mask):
        return float(torch.tensor(float(int(mask.sum())),
                                  dtype=torch.float32) * inv)
    is_inter, moving = values["is_inter"], values["moving"]
    coded = torch.where(is_inter, values["inter"].to(torch.float64),
                        values["intra"].to(torch.float64))
    mv = (values["mv_y"].abs() + values["mv_x"].abs())[moving]
    return FrameStats(i, float(values["intra"].sum()), float(coded.sum()),
                      share(is_inter), share(moving),
                      float(mv.sum()) / max(int(moving.sum()), 1))


def first_pass(frames, device="cpu", rows_at_once: int = 1) -> list:
    """[FrameStats] of (y, u, v) frames (numpy uint8 planes), frame by
    frame on `device`; each luma plane cropped to whole 16x16 blocks."""
    out, prev = [], None
    for i, f in enumerate(frames):
        y = torch.as_tensor(f[0], device=device)
        y = y[:(y.shape[0] // BLOCK) * BLOCK,
              :(y.shape[1] // BLOCK) * BLOCK].contiguous()
        out.append(frame_stats(i, {"intra": intra_errors(y)} if prev is None
                               else block_values(y, prev, rows_at_once)))
        prev = y
    return out


def _ratio(s) -> float:
    return max(s.coded_error, 1.0) / max(s.intra_error, 1.0)


def key_frames(stats, kf_max: int, kf_min: int = 4) -> list:
    """Display indices of the key frames."""
    keys, last = [0], 0
    for i in range(1, len(stats)):
        if i - last >= kf_max:
            keys.append(i)
            last = i
        elif i - last >= kf_min:
            r, r_prev = _ratio(stats[i]), _ratio(stats[i - 1])
            if r > 0.25 and r > 3.0 * r_prev and (
                    stats[i].pcnt_inter < 0.85 or r > 0.85):
                keys.append(i)
                last = i
    return keys


def group_length(stats, start: int, limit: int, gf_length: int) -> int:
    """The length of the group that starts at `start`."""
    n, kept = 1, 1.0
    while n < min(limit, gf_length):
        s = stats[start + n]
        r = _ratio(s)
        kept *= max(0.0, 1.0 - r)
        if r > 0.65 or s.pcnt_inter < 0.5 or kept < 0.08:
            break
        n += 1
    return max(n, min(3, limit))


def schedule(stats, n: int, kf_max: int, gf_length: int) -> list:
    """[("key", i) | ("gf", start, length)] over the n frames, in display
    order."""
    keys = sorted(k for k in key_frames(stats[:n], kf_max) if k < n)
    out, i = [], 0
    while i < n:
        if i in keys:
            out.append(("key", i))
            i += 1
            continue
        limit = min(gf_length, n - i,
                    min((k for k in keys if k > i), default=n) - i)
        length = limit
        if limit >= 2:
            length = min(group_length(stats, i, limit, gf_length), limit)
        out.append(("gf", i, length))
        i += length
    return out


def layout(sched) -> list:
    """The temporal units a schedule gives the stream, in order."""
    out = []
    for item in sched:
        if item[0] == "key":
            out.append("key")
        elif item[2] >= 3:
            out += ["arf+inter"] + ["inter"] * (item[2] - 2) \
                + ["show_existing"]
        else:
            out += ["inter"] * item[2]
    return out
