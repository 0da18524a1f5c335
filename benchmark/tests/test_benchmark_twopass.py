"""The two-pass cell (driver gop_twopass) and the 8-frame clips cell on the
CPU at 96x64, the port's plain PyTorch versions standing in for the
kernels: the cells run `correct` where the encode recodes and where a
scene cut places a KEY; a fault that keeps a discarded attempt's
reconstruction in the reference slots, a fault in the first pass's
statistics, the first pass's sums taken in float16 or bfloat16, and a
placement that ignores the statistics all read `correct` false; the work
the driver counts is the frozen yardstick's on the fixed cadence."""

import os

import numpy as np
import pytest
import torch

from small import edit_json, small_bench

from benchmark import harness
from benchmark import plain_twopass as plain
from benchmark.clips import Clip, Video
from benchmark.work import (FULLPEL_RADIUS, _surface, gop_schedule,
                            gop_work)

TWOPASS, CLIPS = "ra_2pass.vod_1080p_gop120", "ra_good.clips_1080p_8f"
SEED = 3100000007
#: at 96x64, 12 frames of the seed's clip with a scene cut at frame 7 (a
#: KEY, a GF group of 6, the KEY at the cut, a GF group of 4): a target at
#: which one of its two ARFs is coded again
RECODING_BPS = 60_000
CUTS = [7]


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("twopass"))
    b = small_bench(tmp)
    edit_json(os.path.join(b, "traffic", "vod2pass_gop120.json"),
              {"frames_per_encode": 12, "warm_frames": 12,
               "check_coded_frames": 12, "sample_among": 1,
               "scene_cuts": CUTS})
    edit_json(os.path.join(b, "traffic", "clips_8f.json"),
              {"sample_among": 1})
    edit_json(os.path.join(b, "configs", "ra_2pass.json"),
              {"rate_control": {"mode": "vbr", "target_bps": RECODING_BPS,
                                "fps": 30}})
    return b


def _run(bench, cell, trace=False):
    return harness.run_cell(cell, SEED, 0.5, trace, 0.0, device="cpu",
                            bench=bench)


def _driver(bench):
    return harness.load_plugin("drivers", "gop_twopass", bench)


def test_twopass_cell_is_correct_where_it_recodes(bench):
    result, lines, _ = _run(bench, TWOPASS)
    assert result["correct"] and result["failed"] == 0
    assert result["compared"]["mismatch_samples"]["value"] == 0
    assert {"encode_fps", "kbytes_per_frame", "psnr_y_db",
            "setup_s"} <= set(result["metrics"])
    text = "\n".join(lines)
    # two KEYs, two ARFs, one of them coded again
    assert "{'key': 2, 'arf': 3}" in text
    assert "; equal" in text and "the plain schedule's" in text
    assert "schedule: 2 KEYs, GF lengths [6, 4]" in text
    assert "rate plan of the checked encode: key (2) planned" in text
    assert "programs captured in the window: 0" in text


def test_twopass_cell_traced_reports_its_metrics(bench):
    result, _, _ = _run(bench, TWOPASS, trace=True)
    assert result["correct"]
    m = result["metrics"]
    assert m["twopass.recode_attempts_per_anchor"]["value"] == \
        pytest.approx(1 / 4)            # two KEYs and two ARFs, 1 recode
    assert m["twopass.recode_ms_per_frame"]["value"] > 0
    assert m["twopass.first_pass_ms_per_frame"]["value"] > 0
    assert {"gop.lookahead_ms_per_group", "gop.key_ms_per_key",
            "gop.p_frames_ms_per_frame", "gop.emit_ms_per_frame",
            "gop.fetch_mb_per_frame"} <= set(m)


def test_a_discarded_attempt_left_in_the_slots_is_caught(bench, monkeypatch):
    """A recode loop that leaves the first attempt's reconstruction in the
    reference slots, while the stream holds the last attempt: the frames
    that predict from it drift."""
    from aom_av1_lavish_torch.encoder.gop import GopEncoder
    recode = GopEncoder._recode

    def keeps_the_first(self, kind, display_idx, q, encode_fn):
        first = []

        def fn(qq):
            out = encode_fn(qq)
            first.append(self._slot_state())
            return out
        out = recode(self, kind, display_idx, q, fn)
        if len(first) > 1:
            self._restore_slot_state(first[0])
        return out

    monkeypatch.setattr(GopEncoder, "_recode", keeps_the_first)
    result, _, _ = _run(bench, TWOPASS)
    assert result["compared"]["mismatch_samples"]["value"] > 0
    assert not result["correct"]


def _departed(result):
    """A run whose checked stream departs from the guarantee: one stream
    differing, the checked encode failed, `correct` false."""
    assert result["compared"]["streams_differing"]["value"] == 1
    assert result["failed"] == 1
    assert not result["correct"]


def test_a_fault_in_the_first_pass_counts_the_encode_failed(bench,
                                                            monkeypatch):
    from aom_av1_lavish_torch.encoder import firstpass
    first_pass = firstpass.first_pass

    def altered(frames, *a, **k):
        stats = first_pass(frames, *a, **k)
        stats[3].coded_error *= 1.0001
        return stats

    monkeypatch.setattr(firstpass, "first_pass", altered)
    result, lines, _ = _run(bench, TWOPASS)
    _departed(result)
    assert "departs at frame 3 in coded_error" in "\n".join(lines)


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_first_pass_sums_in_a_lower_precision_read_not_correct(
        bench, monkeypatch, dtype):
    """The control of the stats limit, through the harness: the port's
    two frame sums taken in float16 (scaled into its range) or bfloat16,
    everything else as it is."""
    from aom_av1_lavish_torch.encoder import firstpass
    fp_frame, low = firstpass._fp_frame, getattr(torch, dtype)
    scale = 2.0 ** -16 if low == torch.float16 else 1.0

    def sums(v):
        return (v * scale).to(low).sum(dtype=low).to(torch.float32) / scale

    def lower(src_y, prev_pad):
        b = firstpass.fp_blocks(src_y, prev_pad)
        coded = torch.where(b["is_inter"], b["inter"], b["intra"])
        out = fp_frame(src_y, prev_pad).clone()
        out[0], out[1] = sums(b["intra"]), sums(coded)
        return out

    monkeypatch.setattr(firstpass, "_fp_frame", lower)
    result, lines, _ = _run(bench, TWOPASS)
    _departed(result)
    assert result["compared"]["mismatch_samples"]["value"] == 0
    assert "departs at frame 0 in intra_error" in "\n".join(lines)


def test_a_placement_that_ignores_the_stats_reads_not_correct(
        bench, monkeypatch):
    """The encoder places the fixed cadence (no KEY at the cut): its
    stream decodes to its own reconstruction, but is not the layout the
    plain schedule gives."""
    from aom_av1_lavish_torch.encoder.gop import GopEncoder
    build = GopEncoder._build_schedule

    def fixed(self, n):
        stats, self.twopass_stats = self.twopass_stats, None
        try:
            return build(self, n)
        finally:
            self.twopass_stats = stats

    monkeypatch.setattr(GopEncoder, "_build_schedule", fixed)
    result, lines, _ = _run(bench, TWOPASS)
    _departed(result)
    assert result["compared"]["mismatch_samples"]["value"] == 0
    assert "the stream departs at temporal unit" in "\n".join(lines)


def test_scene_frames_splice_the_seeds_clips():
    """Scene s is the clip of seed + s at the same frame indices."""
    drv = harness.load_plugin("drivers", "gop_twopass")
    video, seed = Video(), SEED
    got = drv.scene_frames(seed, 9, 32, 32, video, [3, 7], "cpu")
    clips = [Clip(seed + s, 9, 32, 32, video).frames() for s in range(3)]
    want = clips[0][:3] + clips[1][3:7] + clips[2][7:]
    assert len(got) == 9
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    assert not np.array_equal(got[3][0], clips[0][3][0])
    for bad in ([0], [9], [5, 5], [6, 4]):
        with pytest.raises(ValueError):
            drv.scene_frames(seed, 9, 32, 32, video, bad, "cpu")


def test_plan_by_kind_sums_each_kind():
    drv = harness.load_plugin("drivers", "gop_twopass")
    sched = [("key", 0), ("gf", 1, 4), ("key", 5), ("gf", 6, 2)]
    plan = {i: [1000.0, 500.0 + i, 2000.0] for i in range(8)}
    plan[7][1] = None                         # a frame never targeted
    text = drv.plan_by_kind(plan, sched)
    assert text == ("key (2) planned 2.0, targeted 1.0, spent 4.0 kbit "
                    "(correction 0.500..0.505); arf (1) planned 1.0, "
                    "targeted 0.5, spent 2.0 kbit (correction "
                    "0.504..0.504); inter (4) planned 4.0, targeted 2.0, "
                    "spent 8.0 kbit (correction 0.501..0.506)")


def test_clips_cell_is_correct_on_every_coded_frame(bench):
    result, lines, _ = _run(bench, CLIPS)
    assert result["correct"] and result["failed"] == 0
    assert "check: 8 coded frames decoded of 8" in "\n".join(lines)
    assert "encode_fps" in result["metrics"]


def test_the_work_on_the_fixed_cadence_is_the_yardsticks(bench):
    """On the fixed cadence, with each anchor coded once, the driver's work
    is gop_work's and a first-pass surface a frame."""
    drv = _driver(bench)
    W, H, n = 1920, 1088, 120
    layout = plain.layout(gop_schedule(n, 120, 8))
    work, counts = drv.layout_work(layout, W, H, {"key": 1, "arf": 15})
    want, want_counts = gop_work(W, H, n, 120, 8)
    fp = [("ssd_surface",) + _surface(W, H, 16, FULLPEL_RADIUS, "int8")] * n
    assert sorted(work) == sorted(fp + want)
    assert {k: counts[k] for k in want_counts} == want_counts


def test_lone_p_frames_are_one_group():
    layout = plain.layout([("key", 0), ("gf", 1, 8), ("gf", 9, 2),
                           ("key", 11), ("gf", 12, 1)])
    assert layout[-4:] == ["inter", "inter", "key", "inter"]
    drv = harness.load_plugin("drivers", "gop_twopass")
    _, counts = drv.layout_work(layout, 96, 64, {"key": 2, "arf": 1})
    assert counts == {"frames": 13, "keys": 2, "groups": 3, "arfs": 1,
                      "inter": 11, "key_attempts": 2, "arf_attempts": 1}


def test_stats_departure_names_the_first_field():
    drv = harness.load_plugin("drivers", "gop_twopass")
    a = [plain.FrameStats(i, 1e6, 5e5, 0.5, 0.25, 2.0) for i in range(3)]
    b = [plain.FrameStats(i, 1e6, 5e5, 0.5, 0.25, 2.0) for i in range(3)]
    assert drv.stats_departure(a, b, 24) == (None, 0.0)
    assert drv.sums_rtol(24) == 10 * 2.0 ** -24
    b[1].coded_error *= 1 + 5e-7          # inside 10 * 2^-24
    assert drv.stats_departure(a, b, 24)[0] is None
    b[2].mv_mag = 2.5
    assert drv.stats_departure(a, b, 24)[0] == (2, "mv_mag", 2.0, 2.5)
    b[1].intra_error *= 1 + 1e-5
    assert drv.stats_departure(a, b, 24)[0][:2] == (1, "intra_error")
