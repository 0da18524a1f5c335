"""The yardstick's frozen pieces: the reference decoder against the
port's, the clip generator against the port's, the work model's schedule
against the port's GOP encoder, and the trace arithmetic and the readers
on synthetic events."""

import numpy as np
import pytest

from benchmark import work
from benchmark.clips import Clip, Video
from benchmark.trace import Trace, breakdown, family, idle_gaps, union_us


def test_clip_is_the_seeds():
    a = Clip(2 ** 31 + 7, 5, 96, 64).frames()
    b = Clip(2 ** 31 + 7, 5, 96, 64)
    assert all(np.array_equal(p, q) for p, q in zip(a[3], b.frame(3)))
    assert all(np.array_equal(p, q) for f, g in zip(a, b.frames())
               for p, q in zip(f, g))
    assert [p.shape for p in a[0]] == [(64, 96), (32, 48), (32, 48)]
    assert all(p.dtype == np.uint8 and p.flags.c_contiguous for p in a[0])
    with pytest.raises(IndexError):
        b.frame(5)


def test_clip_seed_changes_only_the_textures_and_noise():
    a, b = Clip(1, 3, 192, 128), Clip(2 ** 33 + 7, 3, 192, 128)
    assert not np.array_equal(a.frame(0)[0], b.frame(0)[0])
    # the same detail: the mean step between neighbouring samples
    da, db = (np.abs(np.diff(c.frame(2)[0].astype(float), axis=1)).mean()
              for c in (a, b))
    assert abs(da - db) < 0.1 * max(da, db)
    assert a._centre(2) == b._centre(2) and a._sway(2) == b._sway(2)


def test_clip_is_no_integer_shift_of_the_frame_before():
    """Sensor noise is drawn anew for each frame and the camera moves by
    fractions of a pixel, so no integer shift of a frame predicts the
    next one exactly, as it would for a still image slid across."""
    clip = Clip(5, 3, 96, 64, Video(noise=0.0, ripple_px=0.0,
                                    object_radius=0.0))
    f0, f1 = (clip.frame(i)[0].astype(int) for i in (1, 2))
    best = min(np.abs(f1[8:-8, 8:-8] - f0[8 + dy:56 + dy, 8 + dx:88 + dx]
                      ).mean()
               for dy in range(-4, 5) for dx in range(-4, 5))
    assert best > 0.2
    still = Clip(5, 2, 96, 64, Video(noise=2.0, sway_px=(0.0, 0.0),
                                     ripple_px=0.0, object_radius=0.0))
    d = still.frame(1)[0].astype(int) - still.frame(0)[0].astype(int)
    assert 1.5 < d.std() < 4.5          # two frames' noise, sigma 2 each


def test_video_from_the_mix():
    v = Video.from_mix({"video": {"noise": 1.5, "sway_px": [3, 2],
                                  "octaves": [[8, 10.0]]}})
    assert v.noise == 1.5 and v.sway_px == (3, 2)
    assert v.octaves == ((8, 10.0),)
    assert Video.from_mix({}) == Video()


def test_reference_decoder_agrees_with_the_ports(tmp_path):
    from aom_av1_lavish_torch.decoder.decoder import decode_ivf
    from aom_av1_lavish_torch.encoder.gop import encode_gop_ivf

    from benchmark.reference.compare import decode_prefix
    frames = Clip(3, 6, 96, 64).frames()
    path = str(tmp_path / "s.ivf")
    encode_gop_ivf(path, frames, 96, 64, qindex=135, gf_length=8,
                   use_tpu=True, enable_cdef=False, cpu_used=8,
                   device="cpu")
    want = decode_ivf(path)
    coded, shown, err = decode_prefix(path, 99)
    assert err is None and len(shown) == len(want) == 6
    assert len(coded) == 6         # the KEY, the ARF, four P frames
    for a, b in zip(want, shown):
        for p, q in zip(a, b):
            assert np.array_equal(p, q)


@pytest.mark.parametrize("n,kf,gf", [(120, 120, 8), (8, 120, 8),
                                     (12, 120, 8), (30, 10, 4)])
def test_schedule_is_the_encoders(n, kf, gf):
    from aom_av1_lavish_torch.encoder.gop import GopEncoder
    enc = GopEncoder(96, 64, device="cpu", kf_interval=kf, gf_length=gf)
    assert work.gop_schedule(n, kf, gf) == enc._build_schedule(n)


def test_gop_work_counts():
    w, counts = work.gop_work(1920, 1088, 120, 120, 8)
    assert counts == {"frames": 120, "keys": 1, "groups": 15, "arfs": 15,
                      "inter": 119}
    assert work.bound_s(w) > 0
    fams = {f for f, *_ in w}
    assert fams == {"ssd_surface", "gather_windows", "convolve_8tap",
                    "quantize_b_vec"}


def test_peaks():
    assert work.MEM_BYTES_PER_S == 3.35e12
    assert work.OPS_PER_S["int8"] == 1979e12
    assert 33e12 < work.OPS_PER_S["int32"] < 34e12


def test_union_and_gaps():
    busy = [(0, 10, "a"), (5, 20, "b"), (30, 40, "c")]
    assert union_us(busy) == 30
    assert union_us(busy, (8, 35)) == 17
    gaps = idle_gaps([(s, e) for s, e, _ in busy],
                     [(0, 100, "bench/window"), (21, 29, "gop/emit")],
                     (0, 50))
    assert gaps == [["gop/emit", 10e-6], ["bench/window", 10e-6]]
    assert family("void code_residual_kernel<16>(...)") == "quantize_b_vec"
    assert family("void at::native::elementwise_kernel") is None


def _trace(**counts):
    device = [(0, 1000, "ssd_plane_kernel"), (2000, 2500, "other"),
              (3000, 3100, "code_residual_kernel")]
    sections = [(0, 4000, "gop/key"), (4000, 6000, "gop/tpl"),
                (6000, 7000, "gop/emit")]
    return Trace((0, 10000), device, sections,
                 {"emit": [(0.0, 0.004), (1.0, 1.006)]}, counts)


def test_readers_on_a_synthetic_trace():
    from benchmark import harness
    tr = _trace(frames=2, keys=1, groups=2, inter=1,
                work=work.p_frame_work(96, 64, 1))
    read = {n: harness.load_plugin("metrics", n).read for n in (
        "gop.key_ms_per_key", "gop.lookahead_ms_per_group",
        "gop.emit_ms_per_frame", "gop.p_frames_ms_per_frame",
        "gop.device_idle_share", "live.device_ms_per_frame",
        "live.emit_ms_per_frame", "gop.hand_kernels_roofline")}
    assert read["gop.key_ms_per_key"](tr) == pytest.approx(4.0)
    assert read["gop.lookahead_ms_per_group"](tr) == pytest.approx(1.0)
    assert read["gop.emit_ms_per_frame"](tr) == pytest.approx(0.5)
    assert read["gop.p_frames_ms_per_frame"](tr) is None
    assert read["gop.device_idle_share"](tr) == pytest.approx(84.0)
    assert read["live.device_ms_per_frame"](tr) == pytest.approx(0.8)
    assert read["live.emit_ms_per_frame"](tr) == pytest.approx(5.0)
    share = read["gop.hand_kernels_roofline"](tr)
    assert 0 < share < 100
    assert read["gop.hand_kernels_roofline"](_trace()) is None
    b = breakdown(tr)
    assert b["device_ops"][0] == ["ssd_plane_kernel", 1e-3]
