"""The port's tracing (utils/profiler sections and counters) on the
encode paths, on the CPU at 96x64: the realtime pipeline's sections
(encode/rt_step, rt_realize, rt_emit, rt_source) and their order, the
counter of bytes copied to the host (ops.inter.to_host and the realtime
rows) against the sizes the fetched tensors' shapes give, the two-pass
encode's first pass and recode loop (gop/first_pass, gop/recode, the
recode_attempts counters), and streams byte-identical with the sections
on and off."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from aom_av1_lavish_torch.encoder.gop import (GopEncoder, TorchGopEncoder,
                                              encode_gop_ivf,
                                              encode_twopass_ivf)
from aom_av1_lavish_torch.encoder.nonrd import encode_realtime_tpu_ivf
from aom_av1_lavish_torch.encoder.ratectrl import (MODE_VBR,
                                                   RateControlConfig)
from aom_av1_lavish_torch.ops import inter as IT
from aom_av1_lavish_torch.utils import profiler
from aom_av1_lavish_torch.utils.clips import make_frames

W, H = 96, 64
#: the GOP of tests/test_torch_gop.py's "both" configuration: the
#: wavefront KEY, then TPL, the ARF's temporal filter, the ARF and the
#: chain over one GF group of 7
KW = dict(qindex=120, gf_length=8, use_tpu=True, enable_cdef=False,
          cpu_used=8)
N_GOP, N_RT = 8, 6


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def sections():
    """The port's sections on, from an empty registry; off and empty
    after."""
    profiler.reset()
    profiler.enable(True)
    yield profiler
    profiler.enable(False)
    profiler.reset()


def _realtime(path, n=N_RT):
    encode_realtime_tpu_ivf(str(path), make_frames(n, W, H), W, H,
                            qindex=90, device="cpu")
    with open(path, "rb") as f:
        return f.read()


def _gop():
    enc = TorchGopEncoder(W, H, device="cpu", **KW)
    enc.enable_tpl = enc.enable_tf = True
    return enc.encode_sequence(make_frames(N_GOP, W, H))


@pytest.fixture(scope="module")
def rt_traced(tmp_path_factory):
    """A 6-frame realtime encode under a CPU torch.profiler with the
    sections on -> (stream bytes, {section: sorted [(start, end)]},
    counters)."""
    path = tmp_path_factory.mktemp("rt") / "on.ivf"
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    profiler.reset()
    profiler.enable(True)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            data = _realtime(path)
    finally:
        profiler.enable(False)
        torch.set_num_threads(n)
    spans = {}
    for ev in prof.events():
        if ev.name.startswith("encode/rt_"):
            spans.setdefault(ev.name, []).append(
                (ev.time_range.start, ev.time_range.end))
    counters = profiler.counters()
    profiler.reset()
    return data, {k: sorted(v) for k, v in spans.items()}, counters


def test_realtime_sections_one_per_p_frame(rt_traced):
    """Each of the 5 P frames opens one rt_step, one rt_realize and one
    rt_emit; every pull of a frame (6, and the one that finds the stream
    ended) opens an rt_source."""
    _, spans, _ = rt_traced
    for name in ("encode/rt_step", "encode/rt_realize", "encode/rt_emit"):
        assert len(spans[name]) == N_RT - 1, name
    assert len(spans["encode/rt_source"]) == N_RT + 1


def test_realtime_realize_inside_emit_and_after_its_step(rt_traced):
    """Each rt_realize lies inside an rt_emit, and the k-th rt_step ends
    before the k-th rt_realize starts: the sections pair by order."""
    _, spans, _ = rt_traced
    emits = spans["encode/rt_emit"]
    for s, e in spans["encode/rt_realize"]:
        assert any(es <= s and e <= ee for es, ee in emits)
    steps, realizes = spans["encode/rt_step"], spans["encode/rt_realize"]
    for (_, step_end), (real_start, _) in zip(steps, realizes):
        assert step_end <= real_start
    # frame k's emit ends before frame k + 1 is pulled (the pulls are the
    # KEY's, then one a P frame): no packet waits for the next frame
    for (_, emit_end), (pull_start, _) in zip(
            emits, spans["encode/rt_source"][2:]):
        assert emit_end <= pull_start


def test_realtime_emits_each_frame_before_pulling_the_next(rt_traced,
                                                           tmp_path,
                                                           monkeypatch):
    """With a generator for `frames`, at each pull of frame k + 1 the P
    frames' encode_frame has returned k times (frame 0 is the KEY), and
    the stream is the same as from a list."""
    from aom_av1_lavish_torch.encoder.tpu_inter import TpuInterFrameEncoder
    returned = [0]
    orig = TpuInterFrameEncoder.encode_frame

    def spy(self, *a, **k):
        out = orig(self, *a, **k)
        returned[0] += 1
        return out

    monkeypatch.setattr(TpuInterFrameEncoder, "encode_frame", spy)
    pulled = []

    def camera():
        for f in make_frames(N_RT, W, H):
            pulled.append(returned[0])
            yield f
        pulled.append(returned[0])

    path = tmp_path / "gen.ivf"
    encode_realtime_tpu_ivf(str(path), camera(), W, H, qindex=90,
                            device="cpu")
    assert pulled == [0] + list(range(N_RT))
    assert path.read_bytes() == rt_traced[0]


def test_realtime_rows_counted(rt_traced):
    """The realtime path copies the KEY's wave rows and reconstruction,
    then only each P frame's result rows, (B, 390) int16, counted under
    fetch_bytes/rt_rows."""
    _, _, counters = rt_traced
    key = expected_fetch_bytes(W, H, [], False)
    rows = (N_RT - 1) * (H // 16) * (W // 16) * 390 * 2
    want = {"fetch_bytes/key/rows": key["key/rows"],
            "fetch_bytes/key/recon": key["key/recon"],
            "fetch_bytes/rt_rows": rows}
    assert counters == dict(want, fetch_bytes=sum(want.values()))


def test_realtime_stream_equal_with_sections_on_and_off(rt_traced, tmp_path):
    data, _, _ = rt_traced
    assert not profiler.counters()
    assert _realtime(tmp_path / "off.ivf") == data


def expected_fetch_bytes(w, h, groups, key_deblock):
    """Bytes a device GOP copies to the host, by site, from the shapes of
    what it fetches: for each GF group of L frames (an ARF and L - 1
    chained P frames) TPL's 2L - 2 (cur, ref) cost pairs ((h/16, w/16, 4)
    float32 each), the temporal filter's three float32 planes and the
    ARF's three source planes, each inter frame's rows r16 (B16, 390), r32
    (B32, 1542), r64 (B64, 3078) int16, its level map (h/16, w/16) int8
    and its filter pick (int64), and the deblocked planes of the ARF and
    of the chain's last frame; for the KEY its wave rows (B16, 390) int16,
    its reconstruction and, where the device deblocks it, its deblocked
    planes.  Planes 4:2:0 uint8."""
    b16, b32, b64 = ((h // n) * (w // n) for n in (16, 32, 64))
    planes = w * h * 3 // 2
    inter = sum(groups)
    out = {"key/rows": b16 * 390 * 2, "key/recon": planes,
           "tpl": sum(2 * L - 2 for L in groups if L >= 2) * b16 * 16,
           "tf": sum(L >= 3 for L in groups) * planes * 4,
           "tf/src": sum(L >= 3 for L in groups) * planes,
           "group/r16": inter * b16 * 390 * 2,
           "group/r32": inter * b32 * 1542 * 2,
           "group/r64": inter * b64 * 3078 * 2,
           "group/lvl": inter * b16, "group/filt": inter * 8,
           "group/recon": sum(1 + (L >= 2) for L in groups) * planes}
    if key_deblock:
        out["key/deblock"] = planes
    return out


def test_expected_fetch_bytes_of_the_1080p_sequence():
    """The figure gop.fetch_mb_per_frame reads on the VOD cell: a 120-frame
    1920x1088 sequence (a KEY and GF groups of 8 x 14 and 7), 18.7 MB a
    frame."""
    want = expected_fetch_bytes(1920, 1088, [8] * 14 + [7], True)
    assert want["group/r16"] + want["group/r32"] + want["group/r64"] \
        == 119 * (6_364_800 + 6_291_360 + 3_139_560)
    assert sum(want.values()) == 2_249_462_032


def test_gop_fetch_bytes_equal_the_shapes(sections):
    """Every copy to the host of the device GOP goes through to_host:
    fetch_bytes, and each site's fetch_bytes/<site>, equal the sizes the
    fetched tensors' shapes give (at 96x64 the KEY is deblocked on the
    host)."""
    _gop()
    got = sections.counters()
    want = expected_fetch_bytes(W, H, [N_GOP - 1], False)
    assert got.pop("fetch_bytes") == sum(want.values())
    assert got == {f"fetch_bytes/{k}": v for k, v in want.items()}
    times = sections.times()
    assert "encode/fetch" in times and "key/fetch" in times


def test_gop_equal_with_sections_on_and_off_and_counts_only_when_on():
    """With the sections off nothing is counted; the GOP's payloads are
    the same with them on."""
    profiler.reset()
    off = _gop()
    assert profiler.counters() == {} and profiler.times() == {}
    profiler.enable(True)
    try:
        on = _gop()
    finally:
        profiler.enable(False)
    assert profiler.counters()["fetch_bytes"] > 0
    profiler.reset()
    assert profiler.counters() == {}
    assert on == off


#: VBR two-pass encodes at 96x64 that recode: (frames, target bits a
#: second) where the KEY recodes, and where the ARFs do
RECODING = [(8, 20_000), (12, 60_000)]


@pytest.mark.parametrize("n,bps", RECODING)
def test_twopass_sections_and_recode_counters(sections, monkeypatch,
                                              tmp_path, n, bps):
    """A VBR two-pass encode opens gop/first_pass once and gop/recode
    around each encode of a KEY or an ARF after its first; the counters
    recode_attempts/key and recode_attempts/arf count those encodes; the
    first pass's sums come to the host in one copy of 6 float32 a
    frame."""
    made = {"key": [], "arf": []}
    recode = GopEncoder._recode

    def counting(self, kind, display_idx, q, encode_fn):
        calls = [0]

        def fn(qq):
            calls[0] += 1
            return encode_fn(qq)
        try:
            return recode(self, kind, display_idx, q, fn)
        finally:
            if kind in made:
                made[kind].append(calls[0])

    monkeypatch.setattr(GopEncoder, "_recode", counting)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        encode_twopass_ivf(str(tmp_path / "vbr.ivf"), make_frames(n, W, H),
                           W, H, device="cpu",
                           rc_cfg=RateControlConfig(mode=MODE_VBR,
                                                    target_bps=bps,
                                                    fps=30.0), **KW)
    names = [ev.name for ev in prof.events()]
    got = sections.counters()
    again = {k: sum(v) - len(v) for k, v in made.items()}
    assert made["key"] and made["arf"] and sum(again.values()) > 0
    assert got["recode_attempts/key"] == again["key"]
    assert got["recode_attempts/arf"] == again["arf"]
    assert names.count("gop/recode") == sum(again.values())
    assert names.count("gop/first_pass") == 1
    assert got["fetch_bytes/fp"] == 6 * 4 * n


def test_fixed_q_gop_opens_no_recode(sections, tmp_path):
    """With a fixed q the recode loop returns before its section and
    counters: encode_gop_ivf's path is as it was."""
    encode_gop_ivf(str(tmp_path / "q.ivf"), make_frames(N_GOP, W, H), W, H,
                   device="cpu", **KW)
    assert "gop/recode" not in sections.times()
    assert "gop/first_pass" not in sections.times()
    assert not [k for k in sections.counters()
                if k.startswith("recode_attempts/")]


def test_count_and_reset(sections):
    sections.count("a")
    sections.count("a", 4)
    assert sections.counters() == {"a": 5}
    sections.enable(False)
    sections.count("a", 100)
    assert sections.counters() == {"a": 5}
    sections.reset()
    assert sections.counters() == {}


def test_to_host_returns_what_cpu_numpy_returns(sections):
    t = torch.arange(12, dtype=torch.int16).reshape(3, 4)
    got = IT.to_host(t, "site")
    np.testing.assert_array_equal(got, t.cpu().numpy())
    assert got.dtype == np.int16
    assert sections.counters() == {"fetch_bytes": 24,
                                   "fetch_bytes/site": 24}
    assert sections.times()["encode/fetch"] >= 0


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int8, torch.int16,
                                   torch.int64, torch.float32])
@pytest.mark.parametrize("contiguous", [True, False])
def test_to_host_of_a_cpu_tensor_is_its_own_numpy_view(sections, dtype,
                                                       contiguous):
    """A CPU tensor takes t.cpu().numpy(): the array is a view of the
    tensor's own memory (no copy, no pinned memory), and nothing is counted
    under fetch_pinned_bytes."""
    t = torch.arange(48).reshape(4, 12).to(dtype)
    if not contiguous:
        t = t[:, ::3].t()
    got = IT.to_host(t, "site")
    want = t.cpu().numpy()
    assert got.dtype == want.dtype and got.strides == want.strides
    np.testing.assert_array_equal(got, want)
    assert np.shares_memory(got, want)
    assert sections.counters() == {"fetch_bytes": want.nbytes,
                                   "fetch_bytes/site": want.nbytes}


def _group(seed, F=3, nb=6, h=16, w=24):
    """A made-up group's device results on the CPU: raw rows, level maps
    and filter picks with a leading frame axis of F, and F deblocked
    (y, u, v) planes."""
    g = torch.Generator().manual_seed(seed)
    ints = lambda *shape, dtype=torch.int16: torch.randint(  # noqa: E731
        -300, 300, shape, generator=g).to(dtype)
    raw = dict(r16=ints(F, nb, 390), r32=ints(F, nb // 4, 390),
               r64=ints(F, 1, 390), lvl=ints(F, 2, 3, dtype=torch.uint8),
               filt=ints(F, dtype=torch.int64))
    rec = tuple(torch.randint(0, 256, (F, a, b), generator=g,
                              dtype=torch.uint8)
                for a, b in ((h, w), (h // 2, w // 2), (h // 2, w // 2)))
    return raw, rec


@pytest.mark.parametrize("last_recon", [False, True])
def test_fetch_group_of_cpu_tensors_equals_one_fetch_an_array(
        sections, last_recon):
    """fetch_group on CPU tensors, two raws (one with planes, one
    without): each frame's arrays and planes equal t.cpu().numpy() of its
    slice, with last_recon only the last frame of a raw has planes; the
    bytes are counted a site as one fetch an array counts them, and none
    under fetch_pinned_bytes."""
    (raw_a, rec_a), (raw_b, _) = _group(1), _group(2, F=2)
    host, recons = IT.fetch_group([raw_a, raw_b], [rec_a, None],
                                  last_recon=last_recon)
    assert len(host) == len(recons) == 5
    for f, (raw, j) in enumerate([(raw_a, 0), (raw_a, 1), (raw_a, 2),
                                  (raw_b, 0), (raw_b, 1)]):
        assert host[f].keys() == raw.keys()
        assert host[f]["filt"] == int(raw["filt"][j])
        for k in ("r16", "r32", "r64", "lvl"):
            np.testing.assert_array_equal(host[f][k], raw[k][j].numpy())
    for f in range(3):
        if last_recon and f < 2:
            assert recons[f] is None
            continue
        for got, p in zip(recons[f], rec_a):
            np.testing.assert_array_equal(got, p[f].numpy())
    assert recons[3] is None and recons[4] is None
    want = {}
    for k in raw_a:
        want[f"fetch_bytes/group/{k}"] = raw_a[k].numpy().nbytes \
            + raw_b[k].numpy().nbytes
    want["fetch_bytes/group/recon"] = sum(
        (p[-1] if last_recon else p).numpy().nbytes for p in rec_a)
    got = sections.counters()
    assert got.pop("fetch_bytes") == sum(want.values())
    assert got == want
    assert sections.times()["encode/fetch"] >= 0
    assert profiler._COUNTS["encode/fetch"] == 1


def test_encode_chain_last_recon_is_the_last_of_all(sections):
    """DeviceChainEncoder.encode_chain on the CPU: with recon="last" the
    raws equal recon="all"'s, every recon but the last is None and the
    last equals "all"'s last; one encode/fetch section a chain, and only
    the last frame's planes counted under group/recon."""
    frames = make_frames(4, W, H)
    enc = IT.DeviceChainEncoder("cpu")
    out = {}
    for recon in ("all", "last"):
        sections.reset()
        out[recon] = enc.encode_chain(frames[1:], [120] * 3, frames[0],
                                      recon=recon)
        out[recon, "counters"] = sections.counters()
        assert profiler._COUNTS["encode/fetch"] == 1
    (raws_a, recs_a), (raws_l, recs_l) = out["all"], out["last"]
    for a, b in zip(raws_a, raws_l):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    assert recs_l[:2] == [None, None]
    for a, b in zip(recs_a[-1], recs_l[-1]):
        np.testing.assert_array_equal(a, b)
    plane = W * H * 3 // 2
    assert out["all", "counters"]["fetch_bytes/group/recon"] == 3 * plane
    assert out["last", "counters"]["fetch_bytes/group/recon"] == plane
    assert "fetch_pinned_bytes" not in out["last", "counters"]


def test_rt_frames_yields_each_frame_once(sections):
    frames = [(np.full((2, 2), i, np.uint8),) for i in range(3)]
    got = list(IT.rt_frames(iter(frames)))
    assert [f[0][0, 0] for f in got] == [0, 1, 2]
    assert all(a is b for a, b in zip(got, frames))
    assert profiler._COUNTS["encode/rt_source"] == 4


def test_section_open_when_torch_profiler_stops():
    """A section that the torch profiler's stop falls inside (the live
    benchmark stops its trace inside the camera's frame pull) closes
    without error."""
    profiler.reset()
    profiler.enable(True)
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()

    def camera():
        yield 1
        profiler.enable(False)
        prof.stop()
        yield 2
    try:
        assert list(IT.rt_frames(camera())) == [1, 2]
    finally:
        profiler.enable(False)
    names = [ev.name for ev in prof.events()]
    assert "encode/rt_source" in names
    profiler.reset()
