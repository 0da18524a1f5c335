"""Tests of the port that need a CUDA card (marker `cuda`; each skips
without one).  This file imports no JAX, so it also runs on a GPU host
that has none:

    AVL_TPU_TESTS=1 python -m pytest tests/test_torch_cuda.py -q

(AVL_TPU_TESTS=1 keeps tests/conftest.py from pinning JAX to the CPU,
which would import it.)"""

import numpy as np
import pytest
import torch

from aom_av1_lavish_torch.ops import kernels as K


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are CUDA C++ and have "
                    "no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions(cuda_device):
    """Every kernel entry on the card against its plain version, exact, at
    the 1080p slice's shapes (the cases chip_smoke.py times: both entries
    of K2 and K3 among them), and each launch counted once under its
    kernel's name."""
    import chip_smoke
    for name, fn, label, args, *_ in chip_smoke._cases(cuda_device):
        name = chip_smoke.KERNELS[name][2]
        before = K.LAUNCHES[name]
        getattr(K, fn)(*args)
        assert K.LAUNCHES[name] == before + 1
        got, want = chip_smoke.run_case(K, fn, args)
        if fn == "wave_encode":
            err, rel, _ = chip_smoke.wave_error(got, want, args)
            assert err == 0.0 and rel <= 1e-6, f"{name} {label}"
            continue
        for g, w in zip(got, want):
            assert torch.equal(g, w), f"{name} {label}"


@pytest.mark.cuda
@pytest.mark.parametrize("w,h,n_frames", [(96, 64, 1), (96, 64, 3),
                                          (80, 48, 2), (1920, 1088, 1)])
def test_cuda_wave_encode_frame_matches_plain(cuda_device, w, h, n_frames):
    """K4's fused entry on the card, wave after wave over whole frames
    (each wave reads the recon the waves before it wrote), against the
    same waves through its plain version: rows and recon equal, costs to
    1e-6, one launch a wave counted under the kernel and under its entry."""
    from aom_av1_lavish_torch.common import quant as Q
    from aom_av1_lavish_torch.ops.wavefront import pq_array, wave_table
    from aom_av1_lavish_torch.utils.clips import make_frames

    frames = make_frames(n_frames, w, h)
    src = [torch.as_tensor(np.stack([f[i] for f in frames]),
                           device=cuda_device) for i in range(3)]
    order, offsets = wave_table(h // 16, w // 16)
    order = torch.as_tensor(order, device=cuda_device)
    pq = torch.as_tensor(np.stack([pq_array(Q.build_plane_quant(100, 0, 0))
                                   ] * 3), device=cuda_device)
    sides = []
    for fn in (K.wave_encode, K.wave_encode_plain):
        rows = torch.zeros((n_frames, order.numel(), 390), dtype=torch.int16,
                           device=cuda_device)
        recon = [torch.zeros_like(p) for p in src]
        K.reset_launches()
        costs = [fn(rows, *recon, *src, order, offsets[d],
                    offsets[d + 1] - offsets[d], pq, 55.0)
                 for d in range(len(offsets) - 1)]
        if fn is K.wave_encode:
            assert K.LAUNCHES["quantize_b_vec"] == len(offsets) - 1
            assert K.ENTRY_LAUNCHES == {"avl_wave_encode": len(offsets) - 1}
        sides.append((rows, recon, torch.cat(costs, 1)))
    (rows_k, recon_k, cost_k), (rows_p, recon_p, cost_p) = sides
    assert torch.equal(rows_k, rows_p)
    for a, b in zip(recon_k, recon_p):
        assert torch.equal(a, b)
    torch.testing.assert_close(cost_k, cost_p, rtol=1e-6, atol=0)


@pytest.mark.cuda
def test_cuda_gop_recon_matches_decoder(cuda_device):
    """The slice's configuration at 96x64 on the card: 8 TUs whose
    decode reproduces every reference slot of the encoder."""
    from aom_av1_lavish_torch.decoder.decoder import decode_frame_obus
    from aom_av1_lavish_torch.encoder.gop import TorchGopEncoder
    from aom_av1_lavish_torch.utils.clips import make_frames

    frames = make_frames(8, 96, 64)
    enc = TorchGopEncoder(96, 64, device=cuda_device, qindex=120,
                          gf_length=8, use_tpu=True, enable_cdef=False,
                          cpu_used=8)
    K.reset_launches()
    payloads = enc.encode_sequence(frames)
    assert len(payloads) == 8 and all(payloads)
    assert all(v > 0 for v in K.LAUNCHES.values()), K.LAUNCHES
    sh, state = None, {"slots": [None] * 8}
    for p in payloads:
        _, sh = decode_frame_obus(p, sh, state)
    for slot in range(8):
        if enc.slots[slot] is None:
            continue
        for pe, pd in zip(enc.slots[slot], state["slots"][slot]["planes"]):
            np.testing.assert_array_equal(pe, pd)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bsz,radius,lo,hi", [
    (torch.uint8, 16, 16, 0, 256), (torch.uint8, 16, 16, 240, 256),
    (torch.int32, 8, 16, 0, 1021), (torch.int32, 8, 16, 350, 511),
    (torch.int32, 8, 16, 960, 1021),
    (torch.uint8, 8, 5, 0, 256), (torch.int32, 16, 3, 0, 1021)])
def test_cuda_ssd_surface_plane_matches_plain(cuda_device, dtype, bsz,
                                              radius, lo, hi):
    """K2 from planes on the card, exact: a 7x9 block grid (no multiple of
    the kernel's block group) at an odd window origin, so both the 16-byte
    and the unaligned staging paths run across the cases; int32 350..510
    and 960..1020 take the two branches of the surface's rounding rule."""
    rng = np.random.default_rng(bsz + radius)
    nby, nbx, oy, ox = 7, 9, 1, 3
    Wn = 2 * radius + bsz
    npdt = np.uint8 if dtype == torch.uint8 else np.int32
    src = torch.as_tensor(rng.integers(lo, hi, (nby * bsz, nbx * bsz))
                          .astype(npdt), device=cuda_device)
    ref = torch.as_tensor(rng.integers(
        lo, hi, (oy + (nby - 1) * bsz + Wn, ox + (nbx - 1) * bsz + Wn))
        .astype(npdt), device=cuda_device)
    before = K.LAUNCHES["ssd_surface"]
    got = K.ssd_surface_plane(src, ref, nby, nbx, bsz, radius, oy, ox)
    assert K.LAUNCHES["ssd_surface"] == before + 1
    want = K.ssd_surface_plane_plain(src, ref, nby, nbx, bsz, radius, oy, ox)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8, 16, 32, 64])
def test_cuda_convolve_8tap_plane_matches_plain(cuda_device, n):
    """K3 from a plane on the card, exact, with origins on and off the
    plane (the clamp) and every row of the three filter banks."""
    from aom_av1_lavish_torch.common import interpred as IP
    rng = np.random.default_rng(n)
    B = 333
    plane = torch.as_tensor(rng.integers(0, 256, (150, 201))
                            .astype(np.uint8), device=cuda_device)
    br = torch.as_tensor(rng.integers(-n - 10, 160, B).astype(np.int32),
                         device=cuda_device)
    bc = torch.as_tensor(rng.integers(-n - 10, 211, B).astype(np.int32),
                         device=cuda_device)
    filt = np.concatenate([np.asarray(IP.SUBPEL_FILTERS_8),
                           np.asarray(IP.SUBPEL_FILTERS_8SMOOTH),
                           np.asarray(IP.SUBPEL_FILTERS_8SHARP)])
    kx = torch.as_tensor(filt[rng.integers(0, len(filt), B)]
                         .astype(np.int32), device=cuda_device)
    ky = torch.as_tensor(filt[rng.integers(0, len(filt), B)]
                         .astype(np.int32), device=cuda_device)
    before = K.LAUNCHES["convolve_8tap"]
    got = K.convolve_8tap_plane(plane, br, bc, kx, ky, n, n)
    assert K.LAUNCHES["convolve_8tap"] == before + 1
    want = K.convolve_8tap_plane_plain(plane, br, bc, kx, ky, n, n)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("bsz,n_cand,spread", [(16, 9, 1), (8, 9, 1),
                                               (16, 4, 3), (8, 33, 2),
                                               (16, 9, 400)])
def test_cuda_block_ssd_at_matches_plain(cuda_device, bsz, n_cand, spread):
    """K1's fused form on the card, exact: candidates within `spread` of a
    centre that lies on or off the plane (a spread of 400 scatters them, so
    the kernel reads each from the plane instead of a staged box), on a
    plane whose width is no multiple of 16, and on one that is."""
    rng = np.random.default_rng(bsz + n_cand + spread)
    nby, nbx = 7, 9
    B = nby * nbx
    for Hr, Wr in ((150, 201), (160, 208)):
        src = torch.as_tensor(rng.integers(0, 256, (nby * bsz, nbx * bsz + 3))
                              .astype(np.uint8), device=cuda_device)
        ref = torch.as_tensor(rng.integers(0, 256, (Hr, Wr)).astype(np.uint8),
                              device=cuda_device)
        cy = rng.integers(-bsz - 5, Hr + 5, (B, 1))
        cx = rng.integers(-bsz - 5, Wr + 5, (B, 1))
        br = torch.as_tensor((cy + rng.integers(-spread, spread + 1,
                                                (B, n_cand)))
                             .astype(np.int32), device=cuda_device)
        bc = torch.as_tensor((cx + rng.integers(-spread, spread + 1,
                                                (B, n_cand)))
                             .astype(np.int32), device=cuda_device)
        before = K.LAUNCHES["gather_windows"]
        got = K.block_ssd_at(src, ref, br, bc, nby, nbx, bsz)
        assert K.LAUNCHES["gather_windows"] == before + 1
        want = K.block_ssd_at_plain(src, ref, br, bc, nby, nbx, bsz)
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,wr,wc", [
    (torch.uint8, 16, 16), (torch.uint8, 8, 8), (torch.uint8, 16, 24),
    (torch.uint8, 23, 23), (torch.uint8, 5, 3), (torch.uint8, 71, 71),
    (torch.int32, 25, 25), (torch.int32, 8, 8), (torch.int32, 3, 1)])
def test_cuda_gather_windows_matches_plain(cuda_device, dtype, wr, wc):
    """K1's gather form on the card, exact, with origins on and off the
    plane: row widths that take the 16-byte row segments and widths that
    take the 16-byte pieces of the output."""
    rng = np.random.default_rng(wr * 100 + wc)
    npdt = np.uint8 if dtype == torch.uint8 else np.int32
    plane = torch.as_tensor(rng.integers(0, 256, (150, 201)).astype(npdt),
                            device=cuda_device)
    for B in (1, 333):
        br = torch.as_tensor(rng.integers(-wr - 10, 160, B).astype(np.int32),
                             device=cuda_device)
        bc = torch.as_tensor(rng.integers(-wc - 10, 211, B).astype(np.int32),
                             device=cuda_device)
        before = K.LAUNCHES["gather_windows"]
        got = K.gather_windows(plane, br, bc, wr, wc)
        assert K.LAUNCHES["gather_windows"] == before + 1
        assert torch.equal(got, K.gather_windows_plain(plane, br, bc, wr, wc))


@pytest.mark.cuda
def test_cuda_tpl_and_temporal_filter_match_the_cpu(cuda_device):
    """tpl_gf_group and temporal_filter on the card against the same
    functions with device="cpu": motion vectors and inter costs equal,
    float32 results to 1e-6, filtered planes within 1 LSB; and both went
    through the plane form of K2 and the gather form of K1 only."""
    from aom_av1_lavish_torch.encoder import temporal_filter as FT
    from aom_av1_lavish_torch.encoder import tpl as TT
    from aom_av1_lavish_torch.utils.clips import make_frames

    group = make_frames(7, 192, 128)
    pairs = [(group[j][0], group[6][0]) for j in range(3)]
    K.reset_launches()
    for (gi, ge, gm), (ci, ce, cm) in zip(TT._group_costs(pairs,
                                                          cuda_device),
                                          TT._group_costs(pairs, "cpu")):
        np.testing.assert_array_equal(gm, cm)
        np.testing.assert_array_equal(ge, ce)
        np.testing.assert_allclose(gi, ci, rtol=1e-6)
    assert K.ENTRY_LAUNCHES == {"avl_ssd_surface_plane": 3}
    imp_g, maps_g = TT.tpl_gf_group(group, 6, device=cuda_device)
    imp_c, maps_c = TT.tpl_gf_group(group, 6, device="cpu")
    np.testing.assert_allclose(imp_g, imp_c, rtol=1e-6)
    for g, c in zip(maps_g, maps_c):
        np.testing.assert_allclose(g, c, rtol=1e-6)
    K.reset_launches()
    got = FT.temporal_filter(group, 6, 120, device=cuda_device)
    assert K.ENTRY_LAUNCHES == {"avl_ssd_surface_plane": 2,
                                "avl_gather_windows": 6}
    want = FT.temporal_filter(group, 6, 120, device="cpu")
    for g, c in zip(got, want):
        assert g.dtype == np.uint8 and g.shape == c.shape
        assert np.abs(g.astype(np.int32) - c.astype(np.int32)).max() <= 1


@pytest.mark.cuda
def test_cuda_gop_with_tpl_and_tf_matches_decoder(cuda_device):
    """The default configuration's tools at 96x64 on the card (cpu_used=8
    for the wavefront KEY, then TPL and the filter set on the encoder): the
    decoder reproduces every reference slot, and the refine made one fused
    K1 launch per frame and reference."""
    from aom_av1_lavish_torch.decoder.decoder import decode_frame_obus
    from aom_av1_lavish_torch.encoder.gop import TorchGopEncoder
    from aom_av1_lavish_torch.utils.clips import make_frames

    frames = make_frames(8, 96, 64)
    enc = TorchGopEncoder(96, 64, device=cuda_device, qindex=120,
                          gf_length=8, use_tpu=True, enable_cdef=False,
                          cpu_used=8)
    enc.enable_tpl = enc.enable_tf = True
    K.reset_launches()
    payloads = enc.encode_sequence(frames)
    assert len(payloads) == 8 and all(payloads)
    assert K.ENTRY_LAUNCHES["avl_block_ssd_at"] == 13
    assert K.ENTRY_LAUNCHES["avl_gather_windows"] == 6
    assert K.LAUNCHES["ssd_surface"] == 26 + 12 + 2
    assert "avl_ssd_surface" not in K.ENTRY_LAUNCHES
    sh, state = None, {"slots": [None] * 8}
    for p in payloads:
        _, sh = decode_frame_obus(p, sh, state)
    for slot in range(8):
        if enc.slots[slot] is None:
            continue
        for pe, pd in zip(enc.slots[slot], state["slots"][slot]["planes"]):
            np.testing.assert_array_equal(pe, pd)


@pytest.mark.cuda
def test_cuda_entry_points_default_to_the_card(cuda_device):
    from aom_av1_lavish_torch.ops.inter import DeviceChainEncoder
    assert DeviceChainEncoder().device.type == "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("n,rows,log_scale", [
    (16, 27648 * 61, 0), (64, 6912 * 61, 0), (128, 3456 * 61, 0),
    (256, 1728 * 61, 0), (512, 864 * 61, 1), (1024, 432 * 61, 1),
    (1024, 216 * 61, 2), (1024, 108 * 61, 2), (256, 4 * 68 * 7, 0),
    (64, 4 * 68, 0)])
def test_cuda_quantize_matches_plain_at_the_trial_and_batch_shapes(
        cuda_device, n, rows, log_scale):
    """K4 on the card, exact, at the shapes of the device-RDO trials of a
    720x576 KEY (every block of a geometry under 61 modes) and of one wave
    of the batched all-intra entry at 1080p (4 frames)."""
    from aom_av1_lavish_torch.common import quant as Q
    from aom_av1_lavish_torch.ops.wavefront import pq_array, quantize
    rng = np.random.default_rng(n + log_scale)
    coeff = torch.as_tensor(rng.integers(-(1 << 15), 1 << 15, (rows, n))
                            .astype(np.int32), device=cuda_device)
    pq = torch.as_tensor(pq_array(Q.build_plane_quant(120, 0, 0)),
                         device=cuda_device)
    dc = torch.arange(n, device=cuda_device) == 0
    before = K.LAUNCHES["quantize_b_vec"]
    q, dq = quantize(coeff, pq, log_scale, dc)
    assert K.LAUNCHES["quantize_b_vec"] == before + 1
    qc, dqc = quantize(coeff.cpu(), pq.cpu(), log_scale, dc.cpu())
    assert torch.equal(q.cpu(), qc) and torch.equal(dq.cpu(), dqc)


def _new_paths():
    from aom_av1_lavish_torch.encoder import encode_lossless_ivf
    from aom_av1_lavish_torch.encoder.gop import (encode_gop_ivf,
                                                  encode_twopass_ivf)
    from aom_av1_lavish_torch.encoder.nonrd import encode_realtime_tpu_ivf
    from aom_av1_lavish_torch.encoder.tpu_inter import encode_tpu_lowdelay_ivf
    from aom_av1_lavish_torch.encoder.tpu_intra import encode_tpu_ivf
    from aom_av1_lavish_torch.encoder.tpu_rdo import encode_tpu_rdo_ivf
    gop = dict(qindex=120, gf_length=8, use_tpu=True, enable_cdef=False)
    # name -> (entry, frames, keywords, kernels its path must launch)
    every = ("gather_windows", "ssd_surface", "convolve_8tap",
             "quantize_b_vec")
    return {
        "device_rdo": (encode_tpu_rdo_ivf, 2, dict(qindex=80),
                       ("quantize_b_vec",)),
        "default_gop": (encode_gop_ivf, 8, gop, every),
        "lowdelay": (encode_tpu_lowdelay_ivf, 4, dict(qindex=60), every),
        "realtime": (encode_realtime_tpu_ivf, 4, dict(qindex=90), every),
        "gf_length_2": (encode_gop_ivf, 8,
                        dict(gop, cpu_used=8, gf_length=2), every),
        "use_arf_off": (encode_gop_ivf, 8,
                        dict(gop, cpu_used=8, use_arf=False), every),
        "lossless": (encode_lossless_ivf, 2, {}, ()),
        "twopass": (encode_twopass_ivf, 8, gop, every),
        "intra_batch": (encode_tpu_ivf, 3, dict(qindex=100),
                        ("quantize_b_vec",)),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["device_rdo", "default_gop", "lowdelay",
                                  "realtime", "gf_length_2", "use_arf_off",
                                  "lossless", "twopass", "intra_batch"])
def test_cuda_path_writes_the_stream_of_the_cpu_run(cuda_device, tmp_path,
                                                    name):
    """Each device path at 96x64 on the card: the kernels of its path
    launch, and the IVF equals the same entry's with device="cpu" byte for
    byte."""
    from aom_av1_lavish_torch.utils.clips import make_frames
    fn, n, kw, kernels = _new_paths()[name]
    frames = make_frames(n, 96, 64)
    out = []
    for device in (cuda_device, "cpu"):
        path = str(tmp_path / f"{device}.ivf")
        K.reset_launches()
        fn(path, frames, 96, 64, device=device, **kw)
        launched = {k for k, v in K.LAUNCHES.items() if v > 0}
        assert launched == (set(kernels) if device != "cpu" else set())
        with open(path, "rb") as f:
            out.append(f.read())
    assert len(out[0]) > 32 and out[0] == out[1]


@pytest.mark.cuda
def test_cuda_first_pass_matches_the_cpu(cuda_device):
    """first_pass on the card: one K2 launch (plane form) a frame, stats
    equal to the CPU's to 1e-5."""
    from aom_av1_lavish_torch.encoder.firstpass import first_pass
    from aom_av1_lavish_torch.utils.clips import make_frames
    frames = make_frames(5, 192, 128)
    K.reset_launches()
    got = first_pass(frames, device=cuda_device)
    assert K.ENTRY_LAUNCHES == {"avl_ssd_surface_plane": 5}
    want = first_pass(frames, device="cpu")
    np.testing.assert_allclose(np.stack([s.to_array() for s in got]),
                               np.stack([s.to_array() for s in want]),
                               rtol=1e-5)


@pytest.mark.cuda
def test_cuda_realtime_rows_come_back_through_pinned_memory(cuda_device):
    """DeviceRtEncoder on the card: the handle holds a pinned host tensor
    and an event, a second frame can be enqueued before the first is
    realized, and the rows equal the CPU's."""
    from aom_av1_lavish_torch.ops.inter import DeviceRtEncoder
    from aom_av1_lavish_torch.utils.clips import make_frames
    frames = make_frames(3, 96, 64)
    rows = {}
    for device in (cuda_device, "cpu"):
        enc = DeviceRtEncoder(90, device=device)
        enc.reset_ref(frames[0])
        h1 = enc.encode_frame_async(frames[1])
        h2 = enc.encode_frame_async(frames[2])
        if device != "cpu":
            assert h1[0].is_pinned() and h1[1] is not None
            assert enc.state[0].device.type == "cuda"
        rows[str(device)] = (enc.realize(h1).copy(), enc.realize(h2).copy(),
                             enc.fetch_recon(64, 96))
    a, b = rows.values()
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    for pa, pb in zip(a[2], b[2]):
        np.testing.assert_array_equal(pa, pb)


@pytest.mark.cuda
@pytest.mark.parametrize("mesh", [False, True])
def test_cuda_fpmt_gop_writes_the_stream_of_the_cpu_run(cuda_device, mesh):
    """The frame-parallel GOP at 96x64 on the card (mesh=None, or a
    make_mesh(4, 1) layout on the card): every kernel launches, and the
    payloads equal the CPU run's."""
    from aom_av1_lavish_torch.encoder.gop import GopEncoder
    from aom_av1_lavish_torch.parallel.sharding import make_mesh
    from aom_av1_lavish_torch.utils.clips import make_frames
    frames = make_frames(8, 96, 64)
    out = []
    for device in (cuda_device, "cpu"):
        K.reset_launches()
        enc = GopEncoder(96, 64, device=device, frame_parallel=True,
                         mesh=make_mesh(4, 1, device=device) if mesh
                         else None, qindex=120, gf_length=8, use_tpu=True,
                         enable_cdef=False)
        out.append(enc.encode_sequence(frames))
        launched = {k for k, v in K.LAUNCHES.items() if v > 0}
        assert launched == (set(K.LAUNCHES) if device != "cpu" else set())
    assert all(out[0]) and out[0] == out[1]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bsz,radius,hi", [
    (torch.uint8, 16, 16, 256), (torch.int32, 8, 16, 1021),
    (torch.uint8, 8, 5, 256), (torch.int32, 16, 3, 1021)])
def test_cuda_ssd_surface_plane_frames_match_plain(cuda_device, dtype, bsz,
                                                   radius, hi):
    """K2 from planes with a frame axis on the card, exact: 3 source
    planes (of a width whose frame stride breaks 16-byte alignment) against
    one reference in one launch, equal to the plain version and to one
    launch a frame."""
    rng = np.random.default_rng(3 * bsz + radius)
    nby, nbx, oy, ox = 7, 9, 1, 3
    Wn = 2 * radius + bsz
    npdt = np.uint8 if dtype == torch.uint8 else np.int32
    src = torch.as_tensor(rng.integers(0, hi, (3, nby * bsz + 1,
                                               nbx * bsz + 3))
                          .astype(npdt), device=cuda_device)
    ref = torch.as_tensor(rng.integers(
        0, hi, (oy + (nby - 1) * bsz + Wn, ox + (nbx - 1) * bsz + Wn))
        .astype(npdt), device=cuda_device)
    before = K.LAUNCHES["ssd_surface"]
    got = K.ssd_surface_plane(src, ref, nby, nbx, bsz, radius, oy, ox)
    assert K.LAUNCHES["ssd_surface"] == before + 1
    assert torch.equal(got, K.ssd_surface_plane_plain(src, ref, nby, nbx, bsz,
                                                      radius, oy, ox))
    assert torch.equal(got, torch.stack([K.ssd_surface_plane(
        s, ref, nby, nbx, bsz, radius, oy, ox) for s in src]))


@pytest.mark.cuda
@pytest.mark.parametrize("bsz", [16, 8])
def test_cuda_block_ssd_at_frames_match_plain(cuda_device, bsz):
    """K1's fused form with a frame axis on the card, exact: 3 frames' 3x3
    neighbourhoods, some off the reference, in one launch."""
    rng = np.random.default_rng(bsz + 1)
    nby, nbx = 5, 7
    B = nby * nbx
    src = torch.as_tensor(rng.integers(0, 256, (3, nby * bsz + 2,
                                                nbx * bsz + 5))
                          .astype(np.uint8), device=cuda_device)
    ref = torch.as_tensor(rng.integers(0, 256, (90, 117)).astype(np.uint8),
                          device=cuda_device)
    off = np.array([-1, 0, 1])
    cy = rng.integers(-bsz - 20, 110, (3, B))[..., None] + np.repeat(off, 3)
    cx = rng.integers(-bsz - 20, 137, (3, B))[..., None] + np.tile(off, 3)
    br, bc = (torch.as_tensor(a.astype(np.int32), device=cuda_device)
              for a in (cy, cx))
    before = K.ENTRY_LAUNCHES.get("avl_block_ssd_at", 0)
    got = K.block_ssd_at(src, ref, br, bc, nby, nbx, bsz)
    assert K.ENTRY_LAUNCHES["avl_block_ssd_at"] == before + 1
    assert torch.equal(got, K.block_ssd_at_plain(src, ref, br, bc, nby, nbx,
                                                 bsz))
    assert torch.equal(got, torch.stack([K.block_ssd_at(
        src[f], ref, br[f], bc[f], nby, nbx, bsz) for f in range(3)]))


@pytest.mark.cuda
@pytest.mark.parametrize("n,log_scale", [(64, 0), (256, 0), (1024, 1),
                                         (1024, 2)])
def test_cuda_quantize_b_vec_frame_rows_match_plain(cuda_device, n,
                                                    log_scale):
    """K4 with a parameter row a frame on the card, exact (random params
    that make the int32 products wrap)."""
    rng = np.random.default_rng(n * 3 + log_scale)

    def t(a):
        return torch.as_tensor(a.astype(np.int32), device=cuda_device)

    coeff = t(rng.integers(-(1 << 20), 1 << 20, (6, 301, n)))
    par = [t(rng.integers(a, b, (6, n)))
           for a, b in ((20, 1000), (10, 500), (1 << 12, 1 << 16),
                        (1 << 14, 1 << 16), (4, 7000))]
    before = K.LAUNCHES["quantize_b_vec"]
    q, dq = K.quantize_b_vec(coeff, *par, log_scale)
    assert K.LAUNCHES["quantize_b_vec"] == before + 1
    qp, dqp = K.quantize_b_vec_plain(coeff, *par, log_scale)
    assert torch.equal(q, qp) and torch.equal(dq, dqp)


@pytest.mark.cuda
def test_cuda_fpmt_group_launches_each_entry_once_a_group(cuda_device):
    """fpmt_encode_group on the card: one launch per kernel entry for the
    group's 4 frames, as many as for one frame (K2 4, K1 2, K3 90, K4 9),
    and the CPU's results."""
    from aom_av1_lavish_torch.parallel.sharding import fpmt_encode_group
    from aom_av1_lavish_torch.utils.clips import make_frames
    frames = make_frames(6, 96, 64)
    args = (frames[1:5], [80, 96, 130, 110], frames[0], frames[5])
    kw = dict(lf_levels=[(10, 4, 4), 12, 0, (20, 8, 6)])
    K.reset_launches()
    raws, recs = fpmt_encode_group(None, *args, device=cuda_device, **kw)
    assert K.LAUNCHES == {"ssd_surface": 4, "gather_windows": 2,
                          "convolve_8tap": 90, "quantize_b_vec": 9}
    craws, crecs = fpmt_encode_group(None, *args, device="cpu", **kw)
    for a, b in zip(raws, craws):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    for a, b in zip(recs, crecs):
        for pa, pb in zip(a, b):
            np.testing.assert_array_equal(pa, pb)


@pytest.mark.cuda
@pytest.mark.parametrize("w,h", [(96, 64), (352, 288)])
def test_cuda_programs_replay_their_plain_versions(cuda_device, w, h):
    """Each P-frame program (the ARF, the chain, the frame-parallel group,
    a low-delay P frame, a realtime step) at w x h on two groups of
    different inputs, replaying one capture: each replay equals the plain
    function's eager call on its own inputs, output for output, and counts
    the kernel launches that one eager call counts."""
    import chip_smoke
    from aom_av1_lavish_torch.utils.clips import make_frames

    frames = make_frames(8, w, h)
    seen = {}
    for g, qs in enumerate(chip_smoke.PROGRAM_QS):
        for name, prog, args in chip_smoke.program_cases(
                cuda_device, frames, qs, w, h, g):
            K.reset_launches()
            got = [t.clone() for t in prog(*args)]
            replayed = K.launch_counts()
            K.reset_launches()
            want = prog.fn(*args)
            assert K.launch_counts() == replayed, name
            assert sum(replayed[0].values()) > 0, name
            assert len(got) == len(want)
            for a, b in zip(got, want):
                assert torch.equal(a, b), (name, g)
            cap = prog.capture_of(*args)
            assert cap is not None and cap.replays >= g + 1, name
            seen.setdefault(name, []).append(got)
    # the two groups' inputs differ, and so do their results
    for name, (a, b) in seen.items():
        assert not all(torch.equal(x, y) for x, y in zip(a, b)), name


@pytest.mark.cuda
@pytest.mark.parametrize("what", ["host copy", "host read"])
def test_cuda_failed_capture_raises(cuda_device, what):
    """A function that copies from the host, or reads a device value on the
    host, cannot be captured: the program raises, keeps no capture, and
    leaves the launch counters as they were."""
    from aom_av1_lavish_torch.ops.graphs import DeviceProgram

    def fn(x):
        if what == "host copy":
            return (x + torch.tensor([1.0], device=x.device),)
        return (x * float(x.sum()),)

    prog = DeviceProgram(fn, what)
    K.reset_launches()
    before = K.launch_counts()
    with pytest.raises(RuntimeError, match="capture failed"):
        prog(torch.ones(4, device=cuda_device))
    assert prog.captures == {}
    assert K.launch_counts() == before
