"""ROADMAP Queue 3, F1, on one frame pair of the repo's clip, on the CPU:
the port's full-pel search surfaces (K2's plain version) against the JAX
package's, as its full-pel search computes them (inter_tpu._fullpel_search,
jitted on the CPU).

    JAX_PLATFORMS=cpu python tools/f1_surfaces.py [--size 1920x1088] [--gop]

For the pair make_frames()[0] -> [1] (reference frame 0, source frame 1)
at the clip's own range and with each luma plane stretched to 0..255,
prints:
  * luma mean and max of the source;
  * full resolution (uint8, bsz 16, r 16): surface entries in all, entries
    with S2 + W2 >= 2^24 (where the reference rounds), entries with S2, W2
    or C >= 2^24, entries where the port's surface differs from the JAX
    package's, entries where the exact SSD would differ from it, and
    blocks whose biased argmin differs;
  * half resolution (int32 2x2 sums, bsz 8, r 16): the same counts, and
    the blocks whose argmin (iy1, ix1; the only use of this surface)
    differs;
  * the search's result (best dy, dx, cost) of both packages: blocks that
    differ.
The JAX package's surfaces are computed here by jitting its own functions
alone; inside its P-frame program XLA may order the sums above 2^24
differently, so the half-resolution counts are those of this program.
Takes a few minutes and about 3 GB at 1920x1088.

With --gop it then encodes the first 4 frames of the clip at its own
range with both packages on the CPU (GopEncoder, cpu_used 8, qindex 120,
gf_length 4: a KEY, then the hidden ARF and two P frames as chains) and
prints whether the streams are equal, or the first differing TU and chain
result (chip_smoke.first_group_difference).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def stretch(y):
    y = y.astype(np.float64)
    return np.round((y - y.min()) * 255.0 / (y.max() - y.min())) \
        .astype(np.uint8)


def port_surfaces(cur, ref, nby, nbx):
    """-> full and half surfaces, their (S2, W2, C) order-free masks, and
    the search result, all numpy."""
    import torch

    from aom_av1_lavish_torch.ops import inter as IT
    from aom_av1_lavish_torch.ops import kernels as K

    r, P = IT.FULLPEL_RADIUS, IT.PADR
    src = torch.from_numpy(cur)
    py = IT._edge_pad(torch.from_numpy(ref), P)
    py2 = IT._half_res(py)
    out = {}
    for name, s, p, bsz, o in (("full", src, py, 16, P - r),
                               ("half", IT._half_res(src), py2, 8,
                                P // 2 - r)):
        win = K.stride_windows(p, o, o, nby, nbx, bsz, 2 * r + bsz)
        blk = K.stride_windows(s, 0, 0, nby, nbx, bsz, bsz)
        s2, w2, c = K.ssd_sums_plain(blk, win, bsz, r)
        s2 = s2.expand_as(w2)
        out[name] = dict(
            surface=K.ssd_surface_plane(s, p, nby, nbx, bsz, r, o,
                                        o).numpy(),
            rounds=((s2 + w2) >= (1 << 24)).numpy(),
            exact=(s2 + w2 - 2 * c).to(torch.float32).numpy(),
            past=(((s2 | w2 | c) >> 24) != 0).numpy())
    y0 = torch.arange(nby).repeat_interleave(nbx) * 16
    x0 = torch.arange(nbx).repeat(nby) * 16
    dy, dx, cost = IT._fullpel_search(src, py, py2, y0, x0, nby, nbx)
    out["search"] = np.stack([dy.numpy(), dx.numpy(),
                              cost.numpy().astype(np.float64)], 1)
    return out, py.numpy(), py2.numpy()


def jax_surfaces(cur, py, py2, nby, nbx):
    import jax
    import jax.numpy as jnp

    from aom_av1_lavish_tpu.ops import inter_tpu as IJ

    r, P = IJ.FULLPEL_RADIUS, IJ.PADR
    B = nby * nbx
    y0 = jnp.asarray(np.repeat(np.arange(nby), nbx) * 16)
    x0 = jnp.asarray(np.tile(np.arange(nbx), nby) * 16)
    blk = jnp.asarray(cur).reshape(nby, 16, nbx, 16).transpose(0, 2, 1, 3) \
        .reshape(B, 16, 16).astype(jnp.int32)

    @jax.jit
    def run(blk, py, py2):
        full = IJ._ssd_surface(blk, py, y0, x0, 16, r, grid=(nby, nbx))
        src_h = blk.reshape(B, 8, 2, 8, 2).sum((2, 4))
        half = IJ._ssd_surface(src_h, py2, y0 // 2, x0 // 2, 8, r,
                               grid=(nby, nbx), pad=P // 2)
        dy, dx, cost = IJ._fullpel_search(blk, py, py2, y0, x0, 16,
                                          grid=(nby, nbx))
        return full, half, dy, dx, cost

    full, half, dy, dx, cost = (np.asarray(a) for a in run(
        blk, jnp.asarray(py), jnp.asarray(py2)))
    return dict(full=full, half=half,
                search=np.stack([dy, dx, cost.astype(np.float64)], 1))


def gop_pair(w, h):
    """The 4-frame GOP by both packages -> a line saying how they compare."""
    from aom_av1_lavish_torch.encoder.gop import GopEncoder
    from aom_av1_lavish_torch.ops import inter as IT
    from aom_av1_lavish_torch.utils.clips import make_frames
    from aom_av1_lavish_tpu.encoder.gop import GopEncoder as JGop
    from aom_av1_lavish_tpu.ops import inter_tpu as IJ
    from chip_smoke import first_group_difference

    frames = make_frames(4, w, h)
    kw = dict(qindex=120, gf_length=4, use_tpu=True, enable_cdef=False,
              cpu_used=8)
    out = []
    for enc_cls, chain_cls, extra in ((GopEncoder, IT.DeviceChainEncoder,
                                       dict(device="cpu")),
                                      (JGop, IJ.DeviceChainEncoder, {})):
        calls, orig = [], chain_cls.encode_chain

        def spy(self, *a, recon="last", _orig=orig, _calls=calls, **k):
            res = _orig(self, *a, recon="all", **k)
            _calls.append(res)
            return res

        chain_cls.encode_chain = spy
        try:
            payloads = enc_cls(w, h, **kw, **extra).encode_sequence(frames)
        finally:
            chain_cls.encode_chain = orig
        out.append((payloads, calls))
    (port, port_calls), (ref, ref_calls) = out
    a, b = b"".join(port), b"".join(ref)
    if a == b:
        return f"{w}x{h} 4-frame GOP, cpu_used 8: equal ({len(a)} bytes)"
    tu = next((i for i, (x, y) in enumerate(zip(port, ref)) if x != y),
              None)
    where = first_group_difference(port_calls, ref_calls, w,
                                   names=("port", "JAX"))
    return (f"{w}x{h} 4-frame GOP, cpu_used 8: the port's {len(a)} bytes "
            f"differ from the JAX package's {len(b)}, first in TU {tu}; "
            f"{where or 'chain results equal'}")


def argmins(surface, bias=None):
    flat = surface.reshape(len(surface), -1)
    if bias is not None:
        flat = flat + bias.reshape(1, -1)
    return flat.argmin(1)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", default="1920x1088")
    ap.add_argument("--gop", action="store_true",
                    help="also compare the two packages' 4-frame GOPs")
    opts = ap.parse_args()
    w, h = map(int, opts.size.split("x"))

    import torch
    torch.set_num_threads(max(1, min(4, os.cpu_count() or 1)))
    from aom_av1_lavish_torch.ops import inter as IT
    from aom_av1_lavish_torch.utils.clips import make_frames

    nby, nbx = h // 16, w // 16
    r = IT.FULLPEL_RADIUS
    ar = np.arange(2 * r + 1) - r
    bias = (IT.MV_COST_W * (np.abs(ar)[:, None] + np.abs(ar)[None, :])) \
        .astype(np.float32)
    frames = make_frames(2, w, h)
    for label, cur, ref in (
            ("own range", frames[1][0], frames[0][0]),
            ("stretched to 0..255", stretch(frames[1][0]),
             stretch(frames[0][0]))):
        port, py, py2 = port_surfaces(cur, ref, nby, nbx)
        ref_j = jax_surfaces(cur, py, py2, nby, nbx)
        print(f"{w}x{h} frames 0 -> 1, {label}: source luma mean "
              f"{cur.mean():.1f}, max {cur.max()}")
        for name in ("full", "half"):
            a, b = port[name]["surface"], ref_j[name]
            ia = argmins(a, bias if name == "full" else None)
            ib = argmins(b, bias if name == "full" else None)
            past = port[name]["past"]
            print(f"  {name} res: {a.size} entries, "
                  f"{int(port[name]['rounds'].sum())} with S2 + W2 >= 2^24, "
                  f"{int(past.sum())} with S2, W2 or C >= 2^24 (in "
                  f"{int(past.reshape(len(a), -1).any(1).sum())} of "
                  f"{len(a)} blocks); {int((a != b).sum())} differ from "
                  f"the JAX package's (max {float(np.abs(a - b).max()):g}; "
                  f"{int(((a != b) & ~past).sum())} of them order-free; "
                  f"the exact SSD differs in "
                  f"{int((port[name]['exact'] != b).sum())}); "
                  f"argmin{' with the MV bias' if name == 'full' else ''} "
                  f"differs in {int((ia != ib).sum())} blocks")
        d = port["search"] != ref_j["search"]
        print(f"  full-pel search result: (dy, dx) differs in "
              f"{int(d[:, :2].any(1).sum())} of {nby * nbx} blocks, the "
              f"cost in {int(d[:, 2].sum())}", flush=True)
    if opts.gop:
        print(gop_pair(w, h))
    return 0


if __name__ == "__main__":
    sys.exit(main())
