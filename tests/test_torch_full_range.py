"""ROADMAP Queue 3, F1, at 352x288: the bench clip stretched to full range
(luma 0..255), encoded on the CPU by the port and by the JAX package.

The JAX package's SSD surface rounds its float32 sum S2 + W2 where it
passes 2^24 (bright content), and the port's rounds as it does wherever
that rounding does not depend on the order of summation.  The streams
must be equal; on a difference the test names the first differing byte
of the stream and the first chained P-frame result that differs (group
call, frame, array, block and row field, both values).  About 100 s of
CPU time, mostly the JAX package's compiles and encode: marked `slow`, out
of tier-1 (`-m 'not slow'`); run it with

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_full_range.py -s
"""

import pytest
import torch

jax = pytest.importorskip("jax")

from aom_av1_lavish_tpu.encoder.gop import GopEncoder as JGop  # noqa: E402
from aom_av1_lavish_tpu.ops import inter_tpu as JI  # noqa: E402
from aom_av1_lavish_torch.encoder.gop import GopEncoder  # noqa: E402
from aom_av1_lavish_torch.ops import inter as IT  # noqa: E402
from chip_smoke import first_group_difference  # noqa: E402
from chip_smoke import full_range_frames  # noqa: E402

W, H, N = 352, 288, 8
KW = dict(qindex=120, gf_length=8, use_tpu=True, enable_cdef=False,
          cpu_used=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _encode(enc_cls, cls, **kw):
    """The stream and every chain call's (raws, recons), each recon
    fetched."""
    calls = []
    orig = cls.encode_chain

    def spy(self, *a, recon="last", **k):
        out = orig(self, *a, recon="all", **k)
        calls.append(out)
        return out

    cls.encode_chain = spy
    try:
        payloads = enc_cls(W, H, **KW, **kw).encode_sequence(
            full_range_frames(N, W, H))
    finally:
        cls.encode_chain = orig
    return payloads, calls


@pytest.mark.slow
def test_full_range_352x288_port_against_jax_package():
    clip = full_range_frames(N, W, H)
    assert max(int(f[0].max()) for f in clip) == 255
    port, port_raws = _encode(GopEncoder, IT.DeviceChainEncoder,
                              device="cpu")
    ref, ref_raws = _encode(JGop, JI.DeviceChainEncoder)
    assert len(port) == len(ref) == N and all(port) and all(ref)
    a, b = b"".join(port), b"".join(ref)
    if a == b:
        print(f"F1 at {W}x{H}, full range: equal ({len(a)} bytes)")
        return
    at = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
              min(len(a), len(b)))
    tu = next(i for i, (x, y) in enumerate(zip(port, ref)) if x != y)
    where = first_group_difference(port_raws, ref_raws, W,
                                   names=("port", "JAX"))
    pytest.fail(f"F1 at {W}x{H}, full range: the port's {len(a)} bytes "
                f"differ from the JAX package's {len(b)} first at byte {at} "
                f"(TU {tu}); {where or 'chain results equal'}")
