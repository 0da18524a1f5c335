"""The control and the faults that the comparison deciding `correct` must
catch, planted under a run of the harness.

    python3 benchmark/tests/faults.py --workload <cell> --plant <name> \\
        --seconds <s> --seed <n> [--seed <n> ...]

runs the cell once a seed in one process with `name` planted (`none`:
the program as it is) and prints each run's compared numbers and
`correct`, one JSON line a seed.  The benchmark's own runs plant nothing.

- control: the P frames' reconstruction carried at 7 bits (each
  reconstructed sample's lowest bit dropped where the residual coding
  produces it, ops/inter._code_residual), the step a later change could
  take to pack the recon; the stream still says the full samples, so the
  decoder's frames drift from the encoder's.
- state_unchanged: a step that returns its state unchanged: the realtime
  step leaves its reference state as it was (every P frame predicts from
  the KEY), and the GOP encoder keeps its reference slots after every
  inter frame (the next group predicts from stale references).
- state_unchanged_late: the same, from later on only: the GOP encoder
  keeps its reference slots once the first GF group's 8 inter frames
  are stored (the second group predicts from stale references), and the
  realtime step leaves its state unchanged from the 12th P frame on.  The
  first coded frames of every stream are right, so only a comparison that
  reaches past them sees it.
- half_left_out: each encode codes the first half of its frames only.
- answer_altered: one byte of each stream's second temporal unit is
  altered where the stream is written (bitstream/ivf.write_ivf).
The exchange between chips has no fault to plant: every cell runs on one
chip.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time


@contextlib.contextmanager
def _patched(obj, name, value):
    orig = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield orig
    finally:
        setattr(obj, name, orig)


@contextlib.contextmanager
def plant(name: str):
    """Plants fault `name` in the port for the duration of the block."""
    if name == "none":
        yield
        return
    if name == "control":
        from aom_av1_lavish_torch.ops import inter
        orig = inter._code_residual

        def seven_bits(*a, **k):
            q, eob, rec, bits = orig(*a, **k)
            return q, eob, rec & 0xFE, bits

        with _patched(inter, "_code_residual", seven_bits):
            yield
        return
    if name == "state_unchanged":
        from aom_av1_lavish_torch.encoder.gop import GopEncoder
        from aom_av1_lavish_torch.ops.inter import DeviceRtEncoder
        step, store = DeviceRtEncoder.encode_frame_async, \
            GopEncoder._store_recon

        def frozen_step(self, src):
            state = self.state
            try:
                return step(self, src)
            finally:
                self.state = state

        def frozen_slots(self, enc, refresh_flags, fh):
            if fh.frame_type == 0:          # the KEY sets the slots once
                store(self, enc, refresh_flags, fh)

        with _patched(DeviceRtEncoder, "encode_frame_async", frozen_step), \
                _patched(GopEncoder, "_store_recon", frozen_slots):
            yield
        return
    if name == "state_unchanged_late":
        from aom_av1_lavish_torch.encoder.gop import GopEncoder
        from aom_av1_lavish_torch.ops.inter import DeviceRtEncoder
        step, store = DeviceRtEncoder.encode_frame_async, \
            GopEncoder._store_recon
        seen = {"stores": 0}

        def late_step(self, src):
            self._late_steps = getattr(self, "_late_steps", 0) + 1
            if self._late_steps < 12:
                return step(self, src)
            state = self.state
            try:
                return step(self, src)
            finally:
                self.state = state

        def late_slots(self, enc, refresh_flags, fh):
            if fh.frame_type == 0:          # a new stream starts
                seen["stores"] = 0
            elif seen["stores"] >= 8:
                return
            else:
                seen["stores"] += 1
            store(self, enc, refresh_flags, fh)

        with _patched(DeviceRtEncoder, "encode_frame_async", late_step), \
                _patched(GopEncoder, "_store_recon", late_slots):
            yield
        return
    if name == "half_left_out":
        from aom_av1_lavish_torch.encoder import gop, nonrd
        enc_gop, enc_rt = gop.encode_gop_ivf, nonrd.encode_realtime_tpu_ivf

        def halves(fn):
            def entry(path, frames, *a, **k):
                frames = list(frames)
                return fn(path, frames[:max(1, len(frames) // 2)], *a, **k)
            return entry

        with _patched(gop, "encode_gop_ivf", halves(enc_gop)), \
                _patched(nonrd, "encode_realtime_tpu_ivf", halves(enc_rt)):
            yield
        return
    if name == "answer_altered":
        from aom_av1_lavish_torch.bitstream import ivf
        write = ivf.write_ivf

        def altered(path, frames, *a, **k):
            frames = list(frames)
            if len(frames) > 1:
                data, pts = frames[1]
                i = len(data) // 2
                frames[1] = (data[:i] + bytes([data[i] ^ 0x5A])
                             + data[i + 1:], pts)
            return write(path, frames, *a, **k)

        with _patched(ivf, "write_ivf", altered):
            yield
        return
    raise ValueError(f"unknown plant {name!r}")


def main(argv=None) -> int:
    import argparse
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--plant", default="control")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    ap.add_argument("--device", default=None)
    opts = ap.parse_args(argv)
    from benchmark.harness import run_cell
    with plant(opts.plant):
        for i, seed in enumerate(opts.seed):
            result, lines, err = run_cell(
                opts.workload, seed, opts.seconds, False,
                t_start if i == 0 else time.perf_counter(),
                device=opts.device)
            print(json.dumps({"workload": opts.workload, "plant": opts.plant,
                              "seed": seed, "correct": result["correct"],
                              "compared": result["compared"],
                              "metrics": result["metrics"],
                              "lines": lines}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    for _name in ("jax", "jaxlib", "flax", "aom_av1_lavish_tpu"):
        sys.modules[_name] = None
    sys.exit(main())
