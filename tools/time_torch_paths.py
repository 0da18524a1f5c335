#!/usr/bin/env python3
"""Times the GOP encode of the PyTorch/CUDA port in one checkout, for
comparing two commits on one card inside one command.

    python3 tools/time_torch_paths.py <root of a checkout>

Builds that checkout's kernels and encodes its 8-frame clips with its
TorchGopEncoder on the GPU: 1920x1088 at cpu_used 8, in the default
configuration and in the default configuration with frame-parallel groups
(FPMT; 3 runs each), 720x576 default (2 runs; the first builds the
device-RDO weight matrices) and 352x288 default (3 runs).  Prints one line
`PAIR {json}` with (seconds, bytes, seconds of the gop/chain_device stage,
peak device memory in MiB) per run, device synchronized.  Run it
once per checkout as its own process, in turns (parent, change, change,
parent): two calls may land on hosts of different speed, so only runs of
one command compare.  Imports neither jax nor the JAX package."""

import json
import os
import sys
import time


def main() -> int:
    root = os.path.abspath(sys.argv[1])
    os.chdir(root)
    sys.path.insert(0, root)
    sys.modules["jax"] = None
    sys.modules["aom_av1_lavish_tpu"] = None
    import torch

    import chip_smoke as cs
    from aom_av1_lavish_torch.encoder.gop import TorchGopEncoder
    from aom_av1_lavish_torch.ops import build
    from aom_av1_lavish_torch.utils import profiler
    from aom_av1_lavish_torch.utils.clips import make_frames

    if not torch.cuda.is_available():
        print("time_torch_paths: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    build.build()

    def gop(w, h, kw, frames):
        profiler.enable()
        profiler.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        enc = TorchGopEncoder(w, h, device=dev, **kw)
        payloads = enc.encode_sequence(frames)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        chain = profiler.times().get("gop/chain_device")
        profiler.enable(False)
        return (secs, sum(map(len, payloads)), chain,
                torch.cuda.max_memory_allocated() / 2**20)

    out = {"root": sys.argv[1]}
    for label, w, h, kw, runs in (
            ("1080p cpu_used 8", 1920, 1088, cs.KW_CPU8, 3),
            ("1080p default", 1920, 1088, cs.KW_DEFAULT, 3),
            ("1080p FPMT", 1920, 1088, cs.KW_FPMT, 3),
            ("720x576 default", 720, 576, cs.KW_DEFAULT, 2),
            ("352x288 default", 352, 288, cs.KW_DEFAULT, 3)):
        frames = make_frames(8, w, h)
        out[label] = [gop(w, h, kw, frames) for _ in range(runs)]
    print("PAIR " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
