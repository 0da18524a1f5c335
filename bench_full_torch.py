#!/usr/bin/env python3
"""Benchmark matrix of the PyTorch/CUDA port (aom_av1_lavish_torch) on one
GPU; the counterpart of bench_full.py.

    python3 bench_full_torch.py [CELL ...]

Runs every cell of bench_torch.CELLS (or the ones named), each in a
process of its own through bench_torch's runner, so that each cell's cold
run is the first run of its process and no cell inherits another's
captured programs or their memory pools.  A cell's record is
bench_torch's: a cold run, warm runs (5; one for the host-bound speed
ladder and CPU-backend cells), the median, range and spread of the warm
runs, the bytes every run wrote, the Y PSNR of the stream decoded once by
the port's decoder, the stage medians, launches and peak device memory.
Each record is printed as it is made and the list is written to
build/bench_full_torch.json after each cell, as bench_full.py writes its
records.  The cells:

  - bench_full.py's rows that the port has a path for: lossless all-intra
    (with the batched analyze's and the native walk's ms a frame),
    all-intra, device-RDO all-intra, the inter GOP at 352x288, 1280x720 and
    1920x1088, the same 720p GOP on the card's host CPU (`device="cpu"`,
    in its process under a timeout, with the card's frames/s over the
    CPU's), realtime on the device at 352x288 and 1920x1088 and the host's
    non-RD realtime, the port's decoder on the lossless stream, and the
    host GOP path's speed ladder at cpu_used 2, 5 and 8;
  - the ones that PERF.md read by hand and bench_full.py lacks: the 1080p
    GOP of bench.py in the default configuration, at cpu_used 8 and with
    frame-parallel groups (FPMT), low delay and realtime at 1080p (ms per
    P frame), two-pass at 1080p and the default GOP at 720x576 (the
    device-RDO KEY).

FPMT's P frames reference the fixed LAST frame, the chain's the previous
frame, so their streams differ: the two 1080p records' frames/s, bytes and
PSNR are printed side by side at the end.

Left out of bench_full.py: the BD-rate sweep (bench_full.py:295-308) and
the aomdec validation (:310-338), since neither aomenc nor aomdec is on
the card's machine (the decode every cell runs with the port's decoder
stands in for the validation), and the v5e utilization records (:199-212),
since a codec runs no model.

Exits non-zero without a CUDA device, and when a cell failed (its record
then carries "error"; a cell that ran past its time limit says so).
Imports neither jax nor the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from bench_torch import CELLS, gpu_line, log, run_child

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "build", "bench_full_torch.json")
#: seconds a cell's process may take: the CPU-backend cell runs two 8-frame
#: 720p GOPs on the host (4 1080p frames took about a minute there)
TIMEOUT = 900
TIMEOUT_CPU = 1500
#: (frames/s on the card, the same GOP on the CPU)
CARD_VS_CPU = ("inter_gop_1280x720", "inter_gop_cpu_backend_1280x720")
CHAIN_VS_FPMT = ("gop_1080p_default", "gop_1080p_fpmt")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("cells", nargs="*", metavar="CELL",
                    help="cells to run (all when none is named)")
    opts = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("bench_full_torch: no CUDA device (torch.cuda.is_available() "
              "is False)", file=sys.stderr)
        return 2
    names = opts.cells or list(CELLS)
    unknown = [n for n in names if n not in CELLS]
    if unknown:
        ap.error(f"unknown cells {unknown}; cells: {sorted(CELLS)}")
    card = gpu_line()
    log(f"card: {card}")
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    results = []
    by_name = {}
    for name in names:
        rec = run_child(ROOT, name, timeout=TIMEOUT_CPU
                        if CELLS[name].device == "cpu" else TIMEOUT)
        if name == CARD_VS_CPU[1] and rec.get("value") \
                and by_name.get(CARD_VS_CPU[0], {}).get("value"):
            rec["card_over_cpu"] = by_name[CARD_VS_CPU[0]]["value"] \
                / rec["value"]
        results.append(rec)
        by_name[name] = rec
        with open(OUT, "w") as f:
            json.dump(results, f, indent=1)
        log(json.dumps(rec))
        peak = rec.get("peak_mib") or {}
        log(f"cell {name}: {rec.get('value')} {rec.get('unit', '')}; "
            f"device memory reserved {peak.get('reserved')} MiB")
    if all(n in by_name for n in CHAIN_VS_FPMT):
        for n in CHAIN_VS_FPMT:
            r = by_name[n]
            log(f"chain vs FPMT: {n:<20} {r.get('value')} frames/s, "
                f"{r.get('bytes')} bytes, Y PSNR {r.get('psnr_y')} dB")
    log(f"records: {os.path.relpath(OUT, ROOT)}")
    failed = [r["metric"] for r in results if "error" in r]
    if failed:
        print(f"bench_full_torch: cells failed: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    # any import of jax or of the JAX package now raises ImportError
    sys.modules["jax"] = None
    sys.modules["aom_av1_lavish_tpu"] = None
    sys.exit(main())
