"""Component timing / tracing (aux subsystem).

Re-designs the reference's component-time taxonomy
(av1/encoder/encoder.h COMPONENT_TYPE + start_timing/end_timing under
CONFIG_INTERNAL_STATS, and aom_usec_timer) as a process-wide registry
of named sections:

    from aom_av1_lavish_torch.utils.profiler import profile, report, enable
    enable()
    with profile("encode/partition_search"):
        ...
    print(report())

Sections nest; disabled (default) the context manager costs one
attribute check.  Device work should be timed around synchronize
points by the caller (CUDA launches are asynchronous).  An enabled
section is also a torch.profiler range of the same name, which puts it on
the timeline of the device's kernels.  Counters (count, counters), such
as the bytes copied to the host, are kept in the same registry: only
while enabled, and cleared by reset.  Sections pair by order: on the
realtime path the k-th encode/rt_step pairs with the k-th
encode/rt_realize, so no section carries an identifier.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

import torch

_ENABLED = False
_TIMES: dict = defaultdict(float)
_COUNTS: dict = defaultdict(int)
_COUNTERS: dict = defaultdict(int)


def enable(on: bool = True) -> None:
    global _ENABLED
    _ENABLED = on


def reset() -> None:
    _TIMES.clear()
    _COUNTS.clear()
    _COUNTERS.clear()


def count(name: str, n: int = 1) -> None:
    if _ENABLED:
        _COUNTERS[name] += n


def counters() -> dict:
    return dict(_COUNTERS)


@contextmanager
def profile(name: str):
    if not _ENABLED:
        yield
        return
    t0 = time.perf_counter()
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        _TIMES[name] += time.perf_counter() - t0
        _COUNTS[name] += 1


def times() -> dict:
    return dict(_TIMES)


def report() -> str:
    """Sorted table of section totals (internal-stats printout)."""
    if not _TIMES:
        return "(no profile data; call profiler.enable() first)"
    total = sum(v for k, v in _TIMES.items() if "/" not in k) or \
        sum(_TIMES.values())
    lines = ["section                                   time(s)   calls"]
    for k in sorted(_TIMES, key=_TIMES.get, reverse=True):
        lines.append(f"{k:<40} {_TIMES[k]:8.3f} {_COUNTS[k]:7d}")
    lines.append(f"{'TOTAL(top-level)':<40} {total:8.3f}")
    return "\n".join(lines)
