"""The hand kernels K1-K4 against their roofline: the least time the
card could take for the work the traced frames need (benchmark/work.py,
counted from the frame size and each frame's kind) over the device time
of the kernels of the four hand-kernel families, in percent."""

from benchmark.trace import family
from benchmark.work import bound_s


def read(trace):
    work = trace.counts.get("work")
    busy = sum(e - s for s, e, name in trace.device if family(name))
    if not work or not busy:
        return None
    return 100.0 * bound_s(work) / (busy / 1e6)
