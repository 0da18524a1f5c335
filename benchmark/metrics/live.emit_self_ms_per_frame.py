"""The realtime emit's own time: host milliseconds of the port's
sections encode/rt_emit less the union of the sections each encloses
(the wait for the rows, the tile walk, the filter search), per traced
step: the frame header, the encoder's set-up, the padding and the OBU."""

from benchmark.trace import union_us


def read(trace):
    steps = trace.counts.get("steps", 0)
    emits = [(s, e) for s, e, n in trace.sections if n == "encode/rt_emit"]
    if not steps or not emits:
        return None
    own = 0.0
    for a, b in emits:
        inner = [(s, e) for s, e, n in trace.sections
                 if n != "encode/rt_emit" and a <= s and e <= b]
        own += (b - a) - union_us(inner)
    return own / 1e3 / steps
