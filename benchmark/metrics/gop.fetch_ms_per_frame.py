"""The device's time copying to the host for the encode's fetches:
milliseconds of the union of the device's `Memcpy DtoH` intervals,
clipped to the port's sections encode/fetch and key/fetch (on the
profiler's shared clock), per frame traced."""

from benchmark.trace import union_us


def merged(spans):
    """(start, end) spans -> their union as sorted disjoint spans."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read(trace):
    frames = trace.counts.get("frames", 0)
    copies = [d for d in trace.device if d[2].startswith("Memcpy DtoH")]
    fetches = merged((s, e) for s, e, n in trace.sections
                     if n in ("encode/fetch", "key/fetch"))
    if not frames or not copies or not fetches:
        return None
    return sum(union_us(copies, f) for f in fetches) / 1e3 / frames
