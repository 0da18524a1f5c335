"""The native tile walk of the realtime path's P frames: host
milliseconds of the port's sections encode/tile_walk that lie inside a
P frame's emit (encode/rt_emit; the KEY's walk is left out) per traced
step."""


def read(trace):
    steps = trace.counts.get("steps", 0)
    emits = [(s, e) for s, e, n in trace.sections if n == "encode/rt_emit"]
    walks = [e - s for s, e, n in trace.sections
             if n == "encode/tile_walk"
             and any(a <= s and e <= b for a, b in emits)]
    if not steps or not walks:
        return None
    return sum(walks) / 1e3 / steps
