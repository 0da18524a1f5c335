"""The native tile walk of the inter frames (the ARF and the chained P
frames): host milliseconds of the port's sections encode/tile_walk that
lie outside the KEY (gop/key) per inter frame traced."""


def read(trace):
    inter = trace.counts.get("inter", 0)
    keys = [(s, e) for s, e, n in trace.sections if n == "gop/key"]
    walks = [e - s for s, e, n in trace.sections
             if n == "encode/tile_walk"
             and not any(a <= s and e <= b for a, b in keys)]
    if not inter or not walks:
        return None
    return sum(walks) / 1e3 / inter
