"""How much of the encode's copies to the host landed in pinned memory:
100 x the port's counter fetch_pinned_bytes (the bytes of each copy from
the card into pinned host memory; nothing is counted on the CPU) over its
counter fetch_bytes (every byte copied to the host), both counted only
while the sections are on, so over the traced part.  A port without the
pinned counter reads nothing."""


def read(trace):
    from aom_av1_lavish_torch.utils import profiler
    counters = getattr(profiler, "counters", None)
    if counters is None:
        return None
    got = counters()
    fetched, pinned = got.get("fetch_bytes"), got.get("fetch_pinned_bytes")
    if not fetched or pinned is None:
        return None
    return 100.0 * pinned / fetched
