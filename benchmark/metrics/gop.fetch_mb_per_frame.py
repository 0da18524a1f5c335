"""Bytes copied from the device to the host: the port's counter
fetch_bytes (utils/profiler.counters(), counted only while the sections
are on, so over the traced part) in MB (1e6 bytes) per frame traced.
A port without the counter reads nothing."""


def read(trace):
    from aom_av1_lavish_torch.utils import profiler
    frames = trace.counts.get("frames", 0)
    counters = getattr(profiler, "counters", None)
    if not frames or counters is None:
        return None
    fetched = counters().get("fetch_bytes", 0)
    return fetched / 1e6 / frames if fetched else None
