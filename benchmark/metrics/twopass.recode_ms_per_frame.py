"""The recode loop of a two-pass encode: host milliseconds of the port's
section gop/recode (each encode of a KEY or an ARF after its first, and
the final one at the winning q) per frame traced; 0 where the loop ran
(its counters recode_attempts/* are there) and recoded nothing.  A port
without the section and the counters reads nothing."""


def read(trace):
    from aom_av1_lavish_torch.utils import profiler
    frames = trace.counts.get("frames", 0)
    s = trace.section_s("gop/recode")
    counters = getattr(profiler, "counters", None)
    ran = counters is not None and any(
        k.startswith("recode_attempts/") for k in counters())
    if not frames or not (s or ran):
        return None
    return s * 1e3 / frames
