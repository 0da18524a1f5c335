"""How often the recode loop coded an anchor again: the port's counters
recode_attempts/key and recode_attempts/arf (GopEncoder._recode adds 1
for each encode after a frame's first, 0 for a frame it did not recode;
counted only while the sections are on, so over the traced part) over
the KEYs and ARFs traced.  A port without the counters reads nothing."""


def read(trace):
    from aom_av1_lavish_torch.utils import profiler
    anchors = trace.counts.get("keys", 0) + trace.counts.get("arfs", 0)
    counters = getattr(profiler, "counters", None)
    if not anchors or counters is None:
        return None
    got = counters()
    names = ("recode_attempts/key", "recode_attempts/arf")
    if not any(k in got for k in names):
        return None
    return sum(got.get(k, 0) for k in names) / anchors
