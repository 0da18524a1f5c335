"""How often the realtime emit found a P frame's rows still on their way:
100 x the port's counter rt_rows_waited (DeviceRtEncoder.realize on the
card adds 1 when the copy's event had not completed as the rows were asked
for, else 0; counted only while the sections are on, so over the traced
part) over the traced steps.  A port without the counter reads nothing."""


def read(trace):
    from aom_av1_lavish_torch.utils import profiler
    steps = trace.counts.get("steps", 0)
    counters = getattr(profiler, "counters", None)
    if not steps or counters is None:
        return None
    waited = counters().get("rt_rows_waited")
    return None if waited is None else 100.0 * waited / steps
