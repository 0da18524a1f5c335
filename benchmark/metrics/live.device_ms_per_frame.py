"""The realtime step on the device: milliseconds in which any device
operation ran (the union of their intervals in the traced window) per
frame of the stream traced."""


def read(trace):
    frames = trace.counts.get("frames", 0)
    busy = trace.busy_s()
    if not frames or not busy:
        return None
    return busy * 1e3 / frames
