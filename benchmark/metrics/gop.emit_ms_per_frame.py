"""The host emit and native entropy coder: host milliseconds of the
port's sections gop/emit (the chained P frames) and key/emit (the KEY)
per frame traced."""


def read(trace):
    frames = trace.counts.get("frames", 0)
    s = trace.section_s("gop/emit", "key/emit")
    if not frames or not s:
        return None
    return s * 1e3 / frames
