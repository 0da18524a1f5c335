"""The first pass of a two-pass encode: host milliseconds of the port's
section gop/first_pass (every frame's surface and sums, ending in their
copy to the host) per frame traced.  A port without the section reads
nothing."""


def read(trace):
    frames = trace.counts.get("frames", 0)
    s = trace.section_s("gop/first_pass")
    if not frames or not s:
        return None
    return s * 1e3 / frames
