"""The KEY (wavefront, deblock, unpack, emit): host milliseconds of the
port's section gop/key per KEY traced."""


def read(trace):
    keys = trace.counts.get("keys", 0)
    s = trace.section_s("gop/key")
    if not keys or not s:
        return None
    return s * 1e3 / keys
