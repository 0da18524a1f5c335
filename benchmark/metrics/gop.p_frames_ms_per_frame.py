"""The P-frame programs: host milliseconds of the port's sections
gop/chain_device (the chain, ending in its copy to the host) and
gop/arf_encode (the ARF's program and its emit) per inter frame traced
(the ARF and the chained P frames)."""


def read(trace):
    inter = trace.counts.get("inter", 0)
    s = trace.section_s("gop/chain_device", "gop/arf_encode")
    if not inter or not s:
        return None
    return s * 1e3 / inter
