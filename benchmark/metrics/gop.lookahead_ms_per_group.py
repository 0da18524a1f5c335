"""TPL and the ARF's temporal filter: host milliseconds of the port's
sections gop/tpl and gop/temporal_filter (each ends in a copy to the
host, so it holds its device work) per GF group traced."""


def read(trace):
    groups = trace.counts.get("groups", 0)
    s = trace.section_s("gop/tpl", "gop/temporal_filter")
    if not groups or not s:
        return None
    return s * 1e3 / groups
