"""What a traced run read, and the device side of it.

The traced part of a window runs under torch.profiler with the port's
profiler sections on (each utils/profiler section is then a profiler range
of the same name).  `Trace.from_profiler` keeps, on the profiler's clock
(microseconds): the traced window, each device operation (kernels, copies,
sets), and each host section.  `idle_gaps` and `top_device_ops` are frozen
copies of the port's bench_torch.idle_gaps and device_summary's top list;
busy time is the union of the device's intervals, not their sum.
"""

from __future__ import annotations

import dataclasses

#: the torch.profiler range the harness opens around the traced part
WINDOW_RANGE = "bench/window"
#: the name prefixes of the port's profiler sections and of the harness's
#: own ranges
SECTION_PREFIXES = ("gop/", "key/", "rdo/", "encode/", "bench/")
#: the device function(s) of each hand kernel, as the profiler names them
#: (the port's ops/csrc/*.cu), by family: K1, K2, K3, K4
DEVICE_FUNCS = {
    "gather_windows": ("gather_windows_kernel", "gather_flat_kernel",
                       "block_ssd_at_kernel"),
    "ssd_surface": ("ssd_plane_kernel", "ssd_surface_kernel"),
    "convolve_8tap": ("conv8_plane_kernel", "convolve_8tap_kernel"),
    "quantize_b_vec": ("quantize_b_kernel", "wave_encode_kernel",
                       "code_residual_kernel"),
}


def family(name: str):
    """The hand-kernel family of a device operation's name, or None."""
    return next((k for k, f in DEVICE_FUNCS.items()
                 if any(x in name for x in f)), None)


@dataclasses.dataclass
class Trace:
    """window: (start, end) of the traced part; device: (start, end, name)
    of each device operation; sections: (start, end, name) of each host
    section (all microseconds on the profiler's clock); spans: the
    harness's host spans by name, each (start, end) in seconds of
    time.perf_counter; counts: what the traced part did, by name (frames,
    frames of each kind, GF groups, ...); cell: the cell's configuration
    and traffic, as loaded."""
    window: tuple
    device: list
    sections: list
    spans: dict
    counts: dict
    cell: object = None

    @classmethod
    def from_profiler(cls, events, spans, counts, cell=None):
        from torch.autograd import DeviceType

        window, device, sections = None, [], []
        for ev in events:
            span = (ev.time_range.start, ev.time_range.end)
            if ev.device_type == DeviceType.CUDA:
                # a range mirrored on the device timeline repeats its
                # kernels' time
                if ev.name.startswith(SECTION_PREFIXES):
                    continue
                device.append(span + (ev.name,))
            elif ev.name == WINDOW_RANGE:
                window = span
            elif ev.name.startswith(SECTION_PREFIXES):
                sections.append(span + (ev.name,))
        if window is None:
            raise RuntimeError(f"the trace has no {WINDOW_RANGE} range")
        inside = [d for d in device if d[1] > window[0] and d[0] < window[1]]
        return cls(window, inside, sections, spans, counts, cell)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_s(self) -> float:
        """Seconds in which at least one device operation ran, inside the
        traced window: the union of the intervals."""
        return union_us(self.device, self.window) / 1e6

    def section_s(self, *names) -> float:
        """Summed seconds of the host sections of these names."""
        return sum(e - s for s, e, n in self.sections if n in names) / 1e6


def union_us(intervals, clip=None) -> float:
    """Length of the union of (start, end, ...) intervals, clipped to
    `clip` = (start, end) when given."""
    spans = sorted((max(s, clip[0]), min(e, clip[1])) if clip else (s, e)
                   for s, e, *_ in intervals)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(busy, sections, window=None, n: int = 10) -> list:
    """The n longest stretches in which nothing ran on the device, longest
    first.  `busy`: (start, end) of each device operation; `sections`:
    (start, end, name) of each host section, on the same clock (us);
    `window`: (start, end) of the run, whose lead-in and tail count as
    stretches too.  Each stretch is labelled with the innermost section
    (the latest to open) open at its midpoint, "none" when none is ->
    [[label, seconds]]."""
    spans = sorted(busy)
    gaps = []
    if window is not None and spans:
        gaps.append((window[0], spans[0][0]))
    end = spans[0][1] if spans else None
    for s, e in spans[1:]:
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    if window is not None and spans:
        gaps.append((end, window[1]))
    gaps = sorted((g for g in gaps if g[1] > g[0]),
                  key=lambda g: g[0] - g[1])[:n]
    out = []
    for s, e in gaps:
        mid = (s + e) / 2
        inner = max((r for r in sections if r[0] <= mid < r[1]),
                    key=lambda r: r[0], default=None)
        out.append([inner[2] if inner else "none", (e - s) / 1e6])
    return out


def top_device_ops(device, n: int = 10) -> list:
    """The n device operations that took the most time -> [(name,
    seconds)]."""
    by_name = {}
    for s, e, name in device:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
    return [[k, v / 1e6] for k, v in top]


def breakdown(trace: Trace) -> dict:
    """The result line's breakdown: top device operations and the longest
    idle gaps, each labelled with the innermost host section."""
    return {"device_ops": top_device_ops(trace.device),
            "idle_gaps": idle_gaps([(s, e) for s, e, _ in trace.device],
                                   trace.sections, trace.window)}
