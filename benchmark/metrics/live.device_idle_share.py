"""The device's idle share of the traced window, in percent: 1 - the
union of the device operations' intervals over the window's length
(torch.profiler)."""


def read(trace):
    if not trace.device or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
