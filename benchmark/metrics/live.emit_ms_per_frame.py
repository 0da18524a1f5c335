"""The realtime path's host emit: mean host milliseconds of each
TpuInterFrameEncoder.encode_frame call in the traced part (a spy's
span: the wait for the frame's result rows, the native tile walk and the
frame's OBU)."""


def read(trace):
    spans = trace.spans.get("emit") or []
    if not spans:
        return None
    return sum(e - s for s, e in spans) * 1e3 / len(spans)
