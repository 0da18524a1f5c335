"""The realtime pipeline's hold of a frame: mean milliseconds from the
end of a P frame's step (the port's section encode/rt_step: upload,
program replay, the copy's enqueue) to the start of the wait for its rows
(encode/rt_realize), over the traced P frames.  The pipeline is one frame
deep, so the k-th step pairs with the k-th realize."""


def read(trace):
    steps = sorted(e for s, e, n in trace.sections if n == "encode/rt_step")
    waits = sorted(s for s, e, n in trace.sections
                   if n == "encode/rt_realize")
    holds = [w - e for e, w in zip(steps, waits)]
    if not holds:
        return None
    return sum(holds) / len(holds) / 1e3
