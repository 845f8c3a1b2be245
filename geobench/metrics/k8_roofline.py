"""K8's share of its roofline: the least time the chip needs for one
Monte-Carlo energy gradient (``work.energy_grad_work`` over the decoders
the draws need, ``work.drawn_decoders``: 3.439 of 10 at two samples), at
the peak of the rung the traffic names, over K8's device time per step."""

from geobench import work

PATTERNS = ("mc_select", "mc_chain", "mc_segments")


def read(ctx):
    trace = ctx.get("trace")
    if ctx.get("kind") != "optimize" or trace is None or not trace.steps:
        return None
    seconds = trace.device_seconds(PATTERNS) / trace.steps
    if seconds <= 0:
        return None
    flops, n_bytes = ctx["grad_work"]
    bound = work.bound_seconds(flops, n_bytes, work.RUNG_PEAK[ctx["rung"]])
    return 100.0 * bound / seconds
