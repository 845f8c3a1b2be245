"""K2's share of its roofline on the softmax route (scVI's decoder): the
least time the chip needs for one energy gradient of the cell's trajectory
(``work.energy_grad_work`` over the cell's dims: each decoder's forward
and its chain back to the curve, once per point and decoder, whatever the
rung or the passes the route makes), at the peak of the rung the traffic
names, over the device time a step of every ``k2s_`` kernel in the trace.
None where no such kernel ran."""

from geobench import work

PATTERNS = ("k2s_",)


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
