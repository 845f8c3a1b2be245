"""The optimizer's model FLOPs over the traced chunk's wall time, as a
share of the bf16 dense peak: every trajectory step's energy gradient and
the chunk's final energy pass, counted from the shapes (``work``)."""

from geobench import work


def read(ctx):
    trace = ctx.get("trace")
    if ctx.get("kind") != "optimize" or trace is None or not trace.steps:
        return None
    flops = ctx["grad_work"][0] * trace.steps + ctx["final_work"][0]
    return 100.0 * flops / trace.window_s / work.PEAK_FLOPS["bfloat16"]
