"""Launch calls the host made per optimizer step in the traced chunk
(``profiling.LAUNCH_CALLS``, runtime events of the trace)."""


def read(ctx):
    trace = ctx.get("trace")
    if ctx.get("kind") != "optimize" or trace is None or not trace.launches:
        return None
    return trace.launches / trace.steps
