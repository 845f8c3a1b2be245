"""Share of the traced chunk's wall time in which no device operation ran
(one minus the union of their intervals over the window)."""


def read(ctx):
    trace = ctx.get("trace")
    if ctx.get("kind") != "optimize" or trace is None or trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
