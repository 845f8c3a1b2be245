"""Energy kernels launched per optimizer step: the change over the window
of the port's own counters (``ops.energy_fused.LAUNCHES``, one per wrapper
call that launched a kernel), over the window's steps."""


def read(ctx):
    if ctx.get("kind") != "optimize" or not ctx.get("energy_launches"):
        return None
    return ctx["energy_launches"] / ctx["window_steps"]
