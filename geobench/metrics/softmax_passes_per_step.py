"""Passes over the G output columns of every (point, decoder) row that K2's
softmax route made per optimizer step in the window: the change of the
port's counter ``ops.energy_fused.SOFTMAX_PASSES["energy_bwd"]`` over the
window's steps (one K2 call a step).  None where the route never ran."""


def read(ctx):
    if ctx.get("kind") != "optimize" or not ctx.get("softmax_passes"):
        return None
    return ctx["softmax_passes"] / ctx["window_steps"]
