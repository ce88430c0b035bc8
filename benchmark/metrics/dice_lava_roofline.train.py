"""The fused dice/lava loss kernels' share of their roofline in a
training step, forward and backward together: each level's least time
(``work.dice_lava_least_s``), times the forward launches of a step over
the levels, over both kernels' device time in the trace."""

from benchmark import trace, work

FORWARD = ("dice_lava_fwd_kernel",)
BOTH = ("dice_lava_fwd_kernel", "dice_lava_bwd_kernel")


def read(ctx):
    if ctx["kind"] != "train":
        return None
    calls, _ = trace.kernel_time(ctx["trace"], FORWARD)
    _, secs = trace.kernel_time(ctx["trace"], BOTH)
    d = ctx["dice_shape"]
    if not calls or secs <= 0:
        return None
    return 100.0 * work.dice_lava_least_s(d) * calls / secs
