"""The fused dice/lava kernels' share of their roofline in a SOLOv2
training step, forward and backward together: each of the five levels'
least time at its ``max_positives`` slots (``work.dice_lava_least_s``;
the program runs the slots in chunks of the kernels' 128, which the
bound does not count), over both kernels' device time in the trace."""

from benchmark import trace, work

BOTH = ("dice_lava_fwd_kernel", "dice_lava_bwd_kernel")


def read(ctx):
    if ctx["kind"] != "solov2":
        return None
    calls, secs = trace.kernel_time(ctx["trace"], BOTH)
    d = ctx["dice_shape"]
    if not calls or secs <= 0:
        return None
    return 100.0 * work.dice_lava_least_s(d) * d["levels"] / secs
