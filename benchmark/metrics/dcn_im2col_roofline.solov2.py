"""The deformable sampling kernel's share of its roofline in a SOLOv2
training step, backbone and instance towers together: each sampling's
least time at its call's shapes (``work.im2col_least_s``; the towers' at
each of the five levels), summed over the launches of a step, over the
kernel's device time in the trace."""

from benchmark import trace, work

KERNELS = ("dcn_im2col_kernel",)


def read(ctx):
    if ctx["kind"] != "solov2":
        return None
    calls, secs = trace.kernel_time(ctx["trace"], KERNELS)
    layers = ctx["dcn_shapes"]
    if not calls or secs <= 0 or not layers:
        return None
    least = sum(work.im2col_least_s(s) for s in layers) * calls / len(layers)
    return 100.0 * least / secs
