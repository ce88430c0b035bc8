"""The DCN input-gradient scatter's share of its roofline in a SOLOv2
training step, backbone and instance towers together: each call's least
time (``work.scatter_least_s``), summed over the launches of a step,
over the kernel's device time in the trace."""

from benchmark import trace, work

KERNELS = ("dcn_scatter_kernel",)


def read(ctx):
    if ctx["kind"] != "solov2":
        return None
    calls, secs = trace.kernel_time(ctx["trace"], KERNELS)
    layers = ctx["dcn_shapes"]
    if not calls or secs <= 0 or not layers:
        return None
    least = sum(work.scatter_least_s(s) for s in layers) * calls / len(layers)
    return 100.0 * least / secs
