"""The deformable sampling kernel's share of its roofline in a request:
each sampling's least time at its layer's shapes
(``work.im2col_least_s``), summed over the launches of a request, over the
kernel's device time in the trace."""

from benchmark import trace, work

KERNELS = ("dcn_im2col_kernel",)
KIND = "serve"


def read(ctx):
    if ctx["kind"] != KIND:
        return None
    calls, secs = trace.kernel_time(ctx["trace"], KERNELS)
    layers = ctx["dcn_shapes"]
    if not calls or secs <= 0 or not layers:
        return None
    least = sum(work.im2col_least_s(s) for s in layers) * calls / len(layers)
    return 100.0 * least / secs
