"""Device ms a step of the NCCL kernels on rank 0's card (every kernel
whose name holds ``nccl``: DDP's gradient all-reduces, SyncBatchNorm's
statistics, the losses' sums), from the trace."""

from benchmark import trace

KERNELS = ("nccl",)


def read(ctx):
    if ctx["kind"] != "train_dp":
        return None
    calls, secs = trace.kernel_time(ctx["trace"], KERNELS)
    return 1e3 * secs if calls else None
