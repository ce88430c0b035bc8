"""Share of the traced SOLOv2 training steps in which no operation ran on
the card (``torch.profiler``'s device events, over the benchmark's
window)."""


def read(ctx):
    s = ctx["trace"]
    if ctx["kind"] != "solov2" or s["window_s"] <= 0 or s["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
