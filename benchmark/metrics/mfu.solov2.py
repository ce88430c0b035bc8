"""The whole SOLOv2 training step's share of the card's TF32 peak: the
operations of an image's forward and backward
(``reference/solov2.py::flops_per_image``, from the cell's shapes and
the positives its batches hold; the frozen stages' backward, which does
not run, and the dice's padding slots not counted) times the
window's images per second, over 495 TFLOP/s."""


def read(ctx):
    if ctx["kind"] != "solov2" or not ctx["rate_img_per_s"]:
        return None
    return (100.0 * ctx["flops_per_img"] * ctx["rate_img_per_s"]
            / ctx["peaks"]["tf32_flops_per_s"])
