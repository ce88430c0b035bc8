"""The whole request's share of the card's TF32 peak: the model's
operations for an image's forward (``work.model_flops``, from
the cell's shapes) times the window's images per
second, over 495 TFLOP/s."""


def read(ctx):
    if ctx["kind"] != "serve" or not ctx["rate_img_per_s"]:
        return None
    return (100.0 * ctx["flops_per_img"] * ctx["rate_img_per_s"]
            / ctx["peaks"]["tf32_flops_per_s"])
