"""The data-parallel step's share of the cards' TF32 peak: the operations
of an image's forward and backward (``work.model_flops``, from the cell's
shapes) times the window's images per second over every rank, over 495
TFLOP/s a card times the cards."""


def read(ctx):
    if ctx["kind"] != "train_dp" or not ctx["rate_img_per_s"]:
        return None
    return (100.0 * ctx["flops_per_img"] * ctx["rate_img_per_s"]
            / (ctx["world"] * ctx["peaks"]["tf32_flops_per_s"]))
