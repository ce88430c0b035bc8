"""Mean synchronised host time of ``trainer.apply_grads`` (the read of
the loss's finiteness, the gradients' clipping and SGD) over the span
steps, called as ``trainer.train_step`` calls it."""


def read(ctx):
    spans = ctx["spans"].get("apply_grads") if ctx["kind"] == "solov2" \
        else None
    return 1e3 * sum(spans) / len(spans) if spans else None
