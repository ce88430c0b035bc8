"""Mean synchronised host time of ``ops.postprocess.postprocess_batch``
over the span requests, called as ``PlaneRecNetRunner.infer`` calls it."""


def read(ctx):
    spans = ctx["spans"].get("postprocess") if ctx["kind"] == "serve" \
        else None
    return 1e3 * sum(spans) / len(spans) if spans else None
