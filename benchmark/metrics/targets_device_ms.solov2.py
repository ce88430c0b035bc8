"""Device ms a step under the program's ``loss.targets`` span (the
target assignment over the five levels and 80 classes inside the loss),
from ``benchmark/spans.py::train``'s table; none where the program has
no such span."""


def read(ctx):
    row = ctx.get("program_spans", {}).get("loss.targets") \
        if ctx["kind"] == "solov2" else None
    return row["device_ms"] if row else None
