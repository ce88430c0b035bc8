"""Device ms a step under the program's ``heads.instance`` span (the
instance head's forward: both DCN towers at the five levels and their
predictions), from ``benchmark/spans.py::train``'s table; none where the
program has no such span."""


def read(ctx):
    row = ctx.get("program_spans", {}).get("heads.instance") \
        if ctx["kind"] == "solov2" else None
    return row["device_ms"] if row else None
