"""The share of the traced steps' device span in which no operation ran on
the card: one less the union of the device operations' intervals over the
span from the first one's start to the last one's end, both on the
profiler's device clock."""


def read(ctx):
    if not ctx.trace.ops or ctx.trace.span_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.span_s)
