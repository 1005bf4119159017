"""Device kernels a step, all of them (copies and memsets left out), in
the traced steps: an exact count."""


def read(ctx):
    kernels = [n for n, _, _ in ctx.trace.ops
               if not n.startswith(("Memcpy", "Memset"))]
    return len(kernels) / ctx.steps if kernels else None
