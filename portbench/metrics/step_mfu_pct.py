"""The whole step's share of the H100's fp32 peak: the operations the
step's products need (``counting``, from the reference's spike counts of
the traced steps), over the untraced window's seconds a step times
67 TFLOP/s (fp32 outside the tensor cores, TF32 off, as the configurations
state)."""
from portbench.counting import PEAK_FP32_FLOPS


def read(ctx):
    if not ctx.launches:
        return None
    flops = sum(l.flops for l in ctx.launches) / ctx.steps
    return 100.0 * flops / (ctx.step_s * PEAK_FP32_FLOPS)
