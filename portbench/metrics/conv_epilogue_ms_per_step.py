"""Device milliseconds a step in the conv layers' fused epilogue (bias,
LIF update, spike and OR-pool: ``csrc/conv_epilogue.cu``), forward and
backward, in the traced steps; None where those kernels ran nothing."""
#: The epilogue's kernels: the forward, the backward's elementwise pass
#: and its bias reduction.
KERNELS = ("conv_epilogue_fwd_kernel", "conv_epilogue_bwd_kernel",
           "conv_epilogue_bias_kernel")


def read(ctx):
    took = ctx.device_s(KERNELS)
    return 1e3 * took / ctx.steps if took > 0 else None
