"""The conv group's share of its roofline: the least time of the conv
layers' forward, dW and dS launches at the H100's peaks (``counting``),
over the device time of the kernels below, in the traced steps."""
KERNELS = ("spike_conv_strip_kernel", "spike_conv_pixel_kernel",
           "spike_conv_dw_kernel", "dw_reduce_kernel",
           "dw_reduce_slab_kernel", "spike_conv_ds_strip_kernel",
           "spike_conv_ds_pixel_kernel")


def read(ctx):
    return ctx.roofline_pct("conv", KERNELS)
