"""The dense group's share of its roofline: the least time of the dense
layers' forward (the fused GEMM+LIF step, or ``spike_gemm``), dW and dS
launches at the H100's peaks (``counting``), over the device time of the
kernels below, in the traced steps."""
KERNELS = ("spike_gemm_lif_split_kernel", "spike_gemm_lif_reduce_kernel",
           "spike_gemm_split_kernel", "spike_gemm_reduce_kernel",
           "spike_gemm_dw_kernel", "spike_gemm_ds_large_kernel",
           "spike_gemm_ds_small_kernel")


def read(ctx):
    return ctx.roofline_pct("dense", KERNELS)
