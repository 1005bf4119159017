"""Device milliseconds a step in operations that are not the port's own
kernels: PyTorch's elementwise passes (LIF, surrogate, pool, bias, flags),
copies and Adam's kernels, in the traced steps."""
#: Every kernel of the port (``src/repro_torch/kernels/csrc``).
PORT_KERNELS = (
    "spike_conv_strip_kernel", "spike_conv_pixel_kernel",
    "spike_conv_dw_kernel", "dw_reduce_kernel", "dw_reduce_slab_kernel",
    "spike_conv_ds_strip_kernel", "spike_conv_ds_pixel_kernel",
    "spike_gemm_split_kernel", "spike_gemm_reduce_kernel",
    "spike_gemm_lif_split_kernel", "spike_gemm_lif_reduce_kernel",
    "spike_gemm_dw_kernel", "spike_gemm_ds_large_kernel",
    "spike_gemm_ds_small_kernel", "lif_step_kernel", "penc_row_kernel",
    "penc_mask_kernel", "penc_address_kernel")


def read(ctx):
    if not ctx.trace.ops:
        return None
    total = sum(e - s for _, s, e in ctx.trace.ops) / 1e6
    return 1e3 * (total - ctx.device_s(PORT_KERNELS)) / ctx.steps
