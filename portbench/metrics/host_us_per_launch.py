"""Host µs a device kernel: the host time in the span window's ``step``
spans over the device kernels the window ran (copies and memsets left
out, as ``launches_per_step`` counts) (``spanwin``)."""
from portbench import spanwin


def read(ctx):
    got = spanwin.reading(ctx)
    return None if got is None else got["host_us_per_launch"]
