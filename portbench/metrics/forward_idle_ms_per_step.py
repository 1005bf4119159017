"""Device idle ms a step while the host was inside the step's ``forward``
span (the T-loop of ``snn.apply``), in the span window (``spanwin``)."""
from portbench import spanwin


def read(ctx):
    got = spanwin.reading(ctx)
    return None if got is None else got["forward_idle_ms_per_step"]
