"""Device idle ms a step while the host was inside the step's
``optimizer`` span (Adam's update and ``apply_updates``), in the span
window (``spanwin``)."""
from portbench import spanwin


def read(ctx):
    got = spanwin.reading(ctx)
    return None if got is None else got["optimizer_idle_ms_per_step"]
