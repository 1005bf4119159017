"""Device idle ms a step while the host was inside the step's ``backward``
span (``torch.autograd.grad``: autograd's nodes and the Functions'
backwards on its device thread), in the span window (``spanwin``)."""
from portbench import spanwin


def read(ctx):
    got = spanwin.reading(ctx)
    return None if got is None else got["backward_idle_ms_per_step"]
