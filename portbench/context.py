"""What a per-layer metric's reader sees of a traced run."""
from __future__ import annotations

import dataclasses
import re
import statistics

from portbench.devtrace import Trace


def percentile(values, q: float) -> float:
    """The ``q``-th percentile, interpolated between order statistics."""
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


def matcher(symbols):
    """A test of a device operation's name for any of ``symbols`` as a
    whole identifier (``spike_conv_dw_kernel`` is not ``dw_kernel``)."""
    pattern = re.compile(r"(?<![A-Za-z0-9_])(" + "|".join(
        re.escape(s) for s in symbols) + r")(?![A-Za-z0-9_])")
    return lambda name: pattern.search(name) is not None


@dataclasses.dataclass
class Context:
    trace: Trace           # the traced steps
    steps: int             # how many steps were traced
    launches: list         # counting.Launch of every product of them
    step_s: float          # the untraced window's seconds a step
    step_ms: list          # the untraced window's step times (ms)
    cells: int             # cells a step trains (1 for one cell)

    def device_s(self, symbols) -> float:
        """Device seconds of the traced operations named by ``symbols``."""
        named = matcher(symbols)
        return sum(e - s for n, s, e in self.trace.ops if named(n)) / 1e6

    def roofline_pct(self, group: str, symbols):
        """The group's least time at the peaks over its device time, in
        percent; None where the group ran nothing."""
        took = self.device_s(symbols)
        if took <= 0:
            return None
        least = sum(l.least_s for l in self.launches if l.group == group)
        return 100.0 * least / took
