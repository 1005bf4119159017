"""The span window of a traced run: a few more steps under the port's own
spans (``repro_torch.spans.recording()``) and the profiler's CUDA activity
alone, and each idle gap of the device put down to the spans the host was
in while the card waited.

The spans and the profiler's device operations share one clock (both are
Unix-epoch nanoseconds), so a gap's share of a span is their overlap.  A
gap is split two ways: by the step's phase the host was in (``forward``,
``backward``, ``optimizer``, the step's own code between them, or outside
any step) and by the innermost span (autograd's backward spans, which run
on its device thread, lie under ``backward``, so the deepest wins).

A reader sees only the traced run's ``Context``; so the first reader of
this window builds the cell's ``Run`` again from the run's command line
(``--workload`` and ``--seed``, as ``run.py`` takes them), takes the
set-up's first steps, runs ``trace_steps`` steps under the spans and
keeps the reading for the others.  Where the port has no
``repro_torch.spans``, or the command line names no cell, the readers read
None.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib.util
import math
import sys
import time
from typing import Optional

import torch

from portbench import catalog, devtrace, harness

#: The phases of a step: the spans directly under ``step``.
PHASES = ("forward", "backward", "optimizer")
#: ``repro_torch.spans.STEP``, spelled out: this module is imported where
#: the port has no ``spans`` (a reader then reads None).
STEP = "step"
#: The idle no span of a step covers.
OUTSIDE = "outside"
#: The metrics this window gives, one reader each in ``metrics/``.
READINGS = ("forward_idle_ms_per_step", "backward_idle_ms_per_step",
            "optimizer_idle_ms_per_step", "host_us_per_launch")
#: Span windows tried on the card before the readers give up: the profiler
#: now and then records no device operation (``harness.trace_steps``).
TRIES = 3


@dataclasses.dataclass
class Attribution:
    idle_s: float       # the device span's idle time (between operations)
    span_s: float       # first device operation's start to last one's end
    phases: dict        # phase, "step" (its own code) or OUTSIDE -> idle s
    innermost: dict     # innermost span's name or OUTSIDE -> idle s


def _phase_and_depth(records: list) -> tuple[list, list]:
    """Each span's phase (its ancestor just under a ``step``; "step" for a
    step itself; OUTSIDE for a span under no step) and its depth."""
    phases, depths = [], []
    for i, r in enumerate(records):
        child, parent, depth = i, r.parent, 0
        phase = STEP if r.name == STEP else OUTSIDE
        while parent is not None:
            if records[parent].name == STEP and phase == OUTSIDE:
                phase = records[child].name
            child, parent, depth = parent, records[parent].parent, depth + 1
        phases.append(phase)
        depths.append(depth)
    return phases, depths


def _segments(records: list, depths: list) -> list:
    """(start_us, end_us, innermost span's index or None) covering the whole
    line: between each two span boundaries, the deepest span open (the later
    started among equals)."""
    bounds = []
    for i, r in enumerate(records):
        if r.end_ns is not None:
            bounds.append((r.start_ns / 1e3, 1, i))
            bounds.append((r.end_ns / 1e3, 0, i))
    bounds.sort()
    segs, open_, at = [], {}, -math.inf
    for t, starts, i in bounds:
        if t > at:
            inner = max(open_, key=lambda k: (depths[k], records[k].start_ns,
                                              k)) if open_ else None
            segs.append((at, t, inner))
            at = t
        if starts:
            open_[i] = None
        else:
            open_.pop(i, None)
    segs.append((at, math.inf, None))
    return segs


def idle_by_span(ops: list, records: list) -> Attribution:
    """Split the device's idle gaps among ``records`` (``spans.Span``s):
    ``ops`` are the device operations, (name, start_us, end_us) on the
    profiler's clock.  Every idle second lands in one phase and one
    innermost name, so each split sums to ``idle_s``."""
    busy_us, gaps = devtrace.union_us(ops)
    span_us = (max(e for _, _, e in ops) - min(s for _, s, _ in ops)
               if ops else 0.0)
    phase_of, depths = _phase_and_depth(records)
    segs = _segments(records, depths)
    phases: dict = {}
    innermost: dict = {}
    j = 0
    for g0, g1 in gaps:
        while segs[j][1] <= g0:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < g1:
            s0, s1, inner = segs[k]
            part = (min(g1, s1) - max(g0, s0)) / 1e6
            if part > 0:
                phase = OUTSIDE if inner is None else phase_of[inner]
                name = OUTSIDE if inner is None else records[inner].name
                phases[phase] = phases.get(phase, 0.0) + part
                innermost[name] = innermost.get(name, 0.0) + part
            k += 1
    return Attribution((span_us - busy_us) / 1e6, span_us / 1e6, phases,
                       innermost)


def span_steps(run, steps: int):
    """(device operations, span records) of ``steps`` more steps of ``run``
    under ``spans.recording()`` and the profiler's CUDA activity alone, each
    step as ``harness.trace_steps`` takes it.  On the CPU, where there is no
    device activity to profile, the operations are empty."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import spans

    on_card = run.device.type == "cuda"
    with (profile(activities=[ProfilerActivity.CUDA]) if on_card
          else contextlib.nullcontext()) as prof:
        torch.cuda.synchronize()
        with spans.recording() as records:
            for _ in range(steps):
                _, loss = run.take()
                loss.cpu()
        torch.cuda.synchronize()
    return (devtrace._events(prof)[0] if on_card else []), records


def port_has_spans() -> bool:
    return importlib.util.find_spec("repro_torch.spans") is not None


def command_line(argv=None) -> Optional[tuple[str, int]]:
    """(workload, seed) of ``run.py``'s command line, or None."""
    parser = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    parser.add_argument("--workload")
    parser.add_argument("--seed", type=int)
    args, _ = parser.parse_known_args(sys.argv[1:] if argv is None else argv)
    if args.workload is None or args.seed is None:
        return None
    return args.workload, args.seed


def _kernels(ops: list) -> int:
    """Device kernels among ``ops``: copies and memsets left out, as
    ``launches_per_step`` counts."""
    return sum(1 for n, _, _ in ops if not n.startswith(("Memcpy", "Memset")))


def measure(cell: catalog.Cell, seed: int, device) -> dict:
    """The four readings of the span window of ``cell`` at ``seed``: device
    idle ms a step with the host inside ``forward``, ``backward`` and
    ``optimizer``, and host µs in ``step`` spans a device kernel.  Each is
    None where the profiler recorded no device operation."""
    run = harness.Run(cell, seed, device)
    for _ in range(harness.FIRST_STEPS):
        run.take()
    torch.cuda.synchronize()
    for _ in range(TRIES if device.type == "cuda" else 1):
        t0 = time.perf_counter()
        ops, records = span_steps(run, cell.traffic["trace_steps"])
        window_s = time.perf_counter() - t0
        if ops:
            break
        harness.log("the profiler recorded no device operation; tracing "
                    "again")
    run.free()
    steps = sum(1 for r in records if r.name == STEP)
    if not ops or not steps:
        harness.log(f"span window: {len(records)} spans, no device "
                    "operation recorded")
        return dict.fromkeys(READINGS)
    got = idle_by_span(ops, records)
    per_step = {k: 1e3 * v / steps for k, v in got.phases.items()}
    host_us = sum(r.end_ns - r.start_ns for r in records
                  if r.name == STEP) / 1e3
    out = dict(zip(READINGS, (per_step.get(p, 0.0) for p in PHASES)))
    out["host_us_per_launch"] = host_us / _kernels(ops)
    harness.log(
        f"span window: {steps} steps in {window_s:.3f} s, {len(records)} "
        f"spans; device idle {100 * got.idle_s / got.span_s:.2f}% of its "
        f"span, {1e3 * got.idle_s / steps:.3f} ms a step: "
        + ", ".join(f"{k} {v:.3f}" for k, v in sorted(per_step.items()))
        + f"; host {out['host_us_per_launch']:.2f} us a kernel")
    top = sorted(got.innermost.items(), key=lambda kv: -kv[1])[:10]
    harness.log("span window, idle ms a step by innermost span: " + ", ".join(
        f"{name} {1e3 * s / steps:.3f}" for name, s in top))
    return out


_cache: list = []


def reading(ctx) -> Optional[dict]:
    """The span window's readings for the traced run ``ctx``, measured once
    and kept for the other readers; None where the port has no spans or
    the command line names no cell."""
    if _cache and _cache[0] is ctx:
        return _cache[1]
    named = command_line()
    got = None
    if named is not None and port_has_spans():
        workload, seed = named
        got = measure(catalog.cell(workload), seed, torch.device("cuda", 0))
    _cache[:] = [ctx, got]
    return got
