"""One run of one cell: set-up, the first three steps and their readings,
the measured window, an optional traced window, and the check against the
reference.

Set-up makes the traffic pool and the weights on the device from the seed,
builds the port's train step, and drives it through its first three steps
on rows that all differ; those steps warm up every shape the window uses.
The window then calls the same step on the same feed for ``seconds``,
sending steps ahead of the card and reading their losses late (``window``).
With ``trace``, a few more
steps run under the profiler before the window, and the reference counts
their spikes.  Once the window has closed and the peak memory is read, the
program's state is freed and the reference follows the first three steps
from the same weights and batches (``check``).
"""
from __future__ import annotations

import gc
import math
import sys
import time
from typing import Optional

import torch

from portbench import check, counting, devtrace, faults, program, traffic
from portbench import net as netmod
from portbench.catalog import Cell, reader
from portbench.context import Context, percentile
from portbench.reference import snn as ref

FIRST_STEPS = 3
#: How long the host may run ahead of the oldest loss it has not read.
AHEAD_S = 4.0
#: Pinned slots for the losses in flight; a step waits for the oldest.
RING = 4096
#: Top-level modules that may not be loaded when a run's result is printed.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def _cell_norms(tree: list, lead: Optional[int]) -> list:
    """[cell][leaf] fp64 norms of a param-shaped tree, (layer, key) order."""
    cols = [v.detach().reshape(lead or 1, -1).double().norm(dim=1)
            for p in tree for v in p.values()]
    return torch.stack(cols, dim=1).tolist()


class Run:
    """The program under test for one cell and seed: its feed, its weights,
    its Adam state and the port's step."""

    def __init__(self, cell: Cell, seed: int, device, fault: str = ""):
        """``fault``: one of ``faults.FAULTS`` planted in the step, or
        none."""
        cfg, mix = cell.config, cell.traffic
        if cfg["dtype"] != "float32" or cfg["tf32"]:
            raise ValueError("the benchmark runs fp32 with TF32 off only")
        self.cell, self.seed, self.device = cell, seed, device
        self.net = netmod.parse(cfg, traffic.num_steps(mix, cfg["num_steps"]))
        self.cells = mix.get("cells")
        self.batch = mix["batch"]
        self.feed = traffic.Feed(mix, self.net.num_classes, seed, device)
        self.params = netmod.init_params(self.net, cfg["init"], self.cells,
                                         seed, device)
        self.step, tx = program.train_step(cell.config_name, self.net, cfg,
                                           slab=bool(self.cells))
        if fault:
            self.step = faults.broken(self.step, fault, bool(self.cells))
        self.opt_state = tx.init(self.params)
        gens = [traffic.generator(device, seed, "rate", c)
                for c in range(self.cells or 1)]
        self.gens = gens if self.cells else gens[0]
        self.taken = 0

    def take(self):
        """One step of the port on the feed's next batch: (rows, losses)."""
        rows = self.feed.next()
        x, y = self.feed.batch(rows)
        self.params, self.opt_state, loss = self.step(
            self.params, self.opt_state, self.gens, x, y)
        self.taken += 1
        return rows, loss

    def free(self) -> None:
        """Drop the program's state; the feed stays for the reference."""
        self.params = self.opt_state = self.step = None
        gc.collect()
        torch.cuda.empty_cache()


def first_steps(run: Run, b1: float):
    """The first steps' readings: (check.Readings, initial params on the
    host, each step's rows)."""
    p0 = [{k: v.clone() for k, v in p.items()} for p in run.params]
    losses, rows = [], []
    grads = None
    for k in range(FIRST_STEPS):
        r, loss = run.take()
        rows.append(r.cpu())
        losses.append(loss.double().reshape(-1).tolist())
        if grads is None:
            mu = program.first_moments(run.opt_state)
            grads = [[n / (1.0 - b1) for n in cell]
                     for cell in _cell_norms(mu, run.cells)]
    change = [{k: v - p0[i][k] for k, v in p.items()}
              for i, p in enumerate(run.params)]
    updates = _cell_norms(change, run.cells)
    del change
    p0 = [{k: v.cpu() for k, v in p.items()} for p in p0]
    return check.Readings(losses, grads, updates), p0, rows


def cell_params(p0: list, c: int, slab: bool, device) -> list:
    return [{k: (v[c] if slab else v).to(device) for k, v in p.items()}
            for p in p0]


def reference_readings(run: Run, p0: list, rows: list,
                       precision: str = "fp32") -> check.Readings:
    """The reference's readings of the same first steps, cell by cell."""
    cfg, dev, slab = run.cell.config, run.device, bool(run.cells)
    rate = run.cell.traffic["kind"] == "images"
    losses = [[] for _ in rows]
    grads, updates = [], []
    for c in range(run.cells or 1):
        params = cell_params(p0, c, slab, dev)
        gen = traffic.generator(dev, run.seed, "rate", c) if rate else None
        batches = [run.feed.batch((r[c] if slab else r).to(dev))
                   for r in rows]
        cell_losses, g1, p3 = ref.train_steps(
            run.net, params, batches, gen, cfg["optimizer"],
            cfg["reference_rows"], precision)
        for k, loss in enumerate(cell_losses):
            losses[k].append(loss)
        grads.append(ref.norms(g1))
        updates.append(ref.norms([{k: v - params[i][k] for k, v in p.items()}
                                  for i, p in enumerate(p3)]))
        del params, batches, g1, p3
    return check.Readings(losses, grads, updates)


def _count_traced(run: Run, traced: list, skip: int) -> list:
    """``counting`` launches of the traced steps: the reference's spike
    counts over each step's batch and parameters.  ``skip``: steps whose
    rate code the port drew before the first traced one."""
    slab = bool(run.cells)
    rate = run.cell.traffic["kind"] == "images"
    launches = []
    for c in range(run.cells or 1):
        encode = ref.Encoder(run.net, traffic.generator(
            run.device, run.seed, "rate", c) if rate else None)
        for _ in range(skip if rate else 0):
            ref.rate_uniforms(encode.gen, (run.batch,) + run.net.input_shape,
                              run.net.num_steps, run.device)
        for k, (rows, params) in enumerate(traced):
            x, _ = run.feed.batch(rows[c] if slab else rows)
            stats = ref.spike_stats(run.net, cell_params(
                params, c, slab, run.device), encode(x))
            if c == 0:
                launches.append([stats])
            else:
                launches[k].append(stats)
    return [l for cells in launches
            for l in counting.step_launches(run.net, run.batch, cells)]


def trace_steps(run: Run, steps: int, tries: int = 3):
    """(trace, launches) of ``steps`` steps under the profiler (the device
    alone), the trace's idle gaps named from one more step traced with the
    host.  The parameters each traced step starts from are held by
    reference: the port's step returns new tensors and leaves its arguments
    as they are."""
    def one():
        params = run.params
        rows, loss = run.take()
        loss.cpu()
        traced.append((rows, params))

    for _ in range(tries):
        skip, traced = run.taken, []
        trace = devtrace.traced(steps, one, host=False)
        if trace.ops:
            launches = _count_traced(run, traced, skip)
            trace.gaps = devtrace.traced(1, one, host=True).gaps
            return trace, launches
        log("the profiler recorded no device operation; tracing again")
    return trace, []


def window(run: Run, seconds: float):
    """(steps, seconds, step times in ms, steps whose loss is not finite,
    the window's start).

    The host sends steps ahead of the card: each step's loss is copied to
    pinned host memory in stream order, behind the step, and read only once
    the step was sent ``AHEAD_S`` seconds ago or more, by waiting on that
    step's own end event, so a read waits for none of the steps sent after
    it and the card has work queued while the host stands still.  When the
    time is up, nothing more is sent, all that was sent is waited for, and
    the clock is read after that wait: every step sent counts, over all of
    that time."""
    cells = run.cells or 1
    host = torch.empty((RING, cells), dtype=torch.float32,
                       pin_memory=run.device.type == "cuda")
    marks, sent, failed, read = [], [], 0, 0

    def read_to(upto: int) -> int:
        """Reads the losses of steps ``read`` to ``upto`` - 1."""
        marks[upto - 1][1].synchronize()
        bad = 0
        for k in range(read, upto):
            bad += not all(math.isfinite(v) for v in host[k % RING].tolist())
        return bad

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while not marks or time.perf_counter() - t0 < seconds:
        n = len(marks)
        if n - read == RING:
            failed += read_to(read + 1)
            read += 1
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        _, loss = run.take()
        host[n % RING].copy_(loss.reshape(-1), non_blocking=True)
        end.record()
        marks.append((start, end))
        now = time.perf_counter()
        sent.append(now)
        due = read
        while due < n and now - sent[due] >= AHEAD_S:
            due += 1
        if due > read:
            failed += read_to(due)
            read = due
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    if read < len(marks):
        failed += read_to(len(marks))
    log(f"window: {len(marks)} steps in {elapsed:.3f} s, of which "
        f"{elapsed - (sent[-1] - t0):.3f} s waiting for the card after the "
        "last send")
    return (len(marks), elapsed, [s.elapsed_time(e) for s, e in marks],
            failed, t0)


def forbidden_modules() -> list:
    loaded = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(loaded & set(FORBIDDEN))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             started: float, device) -> dict:
    """One run; returns the result's fields.  The caller looks for
    forbidden modules once this has returned (``run.report``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    b1 = cell.config["optimizer"]["b1"]
    run = Run(cell, seed, device)
    prog, p0, rows = first_steps(run, b1)
    ctx_trace = None
    if trace:
        ctx_trace = trace_steps(run, cell.traffic["trace_steps"])
    setup_peak = torch.cuda.max_memory_allocated()
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    steps, elapsed, step_ms, failed, t0 = window(run, seconds)
    setup_s = t0 - started
    peak = torch.cuda.max_memory_allocated()
    run.free()
    refr = reference_readings(run, p0, rows)
    correct, shown = check.judge(check.numbers(
        prog, refr, cell.limits["loss_steps"]), cell.limits)
    samples = steps * run.batch * (run.cells or 1)
    e2e = {"train_samples_per_s": samples / elapsed,
           "peak_mem_gib": peak / 2 ** 30,
           "step_ms_p95": percentile(step_ms, 95) if steps > 1 else None,
           "setup_s": setup_s}
    device_info = {"platform": "gpu",
                   "kind": torch.cuda.get_device_name(device),
                   "count": 1, "memory_peak_bytes": max(setup_peak, peak)}
    out = {"correct": correct, "attempted": steps, "failed": failed}
    if not trace:
        values = {m["name"]: e2e[m["name"]] for m in cell.end_to_end}
        out["metrics"] = _with_units(values, cell.end_to_end)
        out["device"] = device_info
    else:
        tr, launches = ctx_trace
        ctx = Context(tr, cell.traffic["trace_steps"], launches,
                      elapsed / steps, step_ms, run.cells or 1)
        values = {m["name"]: reader(m["name"])(ctx) for m in cell.per_layer}
        out["metrics"] = _with_units(values, cell.per_layer)
        out["device"] = dict(device_info, busy_s=tr.busy_s,
                             window_s=tr.window_s)
        out["breakdown"] = {"device_ops": tr.top_ops(10),
                            "idle_gaps": tr.top_gaps(10)}
    out["checks"] = shown
    return out


def _with_units(values: dict, metrics: list) -> dict:
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in metrics if values.get(m["name"]) is not None}
