"""The span window on the CPU: ``idle_by_span`` on made-up device
operations and spans, the window's steps on a tiny cell (spans, no device
operation, so every reading None), and the readers' silence where the
command line names no cell or the port has no spans."""
from __future__ import annotations

import random

import pytest

from portbench import catalog, harness, spanwin
from portbench.conftest import tiny_cell
from repro_torch.spans import Span

US = 1_000          # ns in a microsecond

#: step 100-1000 us: forward 100-400 (fwd.conv0 150-250), backward 400-800
#: (bwd.conv 500-600, on another thread), optimizer 800-950.
RECORDS = [Span("step", 0, 1, None, 100 * US, 1000 * US),
           Span("forward", 0, 1, 0, 100 * US, 400 * US),
           Span("fwd.conv0", 0, 1, 1, 150 * US, 250 * US),
           Span("backward", 0, 1, 0, 400 * US, 800 * US),
           Span("bwd.conv", 0, 2, 3, 500 * US, 600 * US),
           Span("optimizer", 0, 1, 0, 800 * US, 950 * US)]
#: gaps 120-200, 300-420 (forward, then backward), 450-700, 900-980 (the
#: optimizer, then the step's own code) and 1100-1200 (outside the step).
OPS = [("k1", 50.0, 120.0), ("k2", 200.0, 300.0), ("k3", 420.0, 450.0),
       ("k4", 700.0, 900.0), ("k5", 980.0, 1100.0), ("k6", 1200.0, 1300.0)]


def _close(got: dict, want_us: dict) -> None:
    assert set(got) == set(want_us)
    for k, v in want_us.items():
        assert got[k] == pytest.approx(v / 1e6, abs=1e-12), k


def test_idle_splits_by_phase_and_innermost_span():
    got = spanwin.idle_by_span(OPS, RECORDS)
    assert got.idle_s == pytest.approx(630e-6)
    assert got.span_s == pytest.approx(1250e-6)
    _close(got.phases, {"forward": 180, "backward": 270, "optimizer": 50,
                        "step": 30, "outside": 100})
    _close(got.innermost, {"forward": 130, "fwd.conv0": 50, "backward": 170,
                           "bwd.conv": 100, "optimizer": 50, "step": 30,
                           "outside": 100})


def test_a_gap_outside_every_step_is_outside():
    got = spanwin.idle_by_span([("a", 0.0, 10.0), ("b", 30.0, 40.0)],
                               RECORDS)
    _close(got.phases, {"outside": 20})
    _close(got.innermost, {"outside": 20})
    got = spanwin.idle_by_span([("a", 0.0, 10.0), ("b", 30.0, 40.0)], [])
    _close(got.phases, {"outside": 20})


def test_no_device_operation_is_no_idle():
    got = spanwin.idle_by_span([], RECORDS)
    assert got.idle_s == 0.0 and got.phases == {} and got.innermost == {}


def _random_window(rng: random.Random):
    """Steps of nested spans on two threads and device operations that
    start before the first step and end after the last."""
    records, t = [], 0
    for step in range(rng.randint(1, 3)):
        t += rng.randint(0, 50) * US
        top = len(records)
        records.append(Span("step", step, 1, None, t, None))
        for phase in spanwin.PHASES:
            start = t
            parent = len(records)
            records.append(Span(phase, step, 1, top, start, None))
            for k in range(rng.randint(0, 4)):
                t += rng.randint(1, 40) * US
                end = t + rng.randint(1, 60) * US
                records.append(Span(f"{phase[:3]}.{k}", step,
                                    rng.choice((1, 2)), parent, t, end))
                t = end
            t += rng.randint(0, 30) * US
            records[parent].end_ns = t
        t += rng.randint(0, 20) * US
        records[top].end_ns = t
    ops, at = [], -rng.randint(0, 100)
    while at < t / US + 100:
        length = rng.uniform(0.5, 30.0)
        ops.append(("k", at, at + length))
        at += length + rng.choice((0.0, rng.uniform(0.0, 40.0)))
    return ops, records


@pytest.mark.parametrize("seed", range(6))
def test_phases_and_outside_sum_to_all_idle(seed):
    ops, records = _random_window(random.Random(seed))
    got = spanwin.idle_by_span(ops, records)
    assert got.idle_s > 0
    assert sum(got.phases.values()) == pytest.approx(got.idle_s, rel=1e-9)
    assert sum(got.innermost.values()) == pytest.approx(got.idle_s,
                                                        rel=1e-9)
    assert set(got.phases) <= set(spanwin.PHASES) | {"step", "outside"}


def test_the_command_line_names_the_cell():
    assert spanwin.command_line(["--workload", "net5-train-dvs", "--seed",
                                 str(2 ** 31 + 9), "--seconds", "51",
                                 "--trace", "1"]) == ("net5-train-dvs",
                                                      2 ** 31 + 9)
    assert spanwin.command_line(["-q", "-n", "6", "--se", "3"]) is None
    assert spanwin.command_line(["--workload", "net5-train-dvs"]) is None


def test_the_window_on_the_cpu_records_spans_and_reads_none(card_on_cpu):
    cell = tiny_cell("net5")
    run = harness.Run(cell, 2 ** 31 + 17, card_on_cpu)
    ops, records = spanwin.span_steps(run, 2)
    assert ops == []
    assert [r.name for r in records].count("step") == 2
    assert {"forward", "backward", "optimizer"} <= {r.name for r in records}
    got = spanwin.measure(cell, 2 ** 31 + 17, card_on_cpu)
    assert got == dict.fromkeys(spanwin.READINGS)


@pytest.mark.parametrize("metric", spanwin.READINGS)
def test_the_readers_are_silent_without_a_cell_or_spans(monkeypatch,
                                                         metric):
    read = catalog.reader(metric)
    monkeypatch.setattr(spanwin.sys, "argv", ["pytest", "-q"])
    assert read(object()) is None
    monkeypatch.setattr(spanwin.sys, "argv", [
        "run.py", "--workload", "net5-train-dvs", "--seed", "1"])
    # a commit of the port before ``repro_torch.spans``
    monkeypatch.setattr(spanwin, "port_has_spans", lambda: False)
    assert read(object()) is None
