"""The check fails what it should: a run with the port's step broken
underneath (the chip's look skipped, everything else as in a run) ends
with ``correct`` false, and so does the control, the reference in TF32 in
the port's place, at the tiny size."""
from __future__ import annotations

import pytest

from portbench import check, faults, harness, program
from portbench.conftest import result_line, tiny_cell


@pytest.mark.parametrize("which", ["net5", "net3"])
@pytest.mark.parametrize("fault", faults.FAULTS)
def test_a_broken_step_is_not_correct(card_on_cpu, monkeypatch, which,
                                      fault):
    real = program.train_step

    def broken_train_step(name, net, config, slab):
        step, tx = real(name, net, config, slab)
        return faults.broken(step, fault, slab), tx

    monkeypatch.setattr(program, "train_step", broken_train_step)
    out = result_line(harness.run_cell(tiny_cell(which), 31, 0.1, False,
                                       0.0, card_on_cpu))
    assert out["correct"] is False
    over = [n for n, c in out["checks"].items() if c["value"] > c["limit"]]
    assert over


@pytest.mark.parametrize("which", ["net5", "net3"])
def test_the_control_is_not_correct(card_on_cpu, which):
    cell = tiny_cell(which)
    run = harness.Run(cell, 2 ** 31 + 3, card_on_cpu)
    prog, p0, rows = harness.first_steps(run, 0.9)
    run.free()
    ref = harness.reference_readings(run, p0, rows)
    ctl = harness.reference_readings(run, p0, rows, "tf32")
    loss_steps = cell.limits["loss_steps"]
    sound, _ = check.judge(check.numbers(prog, ref, loss_steps), cell.limits)
    control, shown = check.judge(check.numbers(ctl, ref, loss_steps),
                                 cell.limits)
    assert sound and not control, shown
