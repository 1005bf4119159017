"""The readings that the correctness limits are set from, on the chip.

    python3 portbench/probe.py --workload <cell> --seeds 1-12 \
        --control 3 --faults 3 --out chiprun_out/probe-<cell>.json

For each seed, at the cell's own size: the port's first three steps
against the reference (the lower readings), then for the first
``--control`` seeds the control, the reference in TF32 put in the port's
place, and for the first ``--faults`` seeds the port with a planted fault
(half the batch left out; a step that returns its state unchanged), each
against the same reference.  Also the layers' input spikes a sample and
step at the initial weights, and the seconds each part took.  One JSON
line a seed on standard output; all of them in ``--out``.
"""
import sys
import time
from pathlib import Path

sys.path[0:1] = [str(Path(__file__).resolve().parent.parent),
                 str(Path(__file__).resolve().parent.parent / "src")]

import argparse  # noqa: E402
import json  # noqa: E402

import torch  # noqa: E402

from portbench import catalog, check, faults, harness, traffic  # noqa: E402
from portbench.reference import snn as ref  # noqa: E402


def _seeds(text: str) -> list:
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def step_gaps(a: check.Readings, b: check.Readings) -> list:
    """The loss gap of each step alone (the worst cell)."""
    return [max(abs(x - y) / abs(y) for x, y in zip(pa, pb))
            for pa, pb in zip(a.losses, b.losses)]


def rates(run: harness.Run, p0: list, rows) -> list:
    """Input spikes a sample and step of each spiking layer, cell 0, the
    first batch, the initial weights."""
    slab = bool(run.cells)
    x, _ = run.feed.batch((rows[0][0] if slab else rows[0]).to(run.device))
    gen = (traffic.generator(run.device, run.seed, "rate", 0)
           if run.cell.traffic["kind"] == "images" else None)
    params = harness.cell_params(p0, 0, slab, run.device)
    stats = ref.spike_stats(run.net, params, ref.Encoder(run.net, gen)(x))
    return [sum(r[0] for r in s) / (len(s) * run.batch) for s in stats]


def probe(cell: catalog.Cell, seed: int, control: bool, planted: bool,
          device) -> dict:
    b1 = cell.config["optimizer"]["b1"]
    steps = range(harness.FIRST_STEPS)
    t = time.perf_counter()
    run = harness.Run(cell, seed, device)
    prog, p0, rows = harness.first_steps(run, b1)
    torch.cuda.synchronize()
    rec = {"seed": seed, "setup_and_steps_s": time.perf_counter() - t}
    run.free()
    rec["input_spikes"] = rates(run, p0, rows)
    t = time.perf_counter()
    refr = harness.reference_readings(run, p0, rows)
    torch.cuda.synchronize()
    rec["reference_s"] = time.perf_counter() - t
    rec["program"] = check.numbers(prog, refr, steps)
    rec["program_steps"] = step_gaps(prog, refr)
    if control:
        ctl = harness.reference_readings(run, p0, rows, "tf32")
        rec["control"] = check.numbers(ctl, refr, steps)
        rec["control_steps"] = step_gaps(ctl, refr)
    del run
    if planted:
        for fault in faults.FAULTS:
            bad = harness.Run(cell, seed, device, fault)
            got, _, _ = harness.first_steps(bad, b1)
            rec[fault] = check.numbers(got, refr, steps)
            rec[fault + "_steps"] = step_gaps(got, refr)
            bad.free()
            del bad
    return rec


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control", type=int, default=3)
    parser.add_argument("--faults", type=int, default=3)
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        harness.log("the probe needs a CUDA device")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = catalog.cell(args.workload)
    device = torch.device("cuda", 0)
    records = []
    for i, seed in enumerate(_seeds(args.seeds)):
        rec = probe(cell, seed, i < args.control, i < args.faults, device)
        records.append(rec)
        print(json.dumps(rec), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"workload": args.workload,
             "device": torch.cuda.get_device_name(device),
             "records": records}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
