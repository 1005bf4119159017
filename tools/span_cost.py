"""What recording the port's spans costs: a cell's training throughput over
the benchmark's untraced window (``portbench.harness.window``) with
``repro_torch.spans.recording()`` off and on, in turns (off, on, on, off,
per round), in one process on one card.

    python3 tools/span_cost.py --workload net5-train-dvs --seed 1 \
        --seconds 51 --rounds 1

from the root of a checkout.  Prints one JSON line: each window's samples
a second, steps and spans recorded, and the medians on and off.
"""
import argparse
import contextlib
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", default="net5-train-dvs")
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, default=51.0)
    parser.add_argument("--rounds", type=int, default=1)
    args = parser.parse_args(argv)

    import torch

    from portbench import catalog, harness
    from portbench.run import power_limit_w
    from repro_torch import spans

    if not torch.cuda.is_available():
        harness.log("needs a CUDA device: no result")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(2)
    cell = catalog.cell(args.workload)
    device = torch.device("cuda", 0)
    run = harness.Run(cell, args.seed, device)
    for _ in range(harness.FIRST_STEPS):
        run.take()
    windows = []
    for on in (False, True, True, False) * args.rounds:
        off = contextlib.nullcontext([])
        with spans.recording() if on else off as records:
            steps, elapsed, _, failed, _ = harness.window(run, args.seconds)
        windows.append({"recording": on, "steps": steps, "seconds": elapsed,
                        "failed": failed,
                        "samples_per_s": steps * run.batch / elapsed,
                        "spans": len(records)})
        harness.log(json.dumps(windows[-1]))
    med = {state: statistics.median(w["samples_per_s"] for w in windows
                                    if w["recording"] == on)
           for state, on in (("off", False), ("on", True))}
    out = {"workload": args.workload, "seed": args.seed,
           "card": torch.cuda.get_device_name(device),
           "power_limit_w": power_limit_w(), "windows": windows,
           "median_samples_per_s": med,
           "on_over_off": med["on"] / med["off"] - 1.0}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0:1] = [str(ROOT), str(ROOT / "src")]
    sys.exit(main())
