"""Run one cell of the port's benchmark once and print one JSON line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  With ``--trace 0`` the line's metrics are the
cell's end-to-end metrics; with ``--trace 1``, its per-layer metrics from
a few steps under the profiler.  The numbers compared with the reference
are printed beside their limits, last on standard error and last in the
line.  Without as many CUDA devices as the cell asks for, the run prints
no result and exits with 2; where ``jax``, ``jaxlib``, ``flax`` or the JAX
package ``repro`` is loaded once all else is done, with 3.
"""
import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _finite(x):
    """JSON has no infinity: a gap that is not finite prints as 1e308."""
    if isinstance(x, float) and not math.isfinite(x):
        return 1e308
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    return x


def power_limit_w():
    """The card's power limit in watts, from ``nvidia-smi``; None where it
    cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60, check=True)
        return float(out.stdout.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch
    from portbench import catalog, harness

    cell = catalog.cell(args.workload)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        harness.log(f"{args.workload} needs {cell.chips} CUDA device(s); "
                    f"this machine has {have}: no result")
        return 2
    torch.set_num_threads(2)
    device = torch.device("cuda", 0)
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           STARTED, device)
    if args.trace:
        out["device"]["power_limit_w"] = power_limit_w()
        out["checks"] = out.pop("checks")
    return report(out)


def report(out: dict) -> int:
    """Print the result's line, and its compared numbers last on standard
    error, unless a forbidden module was loaded by then: the window, the
    reference and the per-layer readers have all run, so this look sees
    whatever any of them loaded."""
    from portbench import harness

    loaded = harness.forbidden_modules()
    if loaded:
        harness.log(f"loaded by the end of the run: {', '.join(loaded)}: "
                    "no result")
        return 3
    for name, c in out["checks"].items():
        harness.log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(_finite(out)), flush=True)
    return 0


if __name__ == "__main__":
    # the checkout's root (for ``portbench``) and its ``src`` (the port), in
    # place of this script's own directory
    sys.path[0:1] = [str(ROOT), str(ROOT / "src")]
    sys.exit(main())
