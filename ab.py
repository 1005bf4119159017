"""The A/B runner of the ``*_ab.py`` scripts: one measurement of this
checkout (A) and of another (B) on one card, each checkout in processes of
its own, run in the order A, B, B, A, so a drift of the card's clock falls
on both alike.

A script ends in ``sys.exit(ab.main(sys.argv, __doc__, measure, report))``.
``script.py --worker`` prints ``measure()``'s dict as one JSON line; the
worker imports ``repro_torch`` from the checkout its PYTHONPATH names, and
this checkout's ``chip_smoke`` and ``ab``.  ``script.py OTHER`` runs the
worker on this checkout and on OTHER, hands the four ``(tree, result)``
runs to ``report``, which prints its table and returns ``(exit code,
rows)``, and writes the trees, runs and rows to
``chiprun_out/<script>.json``.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def mean(runs, tree, *keys):
    """The mean over ``tree``'s runs of ``result[keys[0]][keys[1]]...``;
    None if a run has None there."""
    vals = []
    for name, result in runs:
        if name == tree:
            for k in keys:
                result = result[k]
            vals.append(result)
    return None if None in vals else sum(vals) / len(vals)


def _run(script: Path, tree: Path, timeout: int) -> dict:
    env = dict(os.environ, PYTHONPATH=str(tree / "src"))
    out = subprocess.run([sys.executable, str(script), "--worker"], env=env,
                         capture_output=True, text=True, timeout=timeout)
    if out.returncode != 0:
        raise RuntimeError(f"worker on {tree} failed:\n{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv, doc, measure, report, timeout=1200) -> int:
    script = Path(argv[0]).resolve()
    if argv[1:] == ["--worker"]:
        print(json.dumps(measure()), flush=True)
        return 0
    if len(argv) != 2:
        print(doc, file=sys.stderr)
        return 2
    trees = {"A": ROOT, "B": Path(argv[1]).resolve()}
    runs = [(name, _run(script, trees[name], timeout)) for name in "ABBA"]
    code, rows = report(runs)
    out = ROOT / "chiprun_out" / f"{script.stem}.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps({"trees": {k: str(v) for k, v in trees.items()},
                               "runs": runs, "rows": rows}, indent=1))
    return code
