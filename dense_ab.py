"""Times of the dense spike kernels of two checkouts of this repo on
one card: each checkout in processes of its own, run in the order A, B, B,
A, so a drift of the card's clock falls on both alike.

    python3 dense_ab.py OTHER        # OTHER: the root of another checkout

A worker (``--worker``) imports ``repro_torch`` from the checkout given in
its PYTHONPATH, builds that checkout's kernels and times the wrappers every
revision of the port keeps, ``spike_gemm_cuda`` and ``spike_gemm_lif_cuda``,
two ways: ``chip_smoke.device_ms``, the profiler's kernel time a call, and
``chip_smoke.median_ms``, one call between two CUDA events, which also
holds the wrapper's host time before the launch whenever the host is
slower than the kernel.  The shapes are the dense layers of net-5, the
dvs-conv cell and the mnist-mlp cell at batch 64, on random spikes at 15%
and normal weights made from a seed, the same in both checkouts.  A (this
checkout) and B (OTHER) each get the mean of their two runs; the table goes
to stdout and every run to ``chiprun_out/dense_ab.json``.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "dense_ab.json"
DENSITY = 0.15
#: (layer, (M, K, N)) of every dense layer of the repo's cells at batch 64.
SHAPES = [("net-5 fc1", (64, 32768, 512)), ("net-5 fc2", (64, 512, 256)),
          ("net-5 fc3", (64, 256, 11)), ("dvs-conv fc1", (64, 1024, 64)),
          ("dvs-conv fc2", (64, 64, 16)), ("mnist-mlp fc1", (64, 784, 128)),
          ("mnist-mlp fc2", (64, 128, 128)),
          ("mnist-mlp fc3", (64, 128, 40))]


def time_all(torch) -> dict:
    """``{layer: {"spike_gemm": ms, "spike_gemm_lif": ms, "splits": P}}``
    for this process's ``repro_torch``."""
    import importlib

    from chip_smoke import device_ms, median_ms
    from repro_torch.kernels import build, ops
    gemm = importlib.import_module("repro_torch.kernels.spike_gemm")
    fused = importlib.import_module("repro_torch.kernels.spike_gemm_fused")
    build.build_all()
    dev = torch.device("cuda")
    times = {}
    for seed, (layer, (m, k, n)) in enumerate(SHAPES):
        gen = torch.Generator(device=dev).manual_seed(seed)
        s = (torch.rand(m, k, generator=gen, device=dev) < DENSITY).float()
        w = torch.randn(k, n, generator=gen, device=dev) / k ** 0.5
        b = torch.randn(n, generator=gen, device=dev) * 0.1
        u0 = torch.randn(m, n, generator=gen, device=dev)
        s0 = (torch.rand(m, n, generator=gen, device=dev) < 0.3).float()
        flags = ops.block_flags(s)
        calls = {"spike_gemm": lambda: gemm.spike_gemm_cuda(s, w, flags),
                 "spike_gemm_lif": lambda: fused.spike_gemm_lif_cuda(
                     s, w, b, u0, s0, flags, beta=0.95, threshold=1.0)}
        plan = getattr(gemm, "split_plan", None)
        times[layer] = {"shape": [m, k, n],
                        "splits": plan(m, n, k)[0] if plan else None}
        for kern, call in calls.items():
            times[layer][kern] = device_ms(torch, call)
            times[layer][kern + "_events"] = median_ms(torch, call)
            if times[layer][kern] is None:
                raise RuntimeError(f"{layer}: the profiler saw no kernel")
    return times


def worker() -> int:
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps(time_all(torch)), flush=True)
    return 0


def run(tree: Path) -> dict:
    env = dict(os.environ, PYTHONPATH=str(tree / "src"))
    out = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                          "--worker"], env=env, capture_output=True,
                         text=True, timeout=1200)
    if out.returncode != 0:
        raise RuntimeError(f"worker on {tree} failed:\n{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv) -> int:
    if argv[1:] == ["--worker"]:
        return worker()
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    trees = {"A": ROOT, "B": Path(argv[1]).resolve()}
    runs = [(name, run(trees[name])) for name in "ABBA"]
    rows = []
    kerns = ("spike_gemm", "spike_gemm_lif", "spike_gemm_events",
             "spike_gemm_lif_events")
    print("layer | (M, K, N) | splits A / B | device us A / B: spike_gemm | "
          "spike_gemm_lif | between events: spike_gemm | spike_gemm_lif")
    for layer, _ in SHAPES:
        mean = {name: {kern: sum(r[layer][kern] for n, r in runs
                                 if n == name) / 2 for kern in kerns}
                for name in trees}
        splits = [dict(runs)[name][layer]["splits"] for name in trees]
        rows.append({"layer": layer, "shape": runs[0][1][layer]["shape"],
                     "splits": splits, "mean_ms": mean})
        print(f"{layer} | {tuple(rows[-1]['shape'])} | {splits[0]} / "
              f"{splits[1]} | "
              + " | ".join(f"{1e3 * mean['A'][kern]:.2f} / "
                           f"{1e3 * mean['B'][kern]:.2f}"
                           for kern in kerns))
    OUT.parent.mkdir(exist_ok=True)
    OUT.write_text(json.dumps({"trees": {k: str(v) for k, v in trees.items()},
                               "runs": runs, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
