"""Times of the dense spike kernels of two checkouts of this repo on
one card, run A, B, B, A by ``ab.main``.

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
import sys

import ab

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


def measure() -> dict:
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    return time_all(torch)


def report(runs) -> tuple[int, list]:
    kerns = ("spike_gemm", "spike_gemm_lif", "spike_gemm_events",
             "spike_gemm_lif_events")
    rows = []
    print("layer | (M, K, N) | splits A / B | device us A / B: spike_gemm | "
          "spike_gemm_lif | between events: spike_gemm | spike_gemm_lif")
    for layer, _ in SHAPES:
        mean = {tree: {kern: ab.mean(runs, tree, layer, kern)
                       for kern in kerns} for tree in "AB"}
        splits = [dict(runs)[tree][layer]["splits"] for tree in "AB"]
        rows.append({"layer": layer, "shape": runs[0][1][layer]["shape"],
                     "splits": splits, "mean_ms": mean})
        print(f"{layer} | {tuple(rows[-1]['shape'])} | {splits[0]} / "
              f"{splits[1]} | "
              + " | ".join(f"{1e3 * mean['A'][kern]:.2f} / "
                           f"{1e3 * mean['B'][kern]:.2f}"
                           for kern in kerns))
    return 0, rows


if __name__ == "__main__":
    sys.exit(ab.main(sys.argv, __doc__, measure, report))
