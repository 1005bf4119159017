"""Times of the penc_compact kernel of two checkouts of this repo on one
card, run A, B, B, A by ``ab.main``.

    python3 penc_ab.py OTHER         # OTHER: the root of another checkout

A worker (``--worker``) imports ``repro_torch`` from the checkout given in
its PYTHONPATH, builds that checkout's kernels and times
``penc_compact_cuda`` at the input of each of net-5's five spiking layers
at batch 64, on random spikes at the rates of net-5's traffic at step 62
of 124 (``chip_smoke.py`` phase 4), at capacity N and at the ECU's chunk
of 100, four ways: ``chip_smoke.device_ms``, the profiler's time of the
call's kernels, with the input in L2 from the call before (``warm``) and
with ``chip_smoke.l2_flush`` before each call (``flushed``); one call
between two CUDA events, which also holds the wrapper's host time
(``events``); and the wall time a call of 200 calls in a row
(``in_a_row``), the larger of the host's and the device's time a call.
Every result is checked against ``ref.penc_compact_ref``.  A (this
checkout) and B (OTHER) each get the mean of their two runs; the table
goes to stdout and every run to ``chiprun_out/penc_ab.json``.
"""
import sys
import time

import ab

#: (layer, (B, N), spike rate) of net-5's layer inputs at step 62.
SHAPES = [("conv1", (64, 32768), 0.0104), ("conv2", (64, 131072), 0.103),
          ("fc1", (64, 32768), 0.179), ("fc2", (64, 512), 0.140),
          ("fc3", (64, 256), 0.146)]
CHUNK = 100
KINDS = ("warm", "flushed", "events", "in_a_row")


def in_a_row_ms(torch, fn, calls=200):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e3


def measure() -> dict:
    """``{"<layer> cap <c>": {"warm": ms, "flushed": ms, "events": ms,
    "in_a_row": ms}}`` for this process's ``repro_torch``."""
    import importlib

    import torch

    from chip_smoke import device_ms, l2_flush, median_ms
    from repro_torch.kernels import build, ref
    penc = importlib.import_module("repro_torch.kernels.penc_compact")
    build.build_all()
    dev = torch.device("cuda")
    flush = l2_flush(torch, dev)
    times = {}
    for seed, (layer, (b, n), rate) in enumerate(SHAPES):
        gen = torch.Generator(device=dev).manual_seed(seed)
        rows = (torch.rand(b, n, generator=gen, device=dev) < rate).float()
        for cap in (n, CHUNK):
            def call():
                return penc.penc_compact_cuda(rows, cap)
            got, want = call(), ref.penc_compact_ref(rows, cap)
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"{layer} capacity {cap}: penc_compact "
                                     f"differs from its plain version")
            key = f"{layer} cap {cap}"
            times[key] = {"warm": device_ms(torch, call),
                          "flushed": device_ms(torch, call, flush=flush),
                          "events": median_ms(torch, call),
                          "in_a_row": in_a_row_ms(torch, call)}
            if None in times[key].values():
                raise RuntimeError(f"{key}: the profiler saw no kernel")
    return times


def report(runs) -> tuple[int, list]:
    rows = []
    print("layer, capacity | ms A / B: device warm | device flushed | "
          "between events | wall a call in a row")
    for key in runs[0][1]:
        mean = {tree: {k: ab.mean(runs, tree, key, k) for k in KINDS}
                for tree in "AB"}
        rows.append({"case": key, "mean_ms": mean})
        print(f"{key} | " + " | ".join(
            f"{mean['A'][k]:.5f} / {mean['B'][k]:.5f}" for k in KINDS))
    for label, chunk in (("N", False), (str(CHUNK), True)):
        cases = [r for r in rows
                 if r["case"].endswith(f" cap {CHUNK}") == chunk]
        for tree in "AB":
            print(f"{tree}, the five layers at capacity {label}, ms: "
                  + ", ".join(f"{k} {sum(r['mean_ms'][tree][k] for r in cases):.5f}"
                              for k in KINDS))
    return 0, rows


if __name__ == "__main__":
    sys.exit(ab.main(sys.argv, __doc__, measure, report, timeout=600))
