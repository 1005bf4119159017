"""Times of the backward's kernels and of net-5's training step for two
checkouts of this repo on one card, run A, B, B, A by ``ab.main``.

    python3 bwd_ab.py OTHER        # OTHER: the root of another checkout

A worker (``--worker``) imports ``repro_torch`` from the checkout given in
its PYTHONPATH, builds that checkout's kernels and times, with
``chip_smoke.device_ms`` (the profiler's device time a call, every kernel
the call launches) and ``chip_smoke.median_ms`` (one call between two CUDA
events):
- the dense dW and dS through ``ops.spike_gemm_bwd_dw`` / ``_ds`` at every
  dense layer of net-5, the dvs-conv cell and the mnist-mlp cell at batch
  64 (spikes at 15%, a dense normal cotangent, as net-5's fc1 sees);
- the input gradient of net-5's conv2 and of dvs-conv's second conv, whole:
  ``ops.spike_conv_bwd_ds`` where the checkout has it, else the matrix dS
  in patch space and ``conv_col2im``, as PR 15's backward ran it; the
  cotangent 65% nonzero;
- one net-5 training step at B = 64, T = 124 on the default backend
  (seeded grid weights, as ``chip_smoke.py`` makes them): the forward's and
  the backward's seconds (host clock, synchronised; the median of 3 after
  a warm-up), the backward's device time and kernels from the profiler,
  and ``evaluate`` + ``dump_traces``'s seconds (the median of 2).
A (this checkout) and B (OTHER) each get the mean of their two runs; the
table goes to stdout and every run to ``chiprun_out/bwd_ab.json``.
"""
import math
import statistics
import sys
import time

import ab

DENSITY = 0.15
COTANGENT_DENSITY = 0.65
#: (layer, (M, K, N)) of every dense layer of the repo's cells at batch 64.
DENSE = [("net-5 fc1", (64, 32768, 512)), ("net-5 fc2", (64, 512, 256)),
         ("net-5 fc3", (64, 256, 11)), ("dvs-conv fc1", (64, 1024, 64)),
         ("dvs-conv fc2", (64, 64, 16)), ("mnist-mlp fc1", (64, 784, 128)),
         ("mnist-mlp fc2", (64, 128, 128)), ("mnist-mlp fc3", (64, 128, 40))]
#: (layer, (B, H, W, C), F) of the convs whose input gradient a training
#: step computes (3 x 3, stride 1, SAME).
CONV = [("net-5 conv2", (64, 64, 64, 32), 32),
        ("dvs-conv conv2", (64, 16, 16, 8), 16)]


def time_kernels(torch, device_ms, median_ms) -> dict:
    from repro_torch.kernels import ops
    from repro_torch.kernels.spike_conv import conv_col2im
    dev = torch.device("cuda")
    times = {}
    for seed, (layer, (m, k, n)) in enumerate(DENSE):
        gen = torch.Generator(device=dev).manual_seed(seed)
        s = (torch.rand(m, k, generator=gen, device=dev) < DENSITY).float()
        g = torch.randn(m, n, generator=gen, device=dev)
        w = torch.randn(k, n, generator=gen, device=dev) / k ** 0.5
        flags = ops.block_flags(s)
        calls = {"dw": lambda: ops.spike_gemm_bwd_dw(s, g, flags=flags),
                 "ds": lambda: ops.spike_gemm_bwd_ds(g, w)}
        times[layer] = {"shape": [m, k, n]}
        for kind, call in calls.items():
            times[layer][kind] = device_ms(torch, call)
            times[layer][kind + "_events"] = median_ms(torch, call)
    for seed, (layer, x_shape, f) in enumerate(CONV):
        gen = torch.Generator(device=dev).manual_seed(100 + seed)
        b, h, wd, c = x_shape
        g = torch.randn((b, h, wd, f), generator=gen, device=dev) * (
            torch.rand((b, h, wd, f), generator=gen, device=dev)
            < COTANGENT_DENSITY)
        w = torch.randn((3, 3, c, f), generator=gen, device=dev)
        if hasattr(ops, "spike_conv_bwd_ds"):
            call = lambda: ops.spike_conv_bwd_ds(g, w, x_shape)
        else:
            call = lambda: conv_col2im(
                ops.spike_gemm_bwd_ds(g.reshape(-1, f), w.reshape(-1, f)),
                x_shape, 3, 3, 1, "SAME")
        times[layer] = {"shape": [*x_shape, f], "ds": device_ms(torch, call),
                        "ds_events": median_ms(torch, call)}
    return times


def time_training(torch) -> dict:
    """One net-5 training step and the inference leg, as chip_smoke.py
    drives them on the default backend."""
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from repro_torch.core import snn, train_snn
    from repro_torch.data import synthetic
    dev = torch.device("cuda")
    cfg = snn.SNNConfig(
        "net-5", (128, 128, 2),
        (snn.Conv(32, 3), snn.MaxPool(2), snn.Conv(32, 3), snn.MaxPool(2),
         snn.Dense(512), snn.Dense(256), snn.Dense(11)),
        num_classes=11, pcr=1, num_steps=cs.NUM_STEPS)
    data = synthetic.make_events(name="synth-dvs-net5", seed=cs.SEED,
                                 num_classes=11, n_train=2, n_test=cs.BATCH,
                                 t=cs.NUM_STEPS, h=128, w=128)
    params = snn.init_params(torch.Generator().manual_seed(cs.SEED), cfg,
                             device=dev)
    scale = 2.0 ** cs.GRID_BITS
    gains = iter(cs.GAINS)
    for p in params:
        if p:
            p["w"] = torch.round(p["w"] * next(gains) * scale) / scale
    xb = torch.as_tensor(data.x_test[:cs.TRAIN_BATCH], device=dev)
    yb = torch.as_tensor(data.y_test[:cs.TRAIN_BATCH], device=dev)
    enc = torch.Generator(device=dev)
    leaves = [{k: v.detach().clone().requires_grad_() for k, v in p.items()}
              for p in params]
    flat = [v for p in leaves for v in p.values()]

    def step():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = train_snn.loss_fn(cfg, leaves, enc, xb, yb)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        torch.autograd.grad(loss, flat)
        torch.cuda.synchronize()
        return loss.item(), t1 - t0, time.perf_counter() - t1

    runs = [step() for _ in range(4)][1:]
    loss = train_snn.loss_fn(cfg, leaves, enc, xb, yb)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.autograd.grad(loss, flat)
        torch.cuda.synchronize()
    del loss
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]

    def infer():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_snn.evaluate(cfg, params, data.x_test, data.y_test)
        train_snn.dump_traces(cfg, params, data.x_test, max_samples=cs.BATCH)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    infer()
    return {"loss": runs[0][0],
            "forward_s": statistics.median(r[1] for r in runs),
            "backward_s": statistics.median(r[2] for r in runs),
            "backward_device_ms": sum(e.device_time_total
                                      for e in kernels) / 1e3,
            "backward_kernels": len(kernels),
            "evaluate_dump_traces_s": statistics.median(
                infer() for _ in range(2))}


def measure() -> dict:
    import torch

    from chip_smoke import device_ms, median_ms
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build_all()
    out = time_kernels(torch, device_ms, median_ms)
    out["training"] = time_training(torch)
    return out


def report(runs) -> tuple[int, dict]:
    rows = {}
    print("layer | device ms A / B | between events ms A / B")
    for layer, _ in DENSE + [(c[0], None) for c in CONV]:
        for kind in ("dw", "ds"):
            if kind not in runs[0][1][layer]:
                continue
            row = {tree: {"device_ms": ab.mean(runs, tree, layer, kind),
                          "events_ms": ab.mean(runs, tree, layer,
                                               kind + "_events")}
                   for tree in "AB"}
            rows[f"{layer} {kind}"] = row
            print(f"{layer} {kind} | {row['A']['device_ms']:.5f} / "
                  f"{row['B']['device_ms']:.5f} | "
                  f"{row['A']['events_ms']:.5f} / "
                  f"{row['B']['events_ms']:.5f}")
    for key in ("forward_s", "backward_s", "backward_device_ms",
                "backward_kernels", "evaluate_dump_traces_s"):
        rows[key] = {tree: ab.mean(runs, tree, "training", key)
                     for tree in "AB"}
        print(f"training {key} | {rows[key]['A']:.4f} / "
              f"{rows[key]['B']:.4f}")
    losses = {r["training"]["loss"] for _, r in runs}
    print(f"losses {sorted(losses)}")
    if len(losses) != 1 or not all(math.isfinite(v) for v in losses):
        print("the two checkouts' losses differ", file=sys.stderr)
        return 1, rows
    return 0, rows


if __name__ == "__main__":
    sys.exit(ab.main(sys.argv, __doc__, measure, report))
