"""Quickstart on the PyTorch port: the paper's whole loop.

1. train a small SNN (surrogate-gradient BPTT, rate coding, population
   output) on the synthetic MNIST stand-in;
2. measure layer-wise firing sparsity (paper Fig. 1);
3. run the cycle-accurate DSE over per-layer LHR (paper Table I / Fig. 6);
4. pick the smallest design inside a latency budget.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

Training and the sparsity pass run on the card unless ``--device cpu`` is
given; the accelerator model and the DSE are NumPy.  The last line gives
each phase's wall-clock seconds.
"""
import argparse
import time

import torch

from repro_torch.core import dse, encoding, snn, sparsity, train_snn
from repro_torch.core.accelerator import arch as hw
from repro_torch.core.accelerator import resources
from repro_torch.data import synthetic


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the SNN trains and runs")
    args = ap.parse_args()
    dev = torch.device(args.device)
    times = {}

    # 1. train -------------------------------------------------------------
    t0 = time.perf_counter()
    data = synthetic.make_images(n_train=1024, n_test=256)
    cfg = snn.SNNConfig(
        name="quickstart", input_shape=(28, 28),
        layers=(snn.Dense(128), snn.Dense(128), snn.Dense(10 * 10)),
        num_classes=10, pcr=10, num_steps=15)
    result = train_snn.train(cfg, data, steps=150, batch_size=64,
                             verbose=True, log_every=50, device=dev)
    print(f"\ntest accuracy: {result.test_accuracy:.3f}")
    times["train_s"] = time.perf_counter() - t0

    # 2. sparsity ----------------------------------------------------------
    t0 = time.perf_counter()
    x = torch.as_tensor(data.x_test[:64], device=dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    spikes_in = encoding.rate_encode(gen, x, cfg.num_steps)
    stats = sparsity.analyze(cfg, result.params, spikes_in)
    print("\nlayer-wise firing (paper Fig. 1):")
    print(sparsity.firing_table(stats))
    times["sparsity_s"] = time.perf_counter() - t0

    # 3. DSE ---------------------------------------------------------------
    t0 = time.perf_counter()
    traces = train_snn.dump_traces(cfg, result.params, data.x_test,
                                   device=dev)
    counts = [c.mean(axis=1) for c in traces["layer_input_spike_counts"]]
    accel = hw.from_snn_config(cfg)
    sweep = dse.sweep(accel, counts, max_lhr=64)
    print(f"\nDSE: {len(sweep.candidates)} candidates, "
          f"{len(sweep.frontier)} on the Pareto frontier")
    for c in sorted(sweep.frontier, key=lambda c: c.cycles)[:8]:
        print(f"  lhr={str(c.lhr):>14} cycles={c.cycles:>9.0f} "
              f"lut={c.lut/1e3:>7.1f}K energy={c.energy_mj:.3f} mJ")

    # 4. pick --------------------------------------------------------------
    budget = 2.0 * sorted(sweep.frontier, key=lambda c: c.cycles)[0].cycles
    best = sweep.best_within_latency(budget)
    base = resources.estimate(accel)
    print(f"\nsmallest design within 2x fastest latency: lhr={best.lhr} "
          f"-> {best.lut/1e3:.1f}K LUT "
          f"({1 - best.lut/base.lut:.0%} smaller than all-parallel), "
          f"{best.cycles:.0f} cycles/image")
    times["dse_s"] = time.perf_counter() - t0
    print("phase seconds: " + " ".join(f"{k}={v:.3f}"
                                       for k, v in times.items()))


if __name__ == "__main__":
    main()
