"""End-to-end paper pipeline (Sec. IV, all five phases) on the synthetic
datasets, on the PyTorch port: Training -> Configuration -> Architecture
Generation -> Simulation & VALIDATION (exact spike-to-spike, fixed-point)
-> Evaluation.

    PYTHONPATH=src python examples/torch_train_snn_dse.py [--dataset dvs] \
        [--device cpu]

Training, traces and co-exploration cells run on the card unless
``--device cpu`` is given; the fixed-point validator, the accelerator model
and the DSE are NumPy.  The last line gives each phase's wall-clock
seconds.
"""
import argparse
import dataclasses
import tempfile
import time

import numpy as np
import torch

from repro_torch.core import dse, encoding, snn, train_snn, validate, workloads
from repro_torch.core.accelerator import arch as hw
from repro_torch.core.accelerator import cycle_model, resources
from repro_torch.data import synthetic


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="mnist", choices=["mnist", "dvs"])
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--coexplore", action="store_true",
                    help="also run the joint model x hardware co-exploration "
                         "walkthrough (trains several small model cells)")
    ap.add_argument("--device", default="cuda",
                    help="where cells train and spike traces are taken")
    args = ap.parse_args()
    dev = torch.device(args.device)
    times = {}
    t0 = time.perf_counter()

    # ---- Training Phase ----
    if args.dataset == "mnist":
        data = synthetic.make_images(n_train=1024, n_test=256)
        cfg = snn.SNNConfig(
            name="net", input_shape=(28, 28),
            layers=(snn.Dense(128), snn.Dense(128), snn.Dense(10 * 10)),
            num_classes=10, pcr=10, num_steps=15)
    else:
        data = synthetic.make_events(n_train=256, n_test=64, t=12)
        cfg = snn.SNNConfig(
            name="net", input_shape=(32, 32, 2),
            layers=(snn.Conv(8, 3), snn.MaxPool(2), snn.Conv(8, 3),
                    snn.MaxPool(2), snn.Dense(64), snn.Dense(8 * 4)),
            num_classes=8, pcr=4, num_steps=12)
    res = train_snn.train(cfg, data, steps=args.steps, batch_size=64,
                          verbose=True, log_every=50, device=dev)
    print(f"accuracy: {res.test_accuracy:.3f}")
    times["train_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # ---- Configuration Phase: dump spikes + weights ----
    counts = train_snn.trace_counts(cfg, res.params, data.x_test, device=dev)

    # ---- Architecture Generation ----
    accel = hw.from_snn_config(cfg)

    # ---- Simulation & Validation: exact spike-to-spike (MLP datapath) ----
    if args.dataset == "mnist":
        weights = [p["w"].cpu().numpy() for p in res.params]
        biases = [p["b"].cpu().numpy() for p in res.params]
        fp = validate.quantize(weights, biases, beta=0.95, threshold=1.0)
        x = torch.as_tensor(np.asarray(data.x_test[0]).reshape(-1),
                            device=dev)
        spikes = encoding.rate_encode(
            torch.Generator(device=dev).manual_seed(0), x[None],
            cfg.num_steps)[:, 0].cpu().numpy()
        ok = validate.validate(fp, spikes.astype(np.int64),
                               lhr=[4, 8, 8][:len(weights)])
        print(f"spike-to-spike validation (fixed-point, serial HW model): "
              f"{'PASS' if ok else 'FAIL'}")
        assert ok
    times["trace_validate_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # ---- Evaluation Phase: DSE ----
    sweep = dse.sweep(accel, counts, max_lhr=64)
    base = resources.estimate(accel)
    base_cycles = float(cycle_model.latency_cycles(accel, counts))
    print(f"\nall-parallel baseline: {base.lut/1e3:.1f}K LUT, "
          f"{base_cycles:.0f} cycles")
    print(f"{'lhr':>16} {'cycles':>10} {'LUT':>9} {'energy':>9}")
    for c in sorted(sweep.frontier, key=lambda c: c.cycles)[:10]:
        print(f"{str(c.lhr):>16} {c.cycles:>10.0f} {c.lut/1e3:>8.1f}K "
              f"{c.energy_mj:>8.3f}mJ")
    best = sweep.min_energy()
    print(f"\nmin-energy config: lhr={best.lhr} "
          f"({1-best.lut/base.lut:.0%} fewer LUTs, "
          f"{best.cycles/base_cycles:.1f}x latency)")

    # ---- Joint multi-axis DSE (the unified ask/tell front end) ----
    # How to define a search space (see DESIGN.md §8/§10 and the
    # repro_torch.core.dse package docstring):
    #   * add_per_layer — independent options per layer (Cartesian product);
    #   * add_joint     — options are whole per-layer vectors (all layers
    #                     move together);
    #   * add_global    — one value applied to every layer.
    # ``dse.search`` is an exact thin wrapper over ``dse.explore``: the
    # ask/tell loop streams digit chunks through the vectorized cycle
    # model + component library and retains only the k-objective Pareto
    # frontier (call ``dse.explore`` directly for budgets, checkpoints, or
    # workers — see the co-exploration section below).
    space = (dse.SearchSpace(accel)
             .add_per_layer("lhr", [dse.pow2_values(min(32, l.logical))
                                    for l in accel.layers])
             .add_joint("mem_blocks",
                        [tuple(max(1, l.num_nus // d) for l in accel.layers)
                         for d in (1, 2, 4)])
             .add_global("weight_bits", (4, 6, 8)))
    result = dse.search(accel, counts, space,
                        objectives=("cycles", "lut", "bram", "energy"))
    print(f"\njoint DSE over LHR x mem_blocks x weight_bits: "
          f"{result.n_evaluated} candidates, "
          f"{len(result.frontier)} on the 4-objective frontier")
    fr = result.frontier.sorted_by("cycles")
    print(f"{'lhr':>16} {'mem':>14} {'bits':>4} {'cycles':>10} "
          f"{'LUT':>8} {'BRAM':>5} {'energy':>9}")
    for i in range(min(8, len(fr))):
        r = fr.row(i)
        print(f"{str(r['lhr']):>16} {str(r['mem_blocks']):>14} "
              f"{r['weight_bits']:>4} {r['cycles']:>10.0f} "
              f"{r['lut']/1e3:>7.1f}K {r['bram']:>5} "
              f"{r['energy']:>8.3f}mJ")
    # budget pick + materialized hardware config for the winner
    row = result.best_within_latency(2.0 * base_cycles)
    if row is not None:
        hw_cfg = result.config_for(row)
        print(f"\nsmallest joint design within 2x baseline latency: "
              f"lhr={row['lhr']} mem={row['mem_blocks']} "
              f"bits={row['weight_bits']} -> {row['lut']/1e3:.1f}K LUT, "
              f"{row['bram']} BRAM ({hw_cfg.layers[0].weight_bits}-bit "
              f"weights)")
        # accuracy leg of the weight_bits axis (fixed-point datapath)
        if args.dataset == "mnist":
            xb = torch.as_tensor(np.asarray(data.x_test[:64]).reshape(64, -1),
                                 device=dev)
            spikes_b = encoding.rate_encode(
                torch.Generator(device=dev).manual_seed(1), xb,
                cfg.num_steps).cpu().numpy().astype(np.int64)
            acc_q = validate.quantized_accuracy(
                weights, biases,
                spikes_b, data.y_test[:64], num_classes=10,
                frac_bits=int(row["weight_bits"]) - 1)
            print(f"fixed-point accuracy at {row['weight_bits']} bits: "
                  f"{acc_q:.3f} (float: {res.test_accuracy:.3f})")

    times["dse_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # ---- Model x hardware co-exploration (the paper's headline loop) ----
    # Model parameters (spike-train length T, neuron population scale)
    # become searchable axes: each model cell trains once through the
    # content-addressed trace cache, then its hardware subspace streams
    # through the same chunked evaluator, with accuracy (as ``error`` =
    # 1 - accuracy) a first-class Pareto objective.  See DESIGN.md §9-§10.
    if args.coexplore:
        wl = dataclasses.replace(
            workloads.get("mnist-mlp"), name="example-co",
            layers=(snn.Dense(48),), pcr=2,
            n_train=512, n_test=128, train_steps=60)
        with tempfile.TemporaryDirectory() as root:
            co = dse.coexplore(wl, num_steps=(4, 8), population=(0.5, 1.0),
                               max_lhr=8, weight_bits=(4, 8),
                               cache=workloads.TraceCache(root=root,
                                                         device=dev))
            print(f"\nco-exploration: {len(co.cells)} model cells "
                  f"({co.cache_stats['misses']} trained), "
                  f"{co.n_evaluated} hardware candidates, "
                  f"{len(co.frontier)} on the accuracy-aware frontier")
            print(f"{'T':>3} {'pop':>5} {'lhr':>10} {'bits':>4} "
                  f"{'acc':>6} {'cycles':>8} {'LUT':>8}")
            fr = co.frontier.sorted_by("cycles")
            for i in range(min(8, len(fr))):
                r = fr.row(i)
                print(f"{r['num_steps']:>3} {r['population']:>5.2g} "
                      f"{str(r['lhr']):>10} {r['weight_bits']:>4} "
                      f"{r['accuracy']:>6.3f} {r['cycles']:>8.0f} "
                      f"{r['lut']/1e3:>7.1f}K")

            # Budgeted NAS-style loop (DESIGN.md §10): an evolutionary
            # strategy over the FULL joint digit space decides which cells
            # are worth training — at most train_budget cache misses (the
            # cells above are already cached, so this costs nothing here).
            tmpl = hw.from_snn_config(wl.build(4, 1.0))
            jspace = (dse.SearchSpace(tmpl)
                      .add_model("num_steps", (4, 8))
                      .add_model("population", (0.5, 1.0))
                      .add_per_layer("lhr", [dse.pow2_values(8)
                                             for _ in tmpl.layers])
                      .add_global("weight_bits", (4, 8)))
            budgeted = dse.explore(
                jspace, workload=wl, train_budget=4,
                cache=workloads.TraceCache(root=root, device=dev),
                strategy=dse.EvolutionarySearch(population=16,
                                                generations=4, seed=0))
            print(f"\nbudgeted explore: {budgeted.summary}")
        times["coexplore_s"] = time.perf_counter() - t0
    print("phase seconds: " + " ".join(f"{k}={v:.3f}"
                                       for k, v in times.items()))


if __name__ == "__main__":
    main()
