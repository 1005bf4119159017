"""Elastic cell-fleet walkthrough on the PyTorch port: spawned workers
drain a cluster study through the shared cache root, and one of them dies
mid-run.

    PYTHONPATH=src python examples/torch_fleet_workers.py [--device cpu]

Two ``fleet.run_worker`` processes enroll against a shared trace-cache
root, the only coordination substrate there is: pending cells spool to
``<root>/queue/`` as wire-format jobs, each worker claims one by
atomically creating ``<root>/<key>/.lease`` (its mtime is the worker's
heartbeat) and publishes through the content-addressed ``TraceCache``.
The submitting study just calls ``dse.explore(workers="cluster")``: it
blocks on lease/publish progress and would reclaim any cell whose
heartbeat went stale (a SIGKILL'd worker, simulated below), training it
in process on the cache's device, so the study completes no matter how
much of the fleet survives.  The workers and the study run on the card
unless ``--device cpu`` is given; a fleet's root holds this package's
cells only.
"""
import argparse
import dataclasses
import multiprocessing
import os
import signal
import tempfile
import threading
import time

from repro_torch.core import dse, snn, workloads
from repro_torch.distributed import fleet


def tiny(name):
    return dataclasses.replace(
        workloads.get("mnist-mlp"), name=name,
        layers=(snn.Dense(16),), pcr=1,
        n_train=128, n_test=64, train_steps=6, trace_samples=16)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the workers and the study train cells")
    args = ap.parse_args()
    wl = tiny("fleet-example-mlp")
    with tempfile.TemporaryDirectory() as root:
        cache = workloads.TraceCache(root=root, device=args.device)
        ctx = multiprocessing.get_context("spawn")   # CUDA is not fork-safe
        workers = [ctx.Process(
            target=fleet.run_worker,
            kwargs=dict(root=root, worker_id=f"host-{i}", idle_timeout=20,
                        stats_path=os.path.join(root, f"stats-{i}.json"),
                        device=args.device))
            for i in range(2)]
        for w in workers:
            w.start()

        # kill one worker a few seconds in: its lease goes stale and the
        # cell it was holding is reclaimed by a peer or the submitter
        def assassin():
            time.sleep(8)
            if workers[0].is_alive():
                os.kill(workers[0].pid, signal.SIGKILL)
                print("** worker host-0 SIGKILL'd mid-study **")

        threading.Thread(target=assassin, daemon=True).start()

        study = dse.explore(
            workload=wl, num_steps=(2, 3), population=(0.5, 1.0),
            max_lhr=4, weight_bits=(4, 8), cache=cache, workers="cluster")

        for w in workers:
            w.join(timeout=60)
        print(f"study complete: {study.summary['cells_resolved']} cells "
              f"resolved, frontier size {len(study.frontier)}")
        print(f"every cell loaded from the shared root: {cache.stats}")


if __name__ == "__main__":
    main()
