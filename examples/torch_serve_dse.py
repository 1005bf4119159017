"""DSE-as-a-service walkthrough on the PyTorch port: two tenants,
overlapping search spaces, one warm cache, streamed Pareto frontiers.

    PYTHONPATH=src python examples/torch_serve_dse.py [--device cpu]

Tenant *alpha* and tenant *beta* each submit a joint model x hardware
co-exploration study.  Their model-cell grids overlap on (T=2,3) x
(pop=0.5): the service resolves every cell through one shared
content-addressed ``TraceCache``, so whichever tenant reaches an
overlapping cell first trains it and the other gets a cache hit.  Both
studies step concurrently (round-robin) on the service scheduler, and
each tenant watches its own typed event stream: monotone
``FrontierUpdate`` snapshots plus ``Progress`` cache/budget counters.
Cells train on the card unless ``--device cpu`` is given.
"""
import argparse
import dataclasses
import tempfile

from repro_torch.core import snn, workloads
from repro_torch.serve import (DSEService, FrontierUpdate, Progress,
                               StudyCompleted, Submission)


def tiny(name):
    return dataclasses.replace(
        workloads.get("mnist-mlp"), name=name,
        layers=(snn.Dense(16),), pcr=1,
        n_train=128, n_test=64, train_steps=6, trace_samples=16)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the service's cache trains cells")
    args = ap.parse_args()
    wl = tiny("serve-dse-mlp")
    with tempfile.TemporaryDirectory() as root:
        cache = workloads.TraceCache(root=f"{root}/cells",
                                     device=args.device)
        service = DSEService(cache, checkpoint_root=f"{root}/studies",
                             max_active=2, tenant_quota=16)

        # overlapping grids: both tenants want T in (2,3) at pop 0.5;
        # alpha also sweeps pop 1.0, beta also sweeps T=4
        alpha = service.submit(Submission(
            tenant="alpha", name="sweep", workload=wl,
            num_steps=(2, 3), population=(0.5, 1.0),
            max_lhr=4, weight_bits=(4, 8)))
        beta = service.submit(Submission(
            tenant="beta", name="sweep", workload=wl,
            num_steps=(2, 3, 4), population=(0.5,),
            max_lhr=4, weight_bits=(4, 8)))

        service.run_until_idle()

        for handle in (alpha, beta):
            print(f"\n=== {handle.study_id} ===")
            for event in handle.events():
                if isinstance(event, FrontierUpdate):
                    print(f"  round {event.round}: frontier -> "
                          f"{event.frontier_size} points over "
                          f"{event.objectives}")
                elif isinstance(event, Progress):
                    c = event.cache
                    print(f"  round {event.round}: cells "
                          f"{event.cells_resolved} resolved, cache "
                          f"{c.get('hits', 0)} hits / "
                          f"{c.get('misses', 0)} misses, budget "
                          f"{event.budget}")
                elif isinstance(event, StudyCompleted):
                    print(f"  completed: {event.summary['n_evaluated']} "
                          f"candidates, frontier "
                          f"{event.summary['frontier_size']}")
                else:
                    print(f"  {type(event).__name__}")

        stats = service.stats
        print(f"\nservice: {stats['completed']} studies, "
              f"{stats['events_emitted']} events, cache hit rate "
              f"{stats['cache']['hit_rate']:.2f} "
              f"({stats['cache']['hits']} hits / "
              f"{stats['cache']['misses']} misses)")
        # 5 distinct cells across both grids, 7 resolutions: the two
        # overlapping cells trained once and hit once
        if stats["cache"]["misses"] != 5:
            raise SystemExit(f"expected 5 misses, got {stats['cache']}")


if __name__ == "__main__":
    main()
