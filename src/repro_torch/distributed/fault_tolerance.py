"""Fault tolerance: checkpoint/restart supervision of a training loop.

On a real deployment the failure signal comes from the cluster manager
(a missing heartbeat, a collective's timeout); here the supervisor wraps
the training loop and reacts to Python exceptions identically: restore
the latest checkpoint, then continue from its step.  The state is any
tree (lists, tuples, dicts) of tensors, DTensors or NumPy arrays;
checkpoints are host-format (``repro_torch.checkpoint.store``) and restore
onto the devices of the state they replace, or, with ``shardings``, onto
a target mesh, which need not be the one they were saved from (an elastic
restart on another layout).  State on a mesh is supervised by every rank
alike: each rank runs the same steps, saves together (rank 0 writes) and
restores together.

A restart replays the steps after the checkpoint, so a supervised run
equals an unsupervised one only when ``step_fn(state, step)`` draws its
batch and its random bits from ``step`` (a generator seeded from the step
number), not from a generator that has moved on.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, Optional

from repro_torch.checkpoint import store

log = logging.getLogger(__name__)


@dataclasses.dataclass
class SupervisorConfig:
    checkpoint_dir: str
    checkpoint_every: int = 50
    keep_last: int = 3
    max_restarts: int = 10
    async_save: bool = True


class TrainSupervisor:
    """Run a step function under checkpoint/restart supervision.

    ``state``: any tree (params, opt_state, step counter...).
    ``step_fn(state, step) -> state``.  Any exception triggers a restore of
    the latest checkpoint and a restart from its step.  ``shardings``: a
    tree of ``sharding.NamedSharding`` shaped like ``state``, the layout a
    restore places the state on.
    """

    def __init__(self, cfg: SupervisorConfig, state: Any,
                 shardings: Optional[Any] = None):
        self.cfg = cfg
        self.state = state
        self.shardings = shardings
        self.restarts = 0
        self._pending = None

    def _save(self, step: int):
        if self.cfg.async_save:
            if self._pending is not None:
                self._pending.join()       # one outstanding save at a time
            self._pending = store.save_async(
                self.cfg.checkpoint_dir, step, self.state,
                keep_last=self.cfg.keep_last)
        else:
            store.save(self.cfg.checkpoint_dir, step, self.state,
                       keep_last=self.cfg.keep_last)

    def _restore(self) -> int:
        # Join the in-flight async save BEFORE picking the step: reading
        # latest_step first can select a checkpoint older than the one the
        # pending writer publishes moments later — a stale restore that
        # silently replays already-durable steps.
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if store.sharded(self.state):
            # rank 0 writes a mesh's checkpoints: wait until it has
            import torch.distributed as dist
            if dist.is_initialized():
                dist.barrier()
        step = store.latest_step(self.cfg.checkpoint_dir)
        if step is None:
            return 0
        self.state = store.restore(self.cfg.checkpoint_dir, self.state,
                                   step=step, shardings=self.shardings)
        log.warning("restored checkpoint at step %d", step)
        return step

    def run(self, step_fn: Callable[[Any, int], Any], num_steps: int) -> Any:
        step = 0
        while step < num_steps:
            try:
                while step < num_steps:
                    self.state = step_fn(self.state, step)
                    step += 1
                    if step % self.cfg.checkpoint_every == 0:
                        self._save(step)
            except KeyboardInterrupt:
                raise
            except Exception as e:            # noqa: BLE001 — node failure
                self.restarts += 1
                if self.restarts > self.cfg.max_restarts:
                    raise RuntimeError(
                        f"exceeded {self.cfg.max_restarts} restarts") from e
                log.warning("step %d failed (%s); restarting", step, e)
                step = self._restore()
        self._save(step)
        if self._pending is not None:
            self._pending.join()
        return self.state
