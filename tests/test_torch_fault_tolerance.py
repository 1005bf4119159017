"""The port's checkpoint store on tensor trees and its training supervisor
(``repro_torch.checkpoint.store``, ``repro_torch.distributed.
fault_tolerance``) on the CPU.

The store: tensors round-trip at their dtype and device, ``save_async``
snapshots a tensor before its thread starts (an in-place update after the
call cannot reach the checkpoint), and either package restores the
other's checkpoints.  The supervisor: the reference's three cases (it
recovers, it gives up after ``max_restarts``, a restore joins the
in-flight save first), and a supervised SNN training run with one
injected failure equal bit for bit to the unsupervised run; each step
draws its batch and its rate code from the step number, so a replay after
the restore draws the same bits."""
import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from repro.checkpoint import store as jax_store
from repro_torch import optim
from repro_torch.checkpoint import store
from repro_torch.core import snn, train_snn, workloads
from repro_torch.data import synthetic
from repro_torch.distributed.fault_tolerance import (SupervisorConfig,
                                                     TrainSupervisor)

torch.set_num_threads(2)


def _tensor_tree():
    adam = optim.adam(1e-3)
    params = [{"w": torch.arange(12.0).reshape(3, 4),
               "b": torch.ones(4, dtype=torch.float64)}, {}]
    return {"params": params, "opt": adam.init(params),
            "step": torch.tensor(3, dtype=torch.int32),
            "mask": torch.tensor([1, 0, 1], dtype=torch.int16)}


def _flat(tree):
    return [np.asarray(x.cpu()) if isinstance(x, torch.Tensor) else x
            for x in store.leaves(tree)]


class TestCheckpoint:
    def test_roundtrip_identity(self, tmp_path):
        tree = _tensor_tree()
        store.save(str(tmp_path), 7, tree)
        out = store.restore(str(tmp_path), tree)
        assert type(out["opt"][0]) is type(tree["opt"][0])  # NamedTuple
        for x, y in zip(store.leaves(tree), store.leaves(out)):
            assert isinstance(y, torch.Tensor) and y.dtype == x.dtype
            assert y.shape == x.shape
            torch.testing.assert_close(y, x, rtol=0, atol=0)

    def test_retention_and_latest(self, tmp_path):
        tree = {"x": torch.zeros(3)}
        for s in (1, 2, 3, 4):
            store.save(str(tmp_path), s, tree, keep_last=2)
        assert store.all_steps(str(tmp_path)) == [3, 4]
        assert store.latest_step(str(tmp_path)) == 4

    def test_async_save(self, tmp_path):
        tree = {"x": torch.arange(1000.0)}
        t = store.save_async(str(tmp_path), 1, tree)
        t.join()
        out = store.restore(str(tmp_path), tree)
        torch.testing.assert_close(out["x"], tree["x"], rtol=0, atol=0)

    def test_async_save_snapshots_before_an_in_place_update(
            self, tmp_path, monkeypatch):
        """The writer thread is held until the caller has changed the
        tensor in place: the checkpoint still holds the values at the
        call."""
        go = threading.Event()
        write = store._write

        def held(*args):
            assert go.wait(timeout=30)
            return write(*args)

        monkeypatch.setattr(store, "_write", held)
        x = torch.arange(6.0)
        t = store.save_async(str(tmp_path), 1, {"x": x, "y": [x * 2]})
        x.add_(100.0)
        go.set()
        t.join(timeout=30)
        assert not t.is_alive()
        out = store.restore(str(tmp_path), {"x": x, "y": [x]})
        torch.testing.assert_close(out["x"], torch.arange(6.0), rtol=0,
                                   atol=0)
        torch.testing.assert_close(out["y"][0], torch.arange(6.0) * 2,
                                   rtol=0, atol=0)

    def test_restore_takes_each_like_leafs_dtype_and_device(self, tmp_path):
        store.save(str(tmp_path), 0, {"a": np.arange(4, dtype=np.float32),
                                      "b": np.arange(3, dtype=np.int32),
                                      "c": np.ones((2, 2), np.float32)})
        like = {"a": torch.zeros(4, dtype=torch.float64),
                "b": torch.zeros(3, dtype=torch.int64, device="meta"),
                "c": np.zeros((2, 2), np.float16)}
        out = store.restore(str(tmp_path), like)
        assert out["a"].dtype == torch.float64 and out["a"].device.type == \
            "cpu"
        torch.testing.assert_close(out["a"], torch.arange(4.0,
                                                          dtype=torch.float64))
        assert out["b"].dtype == torch.int64 and out["b"].device.type == \
            "meta"
        assert isinstance(out["c"], np.ndarray) and out["c"].dtype == \
            np.float16
        with pytest.raises(ValueError, match="shape"):
            store.restore(str(tmp_path), {**like, "a": torch.zeros(5)})

    @pytest.mark.parametrize("writer", ["torch", "jax"])
    def test_checkpoints_restore_across_packages(self, tmp_path, writer):
        """A checkpoint written by either package restores in the other
        to equal arrays at the target's dtypes."""
        tree = {"w": [np.arange(12, dtype=np.float32).reshape(3, 4),
                      np.full(2, 7, np.int32)],
                "pair": (np.float32(2.5) * np.ones(3, np.float32),
                         np.arange(5, dtype=np.int32)),
                "z": np.zeros((), np.float32)}
        if writer == "torch":
            store.save(str(tmp_path), 3, {
                k: [torch.from_numpy(a) for a in v] if k == "w" else v
                for k, v in tree.items()})
            out = jax_store.restore(str(tmp_path), tree, device=False)
        else:
            jax_store.save(str(tmp_path), 3, tree)
            out = store.restore(str(tmp_path), tree)
        for want, got in zip(store.leaves(tree), store.leaves(out)):
            assert isinstance(got, np.ndarray) and got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


    @pytest.mark.parametrize("writer", ["torch", "jax"])
    def test_bf16_leaves_round_trip_across_packages(self, tmp_path, writer):
        """A bf16 tensor (a bf16 LM's params) is saved as its 16-bit words
        under the dtype name ``bfloat16``, as the JAX package saves its
        bf16 arrays: it restores bit for bit in this package and in the
        other, either way."""
        import jax.numpy as jnp
        import ml_dtypes

        vals = np.array([[1.0, -0.00390625, 3.140625], [65280.0, 0.0,
                                                          -2.5]],
                        np.float32)
        t = {"w": torch.from_numpy(vals).to(torch.bfloat16),
             "s": torch.tensor(0.5, dtype=torch.bfloat16)}
        if writer == "torch":
            store.save(str(tmp_path), 1, t)
            back = store.restore(str(tmp_path), t)
            for k in t:
                assert back[k].dtype == torch.bfloat16
                assert torch.equal(back[k], t[k])
            like = {k: np.zeros(tuple(v.shape), ml_dtypes.bfloat16)
                    for k, v in t.items()}
            out = jax_store.restore(str(tmp_path), like, device=False)
            for k in t:
                np.testing.assert_array_equal(
                    np.asarray(out[k], np.float32), t[k].float().numpy())
        else:
            jax_store.save(str(tmp_path), 1, {
                k: jnp.asarray(v.float().numpy(), jnp.bfloat16)
                for k, v in t.items()})
            out = store.restore(str(tmp_path), {k: torch.zeros_like(v)
                                                for k, v in t.items()})
            for k in t:
                assert out[k].dtype == torch.bfloat16
                assert torch.equal(out[k], t[k])


class TestFaultTolerance:
    def test_supervisor_recovers_from_failures(self, tmp_path):
        state = {"w": torch.zeros(4), "step": torch.tensor(0)}
        crashed = {"flag": False}

        def step_fn(state, step):
            if step == 7 and not crashed["flag"]:
                crashed["flag"] = True          # simulated node failure
                raise RuntimeError("node lost")
            return {"w": state["w"] + 1.0, "step": state["step"] + 1}

        sup = TrainSupervisor(
            SupervisorConfig(checkpoint_dir=str(tmp_path),
                             checkpoint_every=2, async_save=False),
            state)
        final = sup.run(step_fn, num_steps=10)
        # restart must not lose or duplicate steps: w ends at exactly 10
        assert float(final["w"][0]) == 10.0 and int(final["step"]) == 10
        assert sup.restarts == 1

    def test_supervisor_gives_up_after_max_restarts(self, tmp_path):
        def bad_step(state, step):
            raise RuntimeError("always fails")

        sup = TrainSupervisor(
            SupervisorConfig(checkpoint_dir=str(tmp_path), max_restarts=2,
                             async_save=False), {"x": torch.zeros(1)})
        with pytest.raises(RuntimeError, match="exceeded 2 restarts"):
            sup.run(bad_step, num_steps=5)

    def test_restore_joins_inflight_async_save_first(self, tmp_path,
                                                     monkeypatch):
        """With a save that publishes step 4 only after a delay, a restore
        must still pick 4, not the older durable 2."""
        def slow_save_async(path, step, state, keep_last=3):
            def _write():
                time.sleep(0.5)              # the slow network store
                store.save(path, step, state, keep_last=keep_last)
            t = threading.Thread(target=_write)
            t.start()
            return t

        monkeypatch.setattr(store, "save_async", slow_save_async)
        state = {"w": torch.arange(3.0)}
        sup = TrainSupervisor(
            SupervisorConfig(checkpoint_dir=str(tmp_path),
                             checkpoint_every=2, async_save=True), state)
        store.save(str(tmp_path), 2, state)  # an older durable checkpoint
        sup._save(4)                         # in flight for the next 0.5s
        step = sup._restore()                # "node failure" mid-save
        assert step == 4                     # joined the writer, not stale
        assert sup._pending is None
        assert store.latest_step(str(tmp_path)) == 4

    def test_supervised_snn_training_equals_unsupervised(self, tmp_path):
        """Adam steps of a tiny SNN cell under the supervisor, async saves
        every 3 steps and one failure at step 5: the final params and
        optimizer state equal the unsupervised run's bit for bit."""
        wl = dataclasses.replace(
            workloads.get("mnist-mlp"), name="supervised-wl",
            layers=(snn.Dense(12),), pcr=1, input_shape=(12, 12),
            n_train=96, n_test=32, batch_size=32)
        cfg = wl.build(2, 1.0)
        tx = optim.adam(wl.lr)
        train_step = train_snn.make_train_step(cfg, tx)
        data = wl.make_data(2)
        it = synthetic.batches(data.x_train, data.y_train, wl.batch_size,
                               seed=0, epochs=100)
        batches = [tuple(torch.as_tensor(a) for a in next(it))
                   for _ in range(8)]

        def step_fn(state, step):
            gen = torch.Generator().manual_seed(1000 + step)
            params, opt_state, _ = train_step(state["params"], state["opt"],
                                              gen, *batches[step])
            return {"params": params, "opt": opt_state}

        def start():
            params, opt_state, _ = train_snn.init_cell(cfg, tx, 0,
                                                       device="cpu")
            return {"params": params, "opt": opt_state}

        plain = start()
        for step in range(8):
            plain = step_fn(plain, step)

        failed = []

        def flaky(state, step):
            if step == 5 and not failed:
                failed.append(step)
                raise RuntimeError("injected failure")
            return step_fn(state, step)

        sup = TrainSupervisor(SupervisorConfig(
            checkpoint_dir=str(tmp_path), checkpoint_every=3), start())
        got = sup.run(flaky, num_steps=8)
        assert sup.restarts == 1 and failed == [5]
        assert store.latest_step(str(tmp_path)) == 8
        want, have = _flat(plain), _flat(got)
        assert len(want) == len(have) > 4
        for a, b in zip(want, have):
            np.testing.assert_array_equal(a, b)
