"""The cell leg of the port against the JAX package, on the CPU: the
fixed-point accuracy (``validate``), the checkpoint store, the cell key, and
the torch ``TraceCache`` (miss then hit, its own root, the training budget).

Cells here are the registry's workloads cut to a few samples and two
training steps, so a miss trains in about a second.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro.core import validate as jvalidate
from repro.core import workloads as jworkloads
from repro_torch.checkpoint import store
from repro_torch.core import train_snn, validate
from repro_torch.core import workloads
from repro_torch.core.workloads import cache as cache_mod

torch.set_num_threads(2)

SMALL = dict(n_train=8, n_test=8, train_steps=2, batch_size=4,
             trace_samples=8)


def _small(name, module=workloads):
    return dataclasses.replace(module.get(name), **SMALL)


class TestValidateCopy:
    @pytest.mark.parametrize("bits", [4, 8, 12])
    def test_quantized_accuracy_equals_jax_on_a_conv_net(self, bits):
        rng = np.random.default_rng(bits)
        cfg = workloads.get("dvs-conv").build(4, 1.0)
        shapes = [((3, 3, 2, 8), 8), ((3, 3, 8, 16), 16), ((1024, 64), 64),
                  ((64, 16), 16)]
        weights = [rng.normal(scale=0.6, size=s).astype(np.float32)
                   for s, _ in shapes]
        biases = [rng.normal(scale=0.1, size=n).astype(np.float32)
                  for _, n in shapes]
        spikes = (rng.random((4, 16, 32, 32, 2)) < 0.2).astype(np.int64)
        labels = rng.integers(0, 8, size=16)
        kw = dict(num_classes=8, frac_bits=bits - 1,
                  specs=validate.layer_specs(cfg.layers))
        got = validate.quantized_accuracy(weights, biases, spikes, labels,
                                          **kw)
        want = jvalidate.quantized_accuracy(weights, biases, spikes, labels,
                                            **kw)
        assert got == want
        out = validate.reference_apply_batch(
            validate.quantize(weights, biases, 0.95, 1.0, bits - 1,
                              kw["specs"]), spikes)
        assert out.sum() > 0


class TestStore:
    def _tree(self):
        rng = np.random.default_rng(0)
        return {"counts": [rng.random((4, 3)).astype(np.float32)],
                "params": [{"w": rng.normal(size=(2, 3)).astype(np.float32),
                            "b": np.zeros(3, np.float32)}, {},
                           {"w": np.ones((3, 1), np.float32),
                            "b": np.ones(1, np.float32)}]}

    def test_round_trip_keeps_structure_and_values(self, tmp_path):
        tree = self._tree()
        store.save(str(tmp_path), 3, tree)
        store.save(str(tmp_path), 5, tree, keep_last=1)
        assert store.all_steps(str(tmp_path)) == [5]
        back = store.restore(str(tmp_path), tree)
        assert list(back["params"][0]) == ["w", "b"]
        assert back["params"][1] == {}
        for a, b in zip(store.leaves(back), store.leaves(tree)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
        with pytest.raises(ValueError, match="leaves"):
            store.restore(str(tmp_path), {"counts": tree["counts"]})
        with pytest.raises(FileNotFoundError):
            store.restore(str(tmp_path / "none"), tree)

    def test_same_bytes_as_the_jax_store_and_restored_by_it(self, tmp_path):
        tree = self._tree()
        store.save(str(tmp_path / "torch"), 0, tree)
        jstore.save(str(tmp_path / "jax"), 0, jax.tree.map(jnp.asarray, tree))
        for name in ("manifest.msgpack", "leaves.bin.zst"):
            assert (tmp_path / "torch" / "step_00000000" / name).read_bytes() \
                == (tmp_path / "jax" / "step_00000000" / name).read_bytes()
        back = jstore.restore(str(tmp_path / "torch"), tree, step=0,
                              device=False)
        for a, b in zip(jax.tree.leaves(back), store.leaves(tree)):
            np.testing.assert_array_equal(a, b)


class TestCellKey:
    @pytest.mark.parametrize("name", ["mnist-mlp", "fmnist-mlp", "dvs-conv"])
    def test_equals_jax_for_every_registered_workload(self, name):
        for assignment in ({"num_steps": 8, "population": 1.0},
                           {"num_steps": 4, "population": 0.5}):
            for seed in (0, 3):
                assert workloads.cell_key(workloads.get(name), assignment,
                                          seed) == \
                    jworkloads.cell_key(jworkloads.get(name), assignment,
                                        seed)


@pytest.fixture
def cache(tmp_path):
    return workloads.TraceCache(root=str(tmp_path / "cells"), device="cpu")


def _cell_bytes(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".bin.zst") or f == "manifest.msgpack":
                path = os.path.join(dirpath, f)
                out[os.path.relpath(path, root)] = open(path, "rb").read()
    return out


class TestTraceCache:
    @pytest.mark.parametrize("name", ["dvs-conv", "mnist-mlp"])
    def test_miss_then_hit_with_identical_artifacts(self, cache, name):
        wl = _small(name)
        first = cache.resolve(wl, {"num_steps": 4}, seed=1, quant_bits=(8,))
        second = cache.resolve(wl, {"num_steps": 4}, seed=1, quant_bits=(8,))
        assert (first.cache_hit, second.cache_hit) == (False, True)
        assert cache.stats == {"hits": 1, "misses": 1}
        assert first.key == second.key == workloads.cell_key(
            wl, {"num_steps": 4, "population": 1.0}, 1)
        assert second.accuracy == first.accuracy
        assert second.quant_acc == first.quant_acc and 8 in first.quant_acc
        assert len(first.counts) == len(first.snn_cfg.layer_sizes())
        for a, b in zip(first.counts, second.counts):
            assert a.shape == (4, SMALL["trace_samples"])
            np.testing.assert_array_equal(a, b)
        for p, q in zip(first.params, second.params):
            assert p.keys() == q.keys()
            for k in p:
                np.testing.assert_array_equal(p[k], q[k])
        assert cache.contains(wl, {"num_steps": 4}, seed=1)
        assert not cache.contains(wl, {"num_steps": 4}, seed=2)

    def test_training_is_deterministic_to_the_byte(self, tmp_path):
        wl = _small("dvs-conv")
        for root in ("a", "b"):
            workloads.TraceCache(root=str(tmp_path / root),
                                 device="cpu").resolve(wl, {"num_steps": 4})
        a, b = _cell_bytes(tmp_path / "a"), _cell_bytes(tmp_path / "b")
        assert a and a == b

    def test_trains_through_train_snn(self, cache, monkeypatch):
        """The cell's params are ``train_snn.train``'s, and its counts are
        ``dump_traces``' on the same params."""
        wl = _small("dvs-conv")
        seen = {}
        real = train_snn.train

        def spy(*args, **kw):
            seen["res"] = real(*args, **kw)
            seen["kw"] = kw
            return seen["res"]

        monkeypatch.setattr(train_snn, "train", spy)
        art = cache.resolve(wl, {"num_steps": 4}, seed=2)
        assert seen["kw"]["steps"] == SMALL["train_steps"]
        assert seen["kw"]["device"] == torch.device("cpu")
        assert art.accuracy == seen["res"].test_accuracy
        for p, q in zip(art.params, seen["res"].params):
            for k in p:
                np.testing.assert_array_equal(p[k], q[k].numpy())
        traces = train_snn.dump_traces(
            art.snn_cfg, seen["res"].params, wl.make_data(4).x_test,
            max_samples=SMALL["trace_samples"], device="cpu")
        for got, want in zip(art.counts,
                             traces["layer_input_spike_counts"]):
            np.testing.assert_array_equal(got, want)

    def test_budget_is_charged_before_training(self, cache, monkeypatch):
        wl = _small("dvs-conv")
        monkeypatch.setattr(train_snn, "train", lambda *a, **k: pytest.fail(
            "trained past an exhausted budget"))
        budget = workloads.TrainingBudget(0)
        with pytest.raises(workloads.BudgetExceeded):
            cache.resolve(wl, {"num_steps": 4}, budget=budget)
        assert cache.stats == {"hits": 0, "misses": 0}

    def test_failed_training_refunds_the_budget(self, cache, monkeypatch):
        def boom(*a, **k):
            raise RuntimeError("boom")

        monkeypatch.setattr(train_snn, "train", boom)
        budget = workloads.TrainingBudget(1)
        with pytest.raises(RuntimeError, match="boom"):
            cache.resolve(_small("dvs-conv"), {"num_steps": 4},
                          budget=budget)
        assert budget.remaining == 1

    def test_corrupt_meta_is_quarantined_and_retrained(self, cache):
        wl = _small("dvs-conv")
        art = cache.resolve(wl, {"num_steps": 4})
        meta = os.path.join(cache.root, art.key, "meta.msgpack")
        with open(meta, "wb") as f:
            f.write(b"\x81\xa3acc")                 # a torn write
        again = cache.resolve(wl, {"num_steps": 4})
        assert not again.cache_hit and os.path.exists(meta + ".corrupt")
        assert again.accuracy == art.accuracy

    def test_own_default_root(self, monkeypatch, tmp_path):
        monkeypatch.delenv("REPRO_TORCH_WORKLOAD_CACHE", raising=False)
        monkeypatch.delenv("REPRO_WORKLOAD_CACHE", raising=False)
        assert workloads.default_root() != jworkloads.default_root()
        assert workloads.default_root().endswith(
            os.path.join("repro_torch", "workloads"))
        monkeypatch.setenv("REPRO_WORKLOAD_CACHE", str(tmp_path / "jax"))
        monkeypatch.setenv("REPRO_TORCH_WORKLOAD_CACHE", str(tmp_path / "t"))
        assert workloads.TraceCache(device="cpu").root == str(tmp_path / "t")
        assert cache_mod.default_root() == str(tmp_path / "t")
