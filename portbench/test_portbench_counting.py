"""The counting functions against hand-worked numbers at tiny shapes, and
the per-layer readers on a made-up trace."""
from __future__ import annotations

import pytest
import torch

from portbench import counting, devtrace, net as netmod
from portbench.context import Context, matcher
from portbench.metrics import (conv_kernel_roofline_pct,
                               dense_kernel_roofline_pct, device_idle_pct,
                               launches_per_step, step_mfu_pct,
                               torch_op_ms_per_step)
from portbench.reference import snn as ref

CONFIG = {"input_shape": [3, 3, 1], "num_classes": 2, "pcr": 1,
          "num_steps": 1,
          "lif": {"beta": 0.95, "threshold": 1.0, "slope": 25.0,
                  "reset": "subtract"},
          "layers": [{"kind": "conv", "features": 2, "kernel": 3,
                      "stride": 1, "padding": "SAME"},
                     {"kind": "dense", "features": 5},
                     {"kind": "dense", "features": 2}]}


def test_fanout_positions():
    assert netmod.fanout_positions(4, 3, 1, "SAME") == [2, 3, 3, 2]
    assert netmod.fanout_positions(4, 3, 1, "VALID") == [1, 2, 2, 1]
    assert netmod.fanout_positions(5, 3, 2, "SAME") == [1, 2, 1, 2, 1]


def test_conv_launches_by_hand():
    net = netmod.parse(CONFIG)
    # one event, in the centre of the 3 x 3 image: it reaches all 9 output
    # pixels, each with 2 features
    fwd, dw = counting.layer_launches(net, 1, 0, 0, (1, 9, 0, 1))
    assert (fwd.group, fwd.kind, dw.kind) == ("conv", "forward", "dw")
    assert fwd.flops == dw.flops == 2 * 9 * 2
    # input 9 floats, weights 18, output 18
    assert fwd.bytes == 4 * (9 + 18 + 18)
    assert dw.bytes == 4 * (9 + 18 + 18)


def test_dense_launches_by_hand():
    net = netmod.parse(CONFIG)
    # the first dense layer: K = 18, N = 5, a batch of 2; 3 spikes, on 2
    # distinct input columns
    fwd, dw, ds = counting.layer_launches(net, 2, 1, 0, (3, 3, 2, 1))
    assert fwd.flops == dw.flops == 2 * 3 * 5
    # S (2 x 18), bias 5, u and s in and out (4 x 2 x 5), 2 weight rows
    assert fwd.bytes == 4 * (36 + 5 + 40 + 2 * 5)
    assert dw.bytes == 4 * (36 + 10 + 90)
    assert ds.flops == 2 * 2 * 18 * 5
    assert ds.bytes == 4 * (10 + 90 + 36)


def test_a_silent_input_needs_no_operations_but_its_bytes():
    net = netmod.parse(CONFIG)
    fwd, dw, ds = counting.layer_launches(net, 2, 1, 0, (0, 0, 0, 1))
    assert fwd.flops == dw.flops == 0
    assert fwd.least_s == fwd.bytes / counting.PEAK_BYTES_PER_S > 0
    assert ds.flops == 2 * 2 * 18 * 5       # dS stays the dense product


def test_slab_cells_scale_the_operands():
    net = netmod.parse(CONFIG)
    one = counting.layer_launches(net, 2, 1, 0, (3, 3, 2, 1))
    two = counting.layer_launches(net, 2, 1, 0, (6, 6, 4, 2))
    for a, b in zip(one, two):
        assert b.flops == 2 * a.flops and b.bytes == 2 * a.bytes


def test_spike_stats_count_the_inputs_by_brute_force():
    net = netmod.parse(CONFIG)
    params = [{"w": torch.zeros(3, 3, 1, 2), "b": torch.zeros(2)},
              {"w": torch.zeros(18, 5), "b": torch.zeros(5)},
              {"w": torch.zeros(5, 2), "b": torch.zeros(2)}]
    spikes = torch.zeros(1, 2, 3, 3, 1)
    spikes[0, 0, 1, 1, 0] = 1            # centre: 9 output pixels
    spikes[0, 1, 0, 0, 0] = 1            # corner: 4
    spikes[0, 1, 0, 2, 0] = 1            # corner: 4
    stats = ref.spike_stats(net, params, spikes)
    assert stats[0][0] == [3.0, 17.0, 0.0]
    assert stats[1][0] == [0.0, 0.0, 0.0]    # zero weights: silent layers
    launches = counting.step_launches(net, 2, [stats])
    assert [(l.layer, l.kind) for l in launches] == [
        (0, "forward"), (0, "dw"), (1, "forward"), (1, "dw"), (1, "ds"),
        (2, "forward"), (2, "dw"), (2, "ds")]


def _ctx(ops, launches=(), step_ms=(), cells=1, steps=2, window_s=1.0):
    busy, _ = devtrace.union_us(ops)
    span = (max(e for _, _, e in ops) - min(s for _, s, _ in ops)
            if ops else 0.0)
    trace = devtrace.Trace(list(ops), window_s, span / 1e6, busy / 1e6, [])
    return Context(trace, steps, list(launches), 0.5, list(step_ms), cells)


def test_kernel_names_match_whole_identifiers():
    dense = matcher(dense_kernel_roofline_pct.KERNELS)
    conv = matcher(conv_kernel_roofline_pct.KERNELS)
    assert conv("void spike_conv_strip_kernel<3>(float const*, float*)")
    assert not conv("spike_conv_ds_strip_kernelx()")
    assert dense("void spike_gemm_dw_kernel<4, true>(float const*)")
    assert not dense("spike_conv_dw_kernel(float const*)")
    assert not conv("dw_reduce_slab_kernel_v2()")


def test_the_readers_on_a_made_up_trace():
    ops = [("spike_gemm_lif_split_kernel(float const*)", 0.0, 100.0),
           ("void at::native::vectorized_elementwise_kernel<4>()", 150.0,
            250.0),
           ("Memcpy DtoH (Device -> Pinned)", 300.0, 310.0),
           ("spike_conv_strip_kernel<3>()", 400.0, 450.0)]
    launches = [counting.Launch("dense", "forward", 0, 0,
                                0.5 * 1e-4 * counting.PEAK_FP32_FLOPS, 0.0),
                counting.Launch("conv", "forward", 0, 0, 0.0,
                                1e-5 * counting.PEAK_BYTES_PER_S)]
    ctx = _ctx(ops, launches, steps=2, window_s=500e-6)
    # idle over the device span (0 to 450 us), not the host's 500 us
    assert device_idle_pct.read(ctx) == pytest.approx(100 * (1 - 260 / 450))
    assert launches_per_step.read(ctx) == 1.5
    assert torch_op_ms_per_step.read(ctx) == pytest.approx(
        (100 + 10) / 1e3 / 2)
    assert dense_kernel_roofline_pct.read(ctx) == pytest.approx(50.0)
    assert conv_kernel_roofline_pct.read(ctx) == pytest.approx(20.0)
    flops = launches[0].flops / 2
    assert step_mfu_pct.read(ctx) == pytest.approx(
        100 * flops / (0.5 * counting.PEAK_FP32_FLOPS))


def test_readers_return_nothing_where_nothing_ran():
    ctx = _ctx([], step_ms=[1.0, 2.0, 3.0], cells=4)
    for reader in (device_idle_pct, launches_per_step, torch_op_ms_per_step,
                   dense_kernel_roofline_pct, conv_kernel_roofline_pct,
                   step_mfu_pct):
        assert reader.read(ctx) is None


def test_union_and_gaps():
    busy, gaps = devtrace.union_us([("a", 0.0, 10.0), ("b", 5.0, 20.0),
                                    ("c", 30.0, 40.0)])
    assert busy == 30.0 and gaps == [(20.0, 30.0)]
    host = sorted([("step", 0.0, 100.0), ("aten::mul", 18.0, 25.0),
                   ("aten::add", 2.0, 4.0)], key=lambda h: h[1])
    starts = [h[1] for h in host]
    assert devtrace._host_at(host, starts, 20.0) == "aten::mul"
    assert devtrace._host_at(host, starts, 50.0) == "step"
    assert devtrace._host_at(host, starts, 150.0) == "python"
