"""``repro_torch.spans``: spans off and on, their parents and step ids
across threads, the spans of one training step, and their clock against
the profiler's; on the card (marked ``cuda``), the same for autograd's
device thread, a kernel on the device clock, net-5's launch counts, and
the spans of the train step's CUDA graph: its capture opens an eager
step's spans, a replay the ``step`` span alone.

This file imports no JAX, so its card tests run where only PyTorch is
installed: ``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_spans.py``.
"""
import threading
from collections import Counter

import pytest
import torch

from repro_torch import optim, spans
from repro_torch.core import snn, train_snn
from repro_torch.kernels import ops

#: How far a span's clock may sit from the profiler's.
CLOCK_SLACK_NS = 50_000


def _small_net(num_steps: int = 3) -> snn.SNNConfig:
    return snn.SNNConfig("conv-pool-dense", (6, 6, 2),
                         (snn.Conv(3), snn.MaxPool(2), snn.Dense(5)),
                         num_classes=5, num_steps=num_steps)


def _step_inputs(cfg, device, batch: int = 2, seed: int = 3):
    gen = torch.Generator().manual_seed(seed)
    x = (torch.rand((batch, cfg.num_steps) + cfg.input_shape, generator=gen)
         < 0.3).float().to(device)
    y = torch.randint(0, cfg.num_classes, (batch,), generator=gen).to(device)
    tx = optim.adam(1e-2)
    params, opt_state, enc = train_snn.init_cell(cfg, tx, seed, device=device)
    step = train_snn.make_train_step(cfg, tx, "spike_gemm_fused")
    return step, params, opt_state, enc, x, y


def _children(records, parent):
    return [r for r in records if r.parent == parent]


def _ancestors(records, index):
    out = []
    while records[index].parent is not None:
        index = records[index].parent
        out.append(records[index].name)
    return out


def _device_ops(prof):
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda]


def test_off_returns_one_shared_object_and_records_nothing():
    first = spans.span("a")
    with first:
        with spans.span("b") as inner:
            assert inner is first
    assert spans.span("c") is first
    with spans.recording() as records:
        pass
    assert records == []


def test_recording_is_not_reentrant():
    with spans.recording():
        with pytest.raises(RuntimeError):
            with spans.recording():
                pass
    assert spans.span("after") is spans.span("again")


def test_parents_and_step_ids_nest_and_cross_threads():
    def worker():
        with spans.span("other.outer"):
            with spans.span("other.inner"):
                pass

    with spans.recording() as records:
        with spans.span("before"):
            pass
        for _ in range(2):
            with spans.span(spans.STEP):
                with spans.span("phase"):
                    with spans.span("layer"):
                        thread = threading.Thread(target=worker)
                        thread.start()
                        thread.join(timeout=30)
                        assert not thread.is_alive()
        with spans.span("after"):
            pass
    names = [r.name for r in records]
    assert names == ["before"] + ["step", "phase", "layer", "other.outer",
                                  "other.inner"] * 2 + ["after"]
    assert records[0].parent is None and records[0].step is None
    assert records[-1].parent is None and records[-1].step is None
    first, second = records[1].step, records[6].step
    assert second == first + 1
    for base, step_id in ((1, first), (6, second)):
        step, phase, layer, outer, inner = records[base:base + 5]
        assert step.parent is None
        assert phase.parent == base and layer.parent == base + 1
        # the other thread had none open: its outer span's parent is the
        # innermost span open on the thread that opened the step
        assert outer.parent == base + 2 and inner.parent == base + 3
        assert outer.thread != step.thread == layer.thread
        assert {r.step for r in records[base:base + 5]} == {step_id}
    for r in records:
        assert r.start_ns <= r.end_ns


def test_counters_count_and_reset_by_prefix():
    spans.reset_counts("test.")
    spans.count("test.a")
    spans.count("test.a", 4)
    spans.count("test.b", 2)
    assert {k: v for k, v in spans.counts().items()
            if k.startswith("test.")} == {"test.a": 5, "test.b": 2}
    spans.reset_counts("test.a")
    assert "test.a" not in spans.counts()
    assert spans.counts()["test.b"] == 2
    spans.reset_counts("test.")
    assert not any(k.startswith("test.") for k in spans.counts())


def test_launch_counts_read_the_launch_counters():
    ops.reset_launch_counts()
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)
    spans.count("launch.spike_conv", 3)
    spans.count("launch.penc_compact")
    assert ops.launch_counts() == dict(dict.fromkeys(ops.KERNELS, 0),
                                       spike_conv=3, penc_compact=1)
    ops.reset_launch_counts()
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)


def test_span_names_are_made_once_per_config():
    cfg = _small_net()
    assert cfg.span_names == ("fwd.conv0", "fwd.pool1", "fwd.dense2")
    assert cfg.span_names is cfg.span_names


def _function_nodes(loss) -> Counter:
    """Backward nodes of the graph under ``loss``, by class name."""
    seen, todo = set(), [loss.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        todo.extend(n for n, _ in node.next_functions)
    return Counter(type(n).__name__ for n in seen)


def test_one_training_step_spans_its_phases_and_layers():
    cfg = _small_net()
    step, params, opt_state, enc, x, y = _step_inputs(cfg, "cpu")
    with spans.recording() as records:
        step(params, opt_state, enc, x, y)
    steps = [i for i, r in enumerate(records) if r.name == spans.STEP]
    assert len(steps) == 1
    top = steps[0]
    assert records[top].parent is None
    assert [r.name for r in _children(records, top)] == [
        "forward", "backward", "optimizer"]
    assert {r.step for r in records} == {records[top].step}
    assert all(r.end_ns is not None for r in records)
    by_name = Counter(r.name for r in records)
    # a span a layer a time step, but for the MaxPool the conv's epilogue
    # pools
    spiking = len(cfg.spiking_layers())
    fwd = [r for r in records if r.name.startswith("fwd.")]
    assert len(fwd) == cfg.num_steps * spiking
    assert by_name["fwd.pool1"] == 0
    assert all(records[r.parent].name == "forward" for r in fwd)
    # one bwd span per backward of a Function: the graph of the same loss
    # holds one node per Function call
    leaves = [{k: v.detach().requires_grad_() for k, v in p.items()}
              for p in params]
    nodes = _function_nodes(train_snn.loss_fn(
        cfg, leaves, enc, x, y, matmul_backend="spike_gemm_fused"))
    assert by_name["bwd.conv"] == nodes["_SpikeConvTrainBackward"] == 3
    assert by_name["bwd.epilogue"] == nodes["_ConvLifStepBackward"] == 3
    assert by_name["bwd.pool"] == nodes["_OrPoolBackward"] == 0
    assert by_name["bwd.dense"] == nodes["_SpikeGemmLifStepBackward"] == 3
    for i, r in enumerate(records):
        if r.name.startswith("bwd."):
            assert "backward" in _ancestors(records, i)
    forward, backward, optimizer = _children(records, top)
    assert forward.end_ns <= backward.start_ns
    assert backward.end_ns <= optimizer.start_ns


def test_recording_changes_no_number_of_the_step():
    cfg = _small_net()
    runs = []
    for record in (False, True, False):
        step, params, opt_state, enc, x, y = _step_inputs(cfg, "cpu")
        if record:
            with spans.recording():
                out = step(params, opt_state, enc, x, y)
        else:
            out = step(params, opt_state, enc, x, y)
        runs.append(out)
    (p0, _, l0), (p1, _, l1), (p2, _, l2) = runs
    assert torch.equal(l0, l1) and torch.equal(l0, l2)
    for a, b, c in zip(p0, p1, p2):
        assert all(torch.equal(a[k], b[k]) and torch.equal(a[k], c[k])
                   for k in a)


def test_a_span_holds_its_host_operators_on_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile

    a = torch.rand(1024, 1024)
    b = torch.rand(1024, 1024)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.recording() as records:
            with spans.span("matmul"):
                a @ b
    (rec,) = records
    mms = [e for e in prof.profiler.kineto_results.events()
           if e.name() == "aten::mm"]
    assert mms and max(e.duration_ns() for e in mms) > 1_000_000
    for e in mms:
        assert e.start_ns() >= rec.start_ns - CLOCK_SLACK_NS
        assert e.start_ns() + e.duration_ns() <= rec.end_ns + CLOCK_SLACK_NS


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU host)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_backward_spans_fall_under_backward(cuda):
    cfg = _small_net()
    step, params, opt_state, enc, x, y = _step_inputs(cfg, cuda)
    step(params, opt_state, enc, x, y)            # builds the kernels
    # a new step's first call runs eagerly (a replay opens no phase span)
    step, params, opt_state, enc, x, y = _step_inputs(cfg, cuda)
    with spans.recording() as records:
        step(params, opt_state, enc, x, y)
        torch.cuda.synchronize()
    (top,) = [i for i, r in enumerate(records) if r.name == spans.STEP]
    threads = {r.thread for r in records}
    bwd = [i for i, r in enumerate(records) if r.name.startswith("bwd.")]
    assert len(bwd) == 3 * cfg.num_steps
    for i in bwd:
        assert "backward" in _ancestors(records, i)
        assert records[i].step == records[top].step
    # autograd ran them on its device thread, not the caller's
    assert {records[i].thread for i in bwd} != {records[top].thread}
    assert len(threads) >= 2


@pytest.mark.cuda
def test_cuda_a_kernel_lies_inside_its_span_on_the_device_clock(cuda):
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator().manual_seed(5)
    s = (torch.rand(64, 128, 128, 2, generator=gen) < 0.05).float().to(cuda)
    w = (torch.randn(3, 3, 2, 32, generator=gen) / 4).to(cuda)
    ops.spike_conv(s, w)                           # builds the kernel
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with spans.recording() as records:
            with spans.span("conv"):
                ops.spike_conv(s, w)
                torch.cuda.synchronize()
    (rec,) = records
    kernels = [(n, s0, e0) for n, s0, e0 in _device_ops(prof)
               if "spike_conv" in n]
    assert kernels
    for _, start, end in kernels:
        assert start >= rec.start_ns - CLOCK_SLACK_NS
        assert end <= rec.end_ns + CLOCK_SLACK_NS


@pytest.mark.cuda
def test_cuda_net5_step_launch_counts(cuda):
    """One net-5 training step (T = 124, B = 64) on the default backend:
    per time step 3 fused dense steps, 2 convs, 2 conv epilogues each way,
    5 dW and 4 dS (conv1's input needs no gradient)."""
    cfg = snn.SNNConfig(
        "net-5", (128, 128, 2),
        (snn.Conv(32, 3), snn.MaxPool(2), snn.Conv(32, 3), snn.MaxPool(2),
         snn.Dense(512), snn.Dense(256), snn.Dense(11)),
        num_classes=11, num_steps=124)
    step, params, opt_state, enc, x, y = _step_inputs(cfg, cuda, batch=64)
    x = (x > 0) & (torch.rand_like(x) < 0.0137)   # about 0.4% events
    x = x.float()
    ops.reset_launch_counts()
    with spans.recording() as records:
        step(params, opt_state, enc, x, y)
        torch.cuda.synchronize()
    assert ops.launch_counts() == dict(
        dict.fromkeys(ops.KERNELS, 0), spike_gemm_lif=372, spike_conv=248,
        spike_gemm_dw=620, spike_gemm_ds=496, conv_epilogue=496)
    names = Counter(r.name for r in records)
    assert sum(n for k, n in names.items() if k.startswith("fwd.")) == 620
    assert sum(n for k, n in names.items() if k.startswith("bwd.")) == 868
    assert names["bwd.epilogue"] == 248 and names["bwd.pool"] == 0


@pytest.mark.cuda
def test_cuda_a_replayed_step_opens_its_step_span_alone(cuda):
    """The warm-up and the capture run the step's Python and open every
    span of an eager step; a replay opens the ``step`` span only, and
    counts the launches an eager step does."""
    cfg = _small_net()
    step, params, opt_state, enc, x, y = _step_inputs(cfg, cuda)
    names, launches = [], []
    for _ in range(3):
        ops.reset_launch_counts()
        with spans.recording() as records:
            step(params, opt_state, enc, x, y)
            torch.cuda.synchronize()
        names.append(Counter(r.name for r in records))
        launches.append(ops.launch_counts())
    eager, capture, replay = names
    assert capture == eager
    assert eager["forward"] == eager["backward"] == 1
    assert eager["bwd.dense"] == cfg.num_steps
    assert replay == Counter({spans.STEP: 1})
    assert launches[0] == launches[1] == launches[2]
    assert launches[0]["spike_gemm_lif"] == cfg.num_steps
