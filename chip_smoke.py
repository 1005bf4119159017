#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's DSE cell, inference and training, on one
NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root

Phases, in the order they run, each of which raises on failure (the
script then exits non-zero and never prints its result line):

1. TF32 off for matmuls and cuDNN; the card's name and power limit; build
   the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc.
2. Hold each forward kernel against its plain PyTorch version on the card,
   at spike densities 0 .. 100%, on ragged shapes (one of them a large K
   that takes the dense kernels' split path; odd sizes, stride 2, VALID,
   C = 3 and 33 and F = 33 for the conv) and on net-5's and dvs-conv's own,
   and the conv on inputs other than spikes.  Weights on the 2^-12 grid
   make every partial sum exact in fp32, so the results must be equal;
   normal weights are checked to a stated tolerance, and the dense and conv
   kernels must give the same bytes on two calls.
3. The same for the backward kernels (the dense layers' dW and dS, the
   conv layers' dW on their input spikes and their dS in conv form, at
   every conv geometry of phase 2), with cotangents on a coarse grid, each
   twice for the same bytes, and on spikes of other values; a cotangent
   tile (dense dS) and a cotangent pixel (conv dS) of +x and -x must not be
   skipped; on normal operands the conv dS must equal col2im of the card's
   dense dS bit for bit; one ``spike_conv_train`` forward and backward on
   the card equal to the CPU's.  Then the kernel API's own kernels:
   ``lif_step`` (fp32 and bf16, both resets) on ragged shapes and on net-5's
   membrane shapes, and ``penc_compact`` on ragged shapes at densities 0 ..
   100%, each equal to its plain version bit for bit.
4. The inference path: net-5 (DVSGesture 128x128x2 - 32C3 - P2 - 32C3 -
   P2 - 512 - 256 - 11, T = 124) with seeded random weights on 64
   synthetic event streams: ``evaluate``, ``dump_traces``,
   ``trace_counts`` on each backend, with the kernels' launch counters set
   to 0 before each backend and read after it, so each kernel must launch
   exactly on the paths that use it (and the plain ``torch`` backend
   launches none); then the accelerator model and ``dse.search`` over
   11,664 LHR candidates, and a profile of 8 forward steps.  Before it, the
   kernel API (``repro_torch.kernels``, the JAX package's API) as a user
   calls it, with the counters set to 0 before and read after: every
   layer's input traffic through ``penc_compact`` at each of the 124
   steps, and the dense stack fc1-fc3 through ``spike_gemm_profiled`` and
   ``lif_step``, whose spikes must equal the model's own bit for bit.
5. The training path, net-5 at full width: one training step (forward and
   BPTT) on each backend from the same grid weights and batch, with the
   counters set to 0 before each backend and read after it (dW and dS
   included) and ``conv_col2im`` refused on CUDA tensors (a conv layer's
   dS must not go through patch space); equal losses and gradients within
   a stated tolerance; a
   profile of the step's forward and backward by kernel; three Adam steps
   on the default backend with their losses, times and peak memory.
6. The whole cell: the registry's dvs-conv at T = 8 with its own recipe
   through the torch ``TraceCache`` in a temporary root, a miss (training,
   traces, fixed-point accuracy) with its launches counted, then a hit
   with equal params and counts.
   Then the paper's study loop in another temporary root, at the
   registry's widths and recipes: the Fig.-1 firing table of net-5's
   inference traffic (``sparsity.analyze``); ``dse.coexplore`` over the
   dvs-conv cells T = 8, 12, 16; a budgeted ``dse.explore`` of a joint
   mnist-mlp space (EvolutionarySearch, ``train_budget=2``) and its repeat
   on the same root, which must be all hits with an equal frontier.
7. Time each kernel, its plain version and one library call at the main
   path's shapes on the main path's own traffic (the backward kernels on
   the operands of phase 5's middle time step), next to the least time
   the card could take for the same work.  The dense and conv kernels and
   their library calls (``torch.matmul``, cuDNN's convolution, weight
   gradient and input gradient) also get their device time from the
   profiler (``kernel_device_ms``, ``library_device_ms``): one call between
   two events encloses the wrapper's host time before the launch when that
   is longer than the kernel.  conv2's dS row times the layer's whole input
   gradient (``ops.spike_conv_bwd_ds``) against cuDNN's
   ``torch.nn.grad.conv2d_input``.

The line before the last is the card's name and power limit; the last line
is ``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.
"""
import importlib
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"
OUT = ROOT / "chiprun_out" / "chip_smoke.json"

SEED = 0
GRID_BITS = 12                       # weights on the 2^-12 grid
# Per spiking layer (conv1, conv2, fc1, fc2, fc3).  With 1/sqrt(fan_in)
# weights and no training, conv1 sees ~1% input events and would stay
# nearly silent, and so would everything after it; these gains give firing
# rates of ~5-20%, the range the paper reports for trained nets.
GAINS = (4.0, 1.5, 1.5, 1.5, 1.5)
BATCH = 64
NUM_STEPS = 124
DENSITIES = (0.0, 0.01, 0.1, 0.3, 1.0)
# Normal weights: max |kernel - plain| over the largest sum of |s*w|.
NORMAL_RTOL = 1e-5
# Kernels each backend must launch, and how many of the spiking layers
# (conv1, conv2 | fc1, fc2, fc3) each of them serves in one time step.
# Inference runs no backward kernel, and no path of the model runs the
# kernel API's lif_step or penc_compact: the model's LIF update is
# core.lif, as in the JAX package.
API_ONLY = {"lif_step": 0, "penc_compact": 0}
EXPECTED = {"spike_gemm_fused": {"spike_gemm": 0, "spike_gemm_lif": 3,
                                 "spike_conv": 2, "spike_gemm_dw": 0,
                                 "spike_gemm_ds": 0, **API_ONLY},
            "spike_gemm": {"spike_gemm": 3, "spike_gemm_lif": 0,
                           "spike_conv": 2, "spike_gemm_dw": 0,
                           "spike_gemm_ds": 0, **API_ONLY},
            "torch": {"spike_gemm": 0, "spike_gemm_lif": 0, "spike_conv": 0,
                      "spike_gemm_dw": 0, "spike_gemm_ds": 0, **API_ONLY}}
# The same for one training step (forward and BPTT), per time step: dW for
# each of the 5 spiking layers, dS for 4 of them, because conv1's input is
# the encoded events, which need no gradient (dS runs only where
# ctx.needs_input_grad asks for it).
TRAIN_EXPECTED = {
    backend: {**counts, "spike_gemm_dw": 5 if backend != "torch" else 0,
              "spike_gemm_ds": 4 if backend != "torch" else 0}
    for backend, counts in EXPECTED.items()}
# The path on which each kernel's launches are reported: a backend of the
# model, or the kernel API phase.
LAUNCHED_ON = {"spike_gemm": "spike_gemm", "spike_gemm_lif": "spike_gemm_fused",
               "spike_conv": "spike_gemm_fused",
               "spike_gemm_dw": "spike_gemm_fused",
               "spike_gemm_ds": "spike_gemm_fused",
               "lif_step": "kernel API", "penc_compact": "kernel API"}
# The kernel API phase: per time step, penc_compact on the input traffic of
# each of the 5 spiking layers, and spike_gemm_profiled + lif_step on each
# of the 3 dense layers.
API_EXPECTED = {"spike_gemm": 3, "spike_gemm_lif": 0, "spike_conv": 0,
                "spike_gemm_dw": 0, "spike_gemm_ds": 0, "lif_step": 3,
                "penc_compact": 5}
# The conv layers held against their plain versions, ((B, H, W, C), F,
# kernel, stride, padding): ragged ones (odd sizes, stride 2, VALID, C = 3,
# 4 and 33, F = 5 and 33), dvs-conv's two convs and net-5's conv1 and conv2.
CONV_CASES = ([((3, 17, 15, 4), 33, 3, st, pad) for st in (1, 2)
               for pad in ("SAME", "VALID")]
              + [((3, 17, 15, 3), 33, 3, 2, "SAME"),
                 ((2, 9, 11, 33), 33, 3, 1, "VALID"),
                 ((2, 9, 11, 33), 5, 2, 2, "SAME"),
                 ((BATCH, 32, 32, 2), 8, 3, 1, "SAME"),
                 ((BATCH, 16, 16, 8), 16, 3, 1, "SAME"),
                 ((BATCH, 128, 128, 2), 32, 3, 1, "SAME"),
                 ((BATCH, 64, 64, 32), 32, 3, 1, "SAME")])
# The ECU's priority-encoder chunk (validate.penc_compress's default).
PENC_CHUNK = 100
BACKWARD = ("spike_gemm_dw", "spike_gemm_ds")
# Training: the batch, the Adam steps, and the tolerance of each gradient
# across backends, relative to the leaf's max |grad| on the default backend
# (the backward's sums run in other orders on each backend).
TRAIN_BATCH = 64
ADAM_STEPS = 3
GRAD_RTOL = 1e-4
# The cell driven through the torch TraceCache: the registry's dvs-conv
# at T = 8 with its own recipe (150 Adam steps at batch 64).
CELL_STEPS = 8
# Published peaks of one H100 SXM at its 700 W limit (dense, no sparsity).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
LINES = {"spike_gemm": "src/repro/kernels/spike_gemm.py:49",
         "spike_gemm_lif": "src/repro/kernels/spike_gemm_fused.py:59",
         "spike_conv": "src/repro/kernels/spike_conv.py:91",
         "spike_gemm_dw": "src/repro/kernels/spike_gemm_bwd.py:52",
         "spike_gemm_ds": "src/repro/kernels/spike_gemm_bwd.py:102",
         "lif_step": "src/repro/kernels/lif_step.py:44",
         "penc_compact": "src/repro/kernels/penc_compact.py:41"}
SOURCES = {"spike_gemm": "src/repro_torch/kernels/csrc/spike_gemm.cu",
           "spike_gemm_lif": "src/repro_torch/kernels/csrc/spike_gemm_fused.cu",
           "spike_conv": "src/repro_torch/kernels/csrc/spike_conv.cu",
           "spike_gemm_dw": "src/repro_torch/kernels/csrc/spike_gemm_bwd.cu",
           "spike_gemm_ds": "src/repro_torch/kernels/csrc/spike_gemm_bwd.cu",
           "lif_step": "src/repro_torch/kernels/csrc/lif_step.cu",
           "penc_compact": "src/repro_torch/kernels/csrc/penc_compact.cu"}
# The headers each kernel's source includes from csrc/.
HEADERS = {"spike_gemm": ["dense_split.cuh"],
           "spike_gemm_lif": ["dense_split.cuh"],
           "spike_conv": ["conv_halo.cuh"],
           "spike_gemm_dw": ["conv_halo.cuh"],
           "spike_gemm_ds": ["conv_halo.cuh"],
           "lif_step": [], "penc_compact": []}


def log(*args):
    print(*args, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class Phase:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        log(f"== {self.name}")
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        if exc[0] is None:
            log(f"== {self.name}: done in "
                f"{time.perf_counter() - self.t0:.1f} s")


def median_ms(torch, fn, reps=25, warmup=3) -> float:
    """Median over ``reps`` launches of ``fn``, each between two CUDA
    events, after ``warmup`` launches."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    marks = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in marks:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in marks)


def device_ms(torch, fn, calls=20, tries=3):
    """Device time a call of ``fn`` takes: the profiler's sum of the CUDA
    kernels ``calls`` calls launch, over ``calls``, after one warm-up.
    Unlike ``median_ms`` it leaves out the host time before each launch,
    which one timed call encloses whenever the host is slower than the
    device.  The profiler now and then records no kernel at all; then it
    tries again, and after ``tries`` empty traces returns None (not
    measured), never 0."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        total = sum(e.device_time_total for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
        if total > 0:
            return total / calls / 1e3
    return None


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# The bounds count what this run's data needs: a tile whose flag is 0 is
# never read, so only the flagged tiles of the gated operand, the rows or
# columns of the other operands that meet a flagged tile, every output and
# the flags themselves are moved.

def _tile_sizes(torch, n: int, tiles: int, block: int):
    sizes = torch.full((tiles,), float(block), dtype=torch.float64)
    sizes[-1] = n - block * (tiles - 1)
    return sizes


def gated_counts(torch, flags, rows: int, cols: int
                 ) -> tuple[float, float, float]:
    """(elements of the (rows, cols) matrix in flagged tiles, rows that meet
    a flagged tile, columns that meet a flagged tile), on the kernels'
    (block_m, block_k) tile grid."""
    from repro_torch.kernels.build import TILE
    f = flags.detach().to("cpu", torch.float64)
    r = _tile_sizes(torch, rows, f.shape[0], TILE["block_m"])
    c = _tile_sizes(torch, cols, f.shape[1], TILE["block_k"])
    return (float(r @ f @ c), float(((f.sum(1) > 0).double() * r).sum()),
            float(((f.sum(0) > 0).double() * c).sum()))


def conv_reach(torch, ref, x, k: int, stride: int, padding: str):
    """Per output pixel of a k x k convolution of ``x``, the number of
    input events (nonzero entries) in its receptive field: (B, OH, OW)."""
    events = (x != 0).sum(-1, keepdim=True).to(torch.float32)
    ones = torch.ones(k, k, 1, 1, device=x.device)
    return ref.spike_conv_ref(events, ones, stride=stride,
                              padding=padding)[..., 0]


def dvs_cell_launches(wl, num_steps: int) -> dict:
    """Kernel launches of one dvs-conv cell miss at T = ``num_steps``: per
    Adam step the 2 convs and the 2 dense layers forward, dW on all 4, dS
    on 3 (not on the events); then one inference each in evaluate (128 test
    samples, one batch) and dump_traces."""
    runs = wl.train_steps + 2
    return {"spike_gemm": 0, "spike_gemm_lif": 2 * num_steps * runs,
            "spike_conv": 2 * num_steps * runs,
            "spike_gemm_dw": 4 * num_steps * wl.train_steps,
            "spike_gemm_ds": 3 * num_steps * wl.train_steps, **API_ONLY}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch" / "kernels").is_dir():
        print("chip_smoke: run it from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import torch.nn.functional as F

    from repro_torch import kernels as api
    from repro_torch import optim
    from repro_torch.core import (dse, snn, sparsity, train_snn, validate,
                                  workloads)
    from repro_torch.core.accelerator import arch
    from repro_torch.data import synthetic
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import spike_conv as conv_kernel
    from repro_torch.kernels import spike_gemm_bwd as bwd_kernel
    from repro_torch.kernels import spike_gemm_fused as fused_kernel
    # the package exports the functions spike_gemm, lif_step and
    # penc_compact, so their binding modules are reached by full name
    gemm_kernel = importlib.import_module("repro_torch.kernels.spike_gemm")
    lif_kernel = importlib.import_module("repro_torch.kernels.lif_step")
    penc_kernel = importlib.import_module("repro_torch.kernels.penc_compact")

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    report = {"gains": GAINS, "grid_bits": GRID_BITS}
    scale = 2.0 ** GRID_BITS

    def on_grid(w):
        return torch.round(w * scale) / scale

    def spikes(shape, density):
        return (torch.rand(shape, generator=gen, device=dev)
                < density).to(torch.float32)

    def cotangent(shape, density):
        """Integers in [-2, 2], nonzero with probability ``density``: the
        coarse grid on which every partial sum of dW and dS is exact."""
        g = torch.randn(shape, generator=gen, device=dev).round().clamp(-2, 2)
        return g * spikes(shape, density)

    # ---- 1. set-up ------------------------------------------------------
    with Phase("set-up"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
            f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
            f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
        smi = smi_line()
        log(f"card: {smi}")
        t0 = time.perf_counter()
        libs = build.build_all()
        report["build_seconds"] = time.perf_counter() - t0
        log(f"built {sorted(libs)} in {report['build_seconds']:.1f} s "
            f"into {build.build_dir().relative_to(ROOT)}")
        report["ptxas"] = {}
        for name in sorted(libs):
            for line in (libs[name].parent / f"{name}.log").read_text() \
                    .splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  {name}: {line.strip()}")
                    report["ptxas"].setdefault(name, []).append(line.strip())

    # ---- 2. kernels against their plain versions -------------------------
    errs = {name: 0.0 for name in LINES}

    def hold(name, got, want, what):
        for g, w in zip(got, want):
            if g.shape != w.shape or not torch.equal(g, w):
                diff = (g - w).abs().max().item() if g.shape == w.shape \
                    else float("nan")
                raise AssertionError(f"{name} differs from its plain "
                                     f"version on {what}: max |diff| {diff}")
            errs[name] = max(errs[name], (g - w).abs().max().item())

    net5_dense = [(BATCH, 32 * 32 * 32, 512), (BATCH, 512, 256),
                  (BATCH, 256, 11)]
    # a ragged large K: the split path with a short last slab, K and N not
    # whole float4s (the kernels' cp.async path) and a second row tile
    ragged_split = (70, 32 * 32 * 32 + 37, 130)
    with Phase("kernels vs plain versions"):
        n_cases = 0
        for m, k, n in [(70, 1000, 130), (5, 33, 7),
                        ragged_split] + net5_dense:
            w = on_grid(torch.randn(k, n, generator=gen, device=dev)
                        / math.sqrt(k) * 2)
            b = on_grid(torch.randn(n, generator=gen, device=dev) * 0.1)
            assert float(w.abs().sum(0).max()) < 2.0 ** (24 - GRID_BITS)
            u0 = torch.randn(m, n, generator=gen, device=dev)
            s0 = spikes((m, n), 0.3)
            for d in DENSITIES:
                s = spikes((m, k), d)
                what = f"S{(m, k)} W{(k, n)} density {d}"
                hold("spike_gemm", [ops.spike_gemm(s, w)],
                     [ref.spike_gemm_ref(s, w)], what)
                for reset in ("subtract", "zero"):
                    hold("spike_gemm_lif",
                         ops.spike_gemm_lif_step(
                             s, w, b, u0, s0, beta=0.95, threshold=1.0,
                             reset_mechanism=reset),
                         ref.spike_gemm_lif_ref(
                             s, w, b, u0, s0, beta=0.95, threshold=1.0,
                             reset_mechanism=reset), f"{what} {reset}")
                n_cases += 3
        for shape, feats, k, stride, padding in CONV_CASES:
            cin = shape[-1]
            w = on_grid(torch.randn(k, k, cin, feats, generator=gen,
                                    device=dev) / math.sqrt(k * k * cin) * 2)
            conv = dict(stride=stride, padding=padding)
            what = f"x{shape} {k}x{k}x{feats} stride {stride} {padding}"
            for d in DENSITIES:
                x = spikes(shape, d)
                want = ref.spike_conv_ref(x, w, **conv)
                hold("spike_conv", [ops.spike_conv(x, w, **conv),
                                    ops.spike_conv(x, w, **conv)],
                     [want, want], f"{what} density {d} (twice)")
                n_cases += 1
            # inputs other than spikes: each event's own value (2^-2 grid)
            x = spikes(shape, 0.3) * torch.randint(
                1, 9, shape, generator=gen, device=dev) / 4
            hold("spike_conv", [ops.spike_conv(x, w, **conv)],
                 [ref.spike_conv_ref(x, w, **conv)], f"{what} values")
            n_cases += 1
        torch.cuda.synchronize()
        log(f"{n_cases} cases equal to the plain versions on 2^-"
            f"{GRID_BITS}-grid weights; max |diff| {errs}")
        # the split kernels add their partials in a fixed order: two calls
        # on normal weights give the same bytes
        for m, k, n in (net5_dense[0], ragged_split):
            s = spikes((m, k), 0.2)
            w = torch.randn(k, n, generator=gen, device=dev) / math.sqrt(k)
            b = torch.randn(n, generator=gen, device=dev) * 0.1
            u0 = torch.randn(m, n, generator=gen, device=dev)
            s0 = spikes((m, n), 0.3)
            kw = dict(beta=0.95, threshold=1.0)
            if not (torch.equal(ops.spike_gemm(s, w), ops.spike_gemm(s, w))
                    and all(torch.equal(a, c) for a, c in zip(
                        ops.spike_gemm_lif_step(s, w, b, u0, s0, **kw),
                        ops.spike_gemm_lif_step(s, w, b, u0, s0, **kw)))):
                raise AssertionError(f"two calls at {(m, k, n)} differ")
            log(f"  {(m, k, n)}, split {gemm_kernel.split_plan(m, n, k)}: "
                f"two calls give the same bytes (both kernels)")
        # normal weights: the sums are rounded in another order, so the
        # stated tolerance is relative to the largest sum of |s*w|, and
        # spikes must agree wherever u is farther than that from threshold
        normal = {}

        def hold_close(name, got, want, norm, what):
            diff = (got - want).abs().max().item()
            rel = diff / norm
            log(f"  {name} on normal weights, {what}: max |diff| {diff:.3g}, "
                f"/ max sum|s*w| = {rel:.3g} (tolerance {NORMAL_RTOL:g})")
            if not rel < NORMAL_RTOL:
                raise AssertionError(f"{name} off by {rel} on normal weights "
                                     f"({what})")
            errs[name] = max(errs[name], diff)
            normal[name] = max(normal.get(name, 0.0), rel)

        m, k, n = net5_dense[0]
        s = spikes((m, k), 0.1)
        w = torch.randn(k, n, generator=gen, device=dev) / math.sqrt(k)
        b = torch.randn(n, generator=gen, device=dev) * 0.1
        norm = (s @ w.abs()).max().item()
        hold_close("spike_gemm", ops.spike_gemm(s, w),
                   ref.spike_gemm_ref(s, w), norm, f"fc1 S{(m, k)}")
        u0 = torch.randn(m, n, generator=gen, device=dev)
        s0 = spikes((m, n), 0.3)
        for reset in ("subtract", "zero"):
            kw = dict(beta=0.95, threshold=1.0, reset_mechanism=reset)
            got_u, got_s = ops.spike_gemm_lif_step(s, w, b, u0, s0, **kw)
            want_u, want_s = ref.spike_gemm_lif_ref(s, w, b, u0, s0, **kw)
            hold_close("spike_gemm_lif", got_u, want_u, norm,
                       f"fc1 S{(m, k)} u, {reset} reset")
            far = (want_u - 1.0).abs() > NORMAL_RTOL * norm
            if not torch.equal(got_s[far], want_s[far]):
                raise AssertionError(f"spike_gemm_lif spikes differ away "
                                     f"from the threshold ({reset} reset)")
            log(f"  spike_gemm_lif spikes equal on {int(far.sum())} of "
                f"{far.numel()} outputs outside the threshold band")
        for layer, shape in (("conv1", (BATCH, 128, 128, 2)),
                             ("conv2", (BATCH, 64, 64, 32))):
            cin = shape[-1]
            x = spikes(shape, 0.1)
            w = torch.randn(3, 3, cin, 32, generator=gen,
                            device=dev) / math.sqrt(9 * cin)
            norm = ref.spike_conv_ref(x, w.abs()).max().item()
            hold_close("spike_conv", ops.spike_conv(x, w),
                       ref.spike_conv_ref(x, w), norm, f"{layer} x{shape}")
        del x, w
        report["normal_weights_rel_err"] = normal

    # ---- 3. the backward kernels against their plain versions ----------
    net5_bwd = {"conv1": (BATCH * 128 * 128, 18, 32),
                "conv2": (BATCH * 64 * 64, 288, 32),
                "fc1": (BATCH, 32 * 32 * 32, 512), "fc2": (BATCH, 512, 256),
                "fc3": (BATCH, 256, 11)}
    with Phase("backward kernels vs plain versions"):
        n_cases = 0
        # the matrix kernels: dW and dS of the dense layers (a conv layer's
        # dS runs in conv form, below)
        for m, k, n in [(70, 1000, 130), (5, 33, 7), (4100, 18, 32)] + [
                net5_bwd[layer] for layer in ("fc1", "fc2", "fc3")]:
            w = on_grid(torch.randn(k, n, generator=gen, device=dev)
                        / math.sqrt(k) * 2)
            for d in DENSITIES + ("values",):
                s = spikes((m, k), 0.3 if d == "values" else d)
                if d == "values":
                    s = s * torch.randint(1, 9, (m, k), generator=gen,
                                          device=dev) / 4
                g = cotangent((m, n), 0.3 if d == "values" else d)
                bound_dw = float((s.T @ g.abs()).max())
                bound_ds = float((g.abs() @ w.abs().T).max())
                if not (bound_dw < 2.0 ** 22
                        and bound_ds < 2.0 ** (24 - GRID_BITS)):
                    raise AssertionError("operands break the exact-sum bound")
                what = f"S{(m, k)} g{(m, n)} W{(k, n)} density {d}"
                dw = ops.spike_gemm_bwd_dw(s, g)
                ds = ops.spike_gemm_bwd_ds(g, w)
                hold("spike_gemm_dw", [dw, ops.spike_gemm_bwd_dw(s, g)],
                     [ref.spike_gemm_dw_ref(s, g)] * 2, what + " (twice)")
                hold("spike_gemm_ds", [ds, ops.spike_gemm_bwd_ds(g, w)],
                     [ref.spike_gemm_ds_ref(g, w)] * 2, what + " (twice)")
                n_cases += 2
        # the conv layers' dW, on their input spikes, and dS, in conv form
        for shape, feats, k, stride, padding in CONV_CASES:
            conv = dict(stride=stride, padding=padding)
            w = on_grid(torch.randn(k, k, shape[-1], feats, generator=gen,
                                    device=dev) / math.sqrt(k * k) * 2)
            for d in DENSITIES + ("values",):
                x = spikes(shape, 0.3 if d == "values" else d)
                if d == "values":
                    x = x * torch.randint(1, 9, shape, generator=gen,
                                          device=dev) / 4
                oh, ow = ref.spike_conv_ref(
                    x[..., :1], torch.zeros(k, k, 1, 1, device=dev),
                    **conv).shape[1:3]
                g = cotangent((shape[0], oh, ow, feats),
                              0.3 if d == "values" else d)
                if not (float(ref.spike_conv_dw_ref(
                        x.abs(), g.abs(), k, k, **conv).max()) < 2.0 ** 22
                        and float(ref.spike_conv_ds_ref(
                            g.abs(), w.abs(), shape, **conv).max())
                        < 2.0 ** (24 - GRID_BITS)):
                    raise AssertionError("operands break the exact-sum bound")
                what = (f"x{shape} {k}x{k}x{feats} stride {stride} "
                        f"{padding} density {d} (twice)")
                dw = ops.spike_conv_bwd_dw(x, g, kernel_size=(k, k), **conv)
                want = ref.spike_conv_dw_ref(x, g, k, k, **conv)
                hold("spike_gemm_dw",
                     [dw, ops.spike_conv_bwd_dw(x, g, kernel_size=(k, k),
                                                **conv)], [want, want],
                     f"conv dW {what}")
                ds = ops.spike_conv_bwd_ds(g, w, shape, **conv)
                want = ref.spike_conv_ds_ref(g, w, shape, **conv)
                hold("spike_gemm_ds",
                     [ds, ops.spike_conv_bwd_ds(g, w, shape, **conv)],
                     [want, want], f"conv dS {what}")
                n_cases += 2
        torch.cuda.synchronize()
        log(f"{n_cases} cases equal to the plain versions on grid operands "
            f"(each twice, the same bytes both times); max |diff| "
            f"{ {k: errs[k] for k in BACKWARD} }")
        # one forward and backward of the conv's autograd Function on the
        # card and on the CPU, on grid operands
        for shape, feats, k, stride, padding in CONV_CASES[:5]:
            x = spikes(shape, 0.2)
            w = on_grid(torch.randn(k, k, shape[-1], feats, generator=gen,
                                    device=dev))
            out = ref.spike_conv_ref(x, w, stride=stride, padding=padding)
            g = cotangent(tuple(out.shape), 0.6)
            steps = []
            for where in (dev, torch.device("cpu")):
                xs, ws = (t.to(where).requires_grad_() for t in (x, w))
                o = ops.spike_conv_train(xs, ws, stride=stride,
                                         padding=padding)
                steps.append([t.cpu() for t in (o, *torch.autograd.grad(
                    o, (xs, ws), g.to(where)))])
            if not all(torch.equal(a, b) for a, b in zip(*steps)):
                raise AssertionError(f"spike_conv_train on the card differs "
                                     f"from the CPU's at x{shape}")
        log("  spike_conv_train's output, dS and dW on the card equal the "
            "CPU's on 5 ragged layers")
        g = torch.zeros(40, 64, device=dev)
        g[3, 5], g[7, 9] = 0.75, -0.75          # one tile, its sum is zero
        if ops.cotangent_block_flags(g).tolist() != [[1, 0], [0, 0]] or \
                not torch.equal(ops.spike_gemm_bwd_ds(
                    g, torch.ones(6, 64, device=dev))[[3, 7]],
                    torch.tensor([[0.75] * 6, [-0.75] * 6], device=dev)):
            raise AssertionError("dS skipped a tile whose entries cancel")
        g = torch.zeros(2, 8, 8, 32, device=dev)
        g[1, 3, 4, :16], g[1, 3, 4, 16:] = 0.75, -0.75   # a row sums to 0
        w = torch.ones(3, 3, 32, 32, device=dev)
        w[..., 16:] = 2.0
        ds = ops.spike_conv_bwd_ds(g, w, (2, 8, 8, 32))
        if not (torch.equal(ds, ref.spike_conv_ds_ref(g, w, (2, 8, 8, 32)))
                and int((ds != 0).sum()) == 9 * 32):
            raise AssertionError("the conv dS skipped a cotangent pixel "
                                 "whose entries cancel")
        log("  a cotangent tile of +0.75 and -0.75 (dense dS) and a "
            "cotangent pixel of +0.75 and -0.75 (conv dS) are not skipped")
        # normal cotangents: the same bytes on two calls, and within the
        # stated tolerance of the plain versions; the conv dS equals col2im
        # of the card's dense dS in patch space bit for bit (the same order
        # of sums)
        for layer, shape in (("conv1", (BATCH, 128, 128, 2)),
                             ("conv2", (BATCH, 64, 64, 32))):
            x = spikes(shape, 0.1)
            g = torch.randn(shape[:3] + (32,), generator=gen, device=dev)
            dw = ops.spike_conv_bwd_dw(x, g, kernel_size=(3, 3))
            if not torch.equal(dw, ops.spike_conv_bwd_dw(
                    x, g, kernel_size=(3, 3))):
                raise AssertionError(f"dW differs between two runs ({layer})")
            hold_close("spike_gemm_dw", dw, ref.spike_conv_dw_ref(x, g, 3, 3),
                       ref.spike_conv_dw_ref(x, g.abs(), 3, 3).max().item(),
                       f"{layer} x{shape}")
        w = torch.randn(3, 3, 32, 32, generator=gen, device=dev) / math.sqrt(
            9 * 32)
        ds = ops.spike_conv_bwd_ds(g, w, shape)
        if not (torch.equal(ds, ops.spike_conv_bwd_ds(g, w, shape))
                and torch.equal(ds, conv_kernel.conv_col2im(
                    bwd_kernel.spike_gemm_ds_cuda(g.reshape(-1, 32),
                                                  w.reshape(-1, 32)),
                    shape, 3, 3, 1, "SAME"))):
            raise AssertionError("the conv dS differs between two runs or "
                                 "from col2im of the dense dS (conv2)")
        hold_close("spike_gemm_ds", ds, ref.spike_conv_ds_ref(g, w, shape),
                   ref.spike_conv_ds_ref(g.abs(), w.abs(), shape).max().item(),
                   f"conv2 x{shape}, conv form")
        m, k, n = net5_bwd["fc1"]
        s = spikes((m, k), 0.1)
        g = torch.randn(m, n, generator=gen, device=dev)
        w = torch.randn(k, n, generator=gen, device=dev) / math.sqrt(k)
        dw, ds = ops.spike_gemm_bwd_dw(s, g), ops.spike_gemm_bwd_ds(g, w)
        if not (torch.equal(dw, ops.spike_gemm_bwd_dw(s, g))
                and torch.equal(ds, ops.spike_gemm_bwd_ds(g, w))):
            raise AssertionError("fc1's dW or dS differs between two runs")
        hold_close("spike_gemm_dw", dw, ref.spike_gemm_dw_ref(s, g),
                   (s.T @ g.abs()).max().item(), f"fc1 {(m, k, n)}")
        hold_close("spike_gemm_ds", ds, ref.spike_gemm_ds_ref(g, w),
                   (g.abs() @ w.abs().T).max().item(), f"fc1 {(m, k, n)}")
        log("  the conv dS equals col2im of the dense dS on normal operands; "
            "dW and dS give the same bytes twice")
        del s, g, w, dw, ds, x
        report["normal_weights_rel_err"] = normal

    # ---- 3b. the kernel API's lif_step and penc_compact ------------------
    net5_membranes = {"conv1": (BATCH, 128 * 128 * 32),
                      "conv2": (BATCH, 64 * 64 * 32), "fc1": (BATCH, 512),
                      "fc2": (BATCH, 256), "fc3": (BATCH, 11)}

    def unaligned(x):
        """A contiguous copy of ``x`` 4 bytes past a 16-byte boundary:
        the kernels' unvectorised path."""
        buf = torch.empty(x.numel() + 8, dtype=x.dtype, device=dev)
        y = buf[1:1 + x.numel()].view(x.shape)
        y.copy_(x)
        return y

    def serial_penc_agrees(rows, idx, cnt, n_rows=3):
        """The validator's serial chunked priority encoder on a few rows."""
        for b in range(min(n_rows, rows.shape[0])):
            serial = validate.penc_compress(
                rows[b].cpu().numpy().astype(np.int64))
            got = idx[b].cpu().numpy()
            if got[got >= 0].tolist() != serial[:idx.shape[1]] or \
                    int(cnt[b]) != len(serial):
                raise AssertionError("penc_compact differs from "
                                     "validate.penc_compress")

    with Phase("kernel API kernels (lif_step, penc_compact) vs plain "
               "versions"):
        n_cases = 0
        for shape in [(70, 1000), (5, 33), (3, 1), (1, 4099)] + list(
                net5_membranes.values()):
            u0 = torch.randn(shape, generator=gen, device=dev)
            s0 = spikes(shape, 0.3)
            cur = torch.randn(shape, generator=gen, device=dev)
            for dtype in (torch.float32, torch.bfloat16):
                args = [a.to(dtype) for a in (u0, s0, cur)]
                if shape == (70, 1000):
                    args += [unaligned(a) for a in args]
                for reset in ("subtract", "zero"):
                    kw = dict(beta=0.95, threshold=1.0,
                              reset_mechanism=reset)
                    for i in range(0, len(args), 3):
                        got = ops.lif_step(*args[i:i + 3], **kw)
                        if any(g.dtype != dtype for g in got):
                            raise AssertionError("lif_step changed dtype")
                        hold("lif_step", got,
                             ref.lif_step_ref(*args[i:i + 3], **kw),
                             f"{shape} {dtype} {reset}")
                        n_cases += 1
        del u0, s0, cur, args, got
        for shape in [(70, 1000), (5, 33), (3, 1), (64, 4099),
                      (BATCH, 64 * 64 * 32)]:
            for d in DENSITIES:
                x = spikes(shape, d)
                for xx in ([x, unaligned(x)] if shape == (64, 4099)
                           else [x]):
                    for cap in (shape[1], PENC_CHUNK):
                        idx, cnt = ops.penc_compact(xx, cap)
                        hold("penc_compact", [idx, cnt],
                             ref.penc_compact_ref(xx, cap),
                             f"{shape} density {d} capacity {cap}")
                        n_cases += 1
                serial_penc_agrees(x, *ops.penc_compact(x, shape[1]))
        torch.cuda.synchronize()
        log(f"{n_cases} cases equal to the plain versions bit for bit "
            f"(lif_step in fp32 and bf16, both resets, aligned and "
            f"unaligned; penc_compact at capacity N and {PENC_CHUNK}); a "
            f"few rows equal to validate.penc_compress")

    # ---- 4. the inference path ------------------------------------------
    cfg = snn.SNNConfig(
        "net-5", (128, 128, 2),
        (snn.Conv(32, 3), snn.MaxPool(2), snn.Conv(32, 3), snn.MaxPool(2),
         snn.Dense(512), snn.Dense(256), snn.Dense(11)),
        num_classes=11, pcr=1, num_steps=NUM_STEPS)
    with Phase("net-5 data and weights"):
        data = synthetic.make_events(name="synth-dvs-net5", seed=SEED,
                                     num_classes=11, n_train=2,
                                     n_test=BATCH, t=NUM_STEPS, h=128, w=128)
        params = snn.init_params(torch.Generator().manual_seed(SEED), cfg,
                                 device=dev)
        gains = iter(GAINS)
        for p in params:
            if p:
                p["w"] = on_grid(p["w"] * next(gains))
                colsum = float(p["w"].abs().reshape(
                    -1, p["w"].shape[-1]).sum(0).max())
                if not colsum < 2.0 ** (24 - GRID_BITS):
                    raise AssertionError(f"column sum {colsum} breaks the "
                                         f"exact-sum bound")
        log(f"events {data.x_test.shape}, density {data.x_test.mean():.4f}; "
            f"gains {GAINS}, weights on the 2^-{GRID_BITS} grid")

    with Phase("traffic probe (not counted)"):
        with torch.inference_mode():
            x = torch.as_tensor(data.x_test, device=dev).permute(
                1, 0, 2, 3, 4)
            trains = snn.layer_input_trains(cfg, params, x)
            names = ["conv1", "conv2", "fc1", "fc2", "fc3"]
            specs = cfg.spiking_layers()
            probe, layer_rates = {}, {}
            t_mid = NUM_STEPS // 2
            for name, spec, train in zip(names, specs, trains):
                rate = float(train.mean())
                if isinstance(spec, snn.Conv):
                    # the share of output pixels no event reaches: the
                    # conv kernels store zeros there and read no g row
                    skips = [float((conv_reach(
                        torch, ref, train[t], spec.kernel, spec.stride,
                        spec.padding) == 0).double().mean())
                        for t in range(NUM_STEPS)]
                    what = "output pixels no event reaches"
                else:
                    skips = [ops.skip_fraction(train[t].reshape(BATCH, -1))
                             for t in range(NUM_STEPS)]
                    what = (f"skip fraction at {build.TILE['block_m']}x"
                            f"{build.TILE['block_k']} tiles")
                layer_rates[name] = {"input_rate": rate,
                                     "skip_fraction": statistics.fmean(skips)}
                log(f"  {name} input: firing rate {rate:.4f}, {what} "
                    f"{statistics.fmean(skips):.4f}")
                if rate == 0.0:
                    raise AssertionError(f"{name}'s input train is empty: "
                                         f"the kernels would skip it all")
                probe[name] = train[t_mid].contiguous().clone()
            api_trains = dict(zip(names, trains))
            del trains, x
        report["layers"] = layer_rates

    with Phase("the kernel API on net-5's traffic (the path of lif_step "
               "and penc_compact)"):
        api_layers = dict(zip(names, zip(specs, [p for p in params if p])))
        dense_names = ("fc1", "fc2", "fc3")
        with torch.inference_mode():
            perms = {name: api.firing_rate_permutation(
                api_trains[name].reshape(NUM_STEPS * BATCH, -1).mean(0))
                for name in dense_names}
            outs = {name: torch.empty(
                (NUM_STEPS, BATCH, api_layers[name][1]["w"].shape[1]),
                device=dev) for name in dense_names}
            state = {name: (torch.zeros(out.shape[1:], device=dev),
                            torch.zeros(out.shape[1:], device=dev))
                     for name, out in outs.items()}
            addr_counts = torch.empty((NUM_STEPS, len(names), BATCH),
                                      dtype=torch.int32, device=dev)
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            for t in range(NUM_STEPS):
                # the ECU's addresses of every layer's input spikes
                for i, name in enumerate(names):
                    rows = api_trains[name][t].reshape(BATCH, -1)
                    idx, addr_counts[t, i] = api.penc_compact(
                        rows, rows.shape[1])
                # the dense stack, one layer after the other
                s_in = api_trains["fc1"][t].reshape(BATCH, -1)
                for name in dense_names:
                    spec, p = api_layers[name]
                    cur = api.spike_gemm_profiled(s_in, p["w"],
                                                  perms[name]) + p["b"]
                    u, s_in = api.lif_step(
                        *state[name], cur, beta=spec.lif.beta,
                        threshold=spec.lif.threshold,
                        reset_mechanism=spec.lif.reset_mechanism)
                    state[name] = (u, s_in)
                    outs[name][t] = s_in
            torch.cuda.synchronize()
            api_s = time.perf_counter() - t0
            api_launches = ops.launch_counts()
            want = {k: NUM_STEPS * v for k, v in API_EXPECTED.items()}
            log(f"  {NUM_STEPS} steps in {api_s:.2f} s; launches "
                f"{api_launches}")
            if api_launches != want:
                raise AssertionError(f"the kernel API path launched "
                                     f"{api_launches}, expected {want}")
            for name, nxt in (("fc1", "fc2"), ("fc2", "fc3")):
                if not torch.equal(outs[name], api_trains[nxt].reshape(
                        outs[name].shape)):
                    raise AssertionError(
                        f"{name}'s spikes through spike_gemm_profiled + "
                        f"lif_step differ from the model's input to {nxt}")
            for i, name in enumerate(names):
                sums = api_trains[name].reshape(NUM_STEPS, BATCH, -1).sum(-1)
                if not torch.equal(addr_counts[:, i].double(),
                                   sums.double()):
                    raise AssertionError(f"penc_compact's counts of {name}'s "
                                         f"input differ from its spikes")
            log("  fc1's and fc2's spikes equal the model's own bit for bit; "
                "every address count equals its row's spikes")
            report["api_path"] = {
                "seconds": api_s, "launches": api_launches,
                "address_counts_mean": {
                    name: float(addr_counts[:, i].double().mean())
                    for i, name in enumerate(names)}}
        # the counted run is over: compare penc_compact on one step of the
        # real traffic with its plain version at capacity N and at the ECU's
        # chunk, and a few rows with the validator's serial encoder
        for name in names:
            rows = probe[name].reshape(BATCH, -1)
            for cap in (rows.shape[1], PENC_CHUNK):
                idx, cnt = ops.penc_compact(rows, cap)
                hold("penc_compact", [idx, cnt],
                     ref.penc_compact_ref(rows, cap),
                     f"{name}'s input traffic, step {t_mid}, capacity {cap}")
            serial_penc_agrees(rows, *ops.penc_compact(rows, rows.shape[1]))
        log(f"  penc_compact on step {t_mid}'s traffic of every layer equals "
            f"its plain version (capacity N and {PENC_CHUNK}) and the "
            f"serial encoder")
        del api_trains, outs, state, addr_counts, perms

    with Phase("main path on every backend"):
        results, launches = {}, {}
        for backend in EXPECTED:
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            acc = train_snn.evaluate(cfg, params, data.x_test, data.y_test,
                                     matmul_backend=backend)
            traces = train_snn.dump_traces(cfg, params, data.x_test,
                                           max_samples=BATCH,
                                           matmul_backend=backend)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            mean_counts = train_snn.trace_counts(cfg, params, data.x_test,
                                                 max_samples=BATCH,
                                                 matmul_backend=backend)
            launches[backend] = ops.launch_counts()
            results[backend] = (acc, traces["layer_input_spike_counts"],
                                mean_counts)
            log(f"  {backend}: accuracy {acc:.4f}, evaluate + dump_traces "
                f"{secs:.2f} s; launches {launches[backend]}")
            report.setdefault("main_path_seconds", {})[backend] = secs
            # one inference each in evaluate (B = 64 is one batch),
            # dump_traces and trace_counts, NUM_STEPS steps each
            want = {name: 3 * NUM_STEPS * layers
                    for name, layers in EXPECTED[backend].items()}
            if launches[backend] != want:
                raise AssertionError(f"the {backend} path launched "
                                     f"{launches[backend]}, expected {want}")
        report["launches"] = launches
        acc0, counts0, mean0 = results["spike_gemm_fused"]
        for backend, (acc, counts, mean_counts) in results.items():
            if acc != acc0 or not all(
                    np.array_equal(a, b) for a, b in
                    zip(counts + mean_counts, counts0 + mean0)) or len(
                    counts) != len(counts0):
                raise AssertionError(f"traces of {backend} differ from "
                                     f"spike_gemm_fused's")
        for c, m in zip(counts0, mean0):
            if c.shape != (NUM_STEPS, BATCH) or not np.isfinite(c).all() \
                    or not np.array_equal(m, c.mean(axis=1)):
                raise AssertionError(f"bad trace {c.shape}")
        log(f"traces and trace_counts identical across {list(results)}: "
            f"{len(counts0)} layers of {counts0[0].shape}, mean counts "
            f"{[round(float(m.mean()), 2) for m in mean0]}")

    with Phase("accelerator model and DSE"):
        accel = arch.from_snn_config(cfg)
        result = dse.search(accel, mean0)
        best = result.frontier.row(result.frontier.argmin("cycles"))
        log(f"evaluated {result.n_evaluated} LHR candidates; frontier of "
            f"{len(result.frontier)}; lowest cycles: {best}")
        if result.n_evaluated != 11664 or len(result.frontier) == 0:
            raise AssertionError("unexpected DSE result")
        report["dse"] = {"n_evaluated": result.n_evaluated,
                         "frontier_size": len(result.frontier),
                         "lowest_cycles_row": best}

    with Phase("where the time goes: profile of 8 steps per backend"):
        from torch.profiler import ProfilerActivity, profile
        steps = 8
        xs = torch.as_tensor(data.x_test[:, :steps], device=dev).permute(
            1, 0, 2, 3, 4)
        profiles = {}
        for backend in ("spike_gemm_fused", "torch"):
            with torch.inference_mode():
                snn.apply(cfg, params, xs, matmul_backend=backend)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                snn.apply(cfg, params, xs, matmul_backend=backend)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    snn.apply(cfg, params, xs, matmul_backend=backend)
                    torch.cuda.synchronize()
            by_name = {}
            for e in prof.events():
                if e.device_type == torch.autograd.DeviceType.CUDA:
                    tot, n = by_name.get(e.name, (0.0, 0))
                    by_name[e.name] = (tot + e.device_time_total, n + 1)
            busy_ms = sum(t for t, _ in by_name.values()) / 1e3
            top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
            profiles[backend] = {
                "steps": steps, "wall_ms_unprofiled": wall * 1e3,
                "device_busy_ms": busy_ms,
                "busy_share": busy_ms / (wall * 1e3),
                "kernel_launches_per_step": sum(
                    n for _, n in by_name.values()) / steps,
                "top": [{"name": k[:80], "ms": t / 1e3, "calls": n}
                        for k, (t, n) in top]}
            if not by_name:
                log(f"  {backend}: the profiler recorded no device time "
                    f"(busy share not measured)")
                continue
            log(f"  {backend}: {steps} steps in {wall * 1e3:.1f} ms "
                f"unprofiled; device busy {busy_ms:.1f} ms "
                f"({busy_ms / (wall * 1e3):.0%} of the unprofiled wall); "
                f"{profiles[backend]['kernel_launches_per_step']:.0f} "
                f"device kernels a step")
            for row in profiles[backend]["top"]:
                log(f"    {row['ms']:8.2f} ms {row['calls']:5d}x "
                    f"{row['name']}")
        report["profile"] = profiles

    # ---- 5. the training path -------------------------------------------
    xb = torch.as_tensor(data.x_test[:TRAIN_BATCH], device=dev)
    yb = torch.as_tensor(data.y_test[:TRAIN_BATCH], device=dev)
    enc = torch.Generator(device=dev)          # events: no bits are drawn

    def leaves_of(ps):
        return [{k: v.detach().clone().requires_grad_() for k, v in p.items()}
                for p in ps]

    def flat(ps):
        return [v for p in ps for v in p.values()]

    def timed_step(ps, backend):
        """Loss and gradients of one training step, with the seconds of its
        forward and of its backward (host clock, synchronised)."""
        leaves = leaves_of(ps)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = train_snn.loss_fn(cfg, leaves, enc, xb, yb,
                                 matmul_backend=backend)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        grads = torch.autograd.grad(loss, flat(leaves))
        torch.cuda.synchronize()
        return loss.detach(), grads, t1 - t0, time.perf_counter() - t1

    # dW's and dS's operands at the middle time step of the default
    # backend's backward, per layer: the traffic phase 4 times them on.
    # The backward walks t = T-1 .. 0, so t = T/2 is each layer's
    # (T/2)-th call.
    bwd_probe = {}

    def capturing(real, kind):
        calls = {}

        def wrapper(a, b, *args, **kw):
            key = (kind, tuple(a.shape), tuple(b.shape))
            calls[key] = calls.get(key, 0) + 1
            if calls[key] == NUM_STEPS - NUM_STEPS // 2:
                bwd_probe[key] = (a.detach().clone(), b.detach().clone(), {
                    k: v.clone() if torch.is_tensor(v) else v
                    for k, v in kw.items()}, args)
            return real(a, b, *args, **kw)
        return wrapper

    real_col2im = conv_kernel.conv_col2im

    def col2im_off_the_card(d_patches, *args):
        """``conv_col2im``, refused on a CUDA tensor: on the card a conv
        layer's dS is written in (B, H, W, C) directly."""
        if d_patches.is_cuda:
            raise AssertionError("conv_col2im ran on the card: a conv dS "
                                 "went through a patch-space cotangent")
        return real_col2im(d_patches, *args)

    with Phase("net-5 training step on every backend"):
        train_results, train_launches, train_report = {}, {}, {}
        for backend in EXPECTED:
            real = (ops.spike_gemm_bwd_dw, ops.spike_gemm_bwd_ds,
                    ops.spike_conv_bwd_dw, ops.spike_conv_bwd_ds)
            if backend == "spike_gemm_fused":
                ops.spike_gemm_bwd_dw = capturing(real[0], "dw")
                ops.spike_gemm_bwd_ds = capturing(real[1], "ds")
                ops.spike_conv_bwd_dw = capturing(real[2], "conv dw")
                ops.spike_conv_bwd_ds = capturing(real[3], "conv ds")
            conv_kernel.conv_col2im = ref.conv_col2im = col2im_off_the_card
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            try:
                loss, grads, fwd_s, bwd_s = timed_step(params, backend)
            finally:
                (ops.spike_gemm_bwd_dw, ops.spike_gemm_bwd_ds,
                 ops.spike_conv_bwd_dw, ops.spike_conv_bwd_ds) = real
                conv_kernel.conv_col2im = ref.conv_col2im = real_col2im
            train_launches[backend] = ops.launch_counts()
            peak = torch.cuda.max_memory_allocated()
            want = {name: NUM_STEPS * n
                    for name, n in TRAIN_EXPECTED[backend].items()}
            log(f"  {backend}: loss {loss.item()!r}; forward {fwd_s:.2f} s, "
                f"backward {bwd_s:.2f} s; peak memory {peak / 2**30:.2f} "
                f"GiB; launches {train_launches[backend]}")
            if train_launches[backend] != want:
                raise AssertionError(f"the {backend} training step launched "
                                     f"{train_launches[backend]}, expected "
                                     f"{want}")
            if not (torch.isfinite(loss) and all(
                    torch.isfinite(g).all() for g in grads)):
                raise AssertionError(f"{backend}: non-finite loss or grads")
            train_results[backend] = (loss, grads)
            train_report[backend] = {"loss": loss.item(),
                                     "forward_s": fwd_s, "backward_s": bwd_s,
                                     "peak_bytes": peak}
        loss0, grads0 = train_results["spike_gemm_fused"]
        for backend, (loss, grads) in train_results.items():
            if not torch.equal(loss, loss0):
                raise AssertionError(f"{backend}'s loss {loss.item()!r} is "
                                     f"not spike_gemm_fused's "
                                     f"{loss0.item()!r}")
            rel = max((g - g0).abs().max().item()
                      / max(g0.abs().max().item(), 1e-30)
                      for g, g0 in zip(grads, grads0))
            train_report[backend]["grad_rel_err"] = rel
            log(f"  {backend}: loss equal bit for bit; max |grad - "
                f"spike_gemm_fused's| / leaf max |grad| = {rel:.3g} "
                f"(tolerance {GRAD_RTOL:g})")
            if not rel <= GRAD_RTOL:
                raise AssertionError(f"{backend}'s gradients differ by {rel}")
        if sum(g.abs().sum().item() for g in grads0) == 0:
            raise AssertionError("every gradient is zero")
        log("  no training step ran conv_col2im on the card: the conv "
            "layers' dS built no patch-space cotangent")
        del train_results, grads
        report["train_step"] = train_report
        report["train_launches"] = train_launches

    with Phase("where the time goes: profile of one training step"):
        from torch.profiler import ProfilerActivity, profile
        leaves = leaves_of(params)
        halves = {}
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with profile(activities=acts) as prof_f:
            loss = train_snn.loss_fn(cfg, leaves, enc, xb, yb)
            torch.cuda.synchronize()
        with profile(activities=acts) as prof_b:
            torch.autograd.grad(loss, flat(leaves))
            torch.cuda.synchronize()
        del loss, leaves
        for half, prof in (("forward", prof_f), ("backward", prof_b)):
            by_name = {}
            for e in prof.events():
                if e.device_type == torch.autograd.DeviceType.CUDA:
                    tot, n = by_name.get(e.name, (0.0, 0))
                    by_name[e.name] = (tot + e.device_time_total, n + 1)
            busy = sum(t for t, _ in by_name.values()) / 1e3
            top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
            halves[half] = {"device_ms": busy, "kernels": sum(
                n for _, n in by_name.values()), "top": [
                {"name": k[:80], "ms": t / 1e3, "calls": n}
                for k, (t, n) in top]}
            log(f"  {half}: device busy {busy:.1f} ms in "
                f"{halves[half]['kernels']} kernels"
                + ("" if by_name else " (the profiler recorded no device "
                   "time: not measured)"))
            for row in halves[half]["top"]:
                log(f"    {row['ms']:8.2f} ms {row['calls']:6d}x "
                    f"{row['name']}")
        report["train_profile"] = halves

    with Phase(f"{ADAM_STEPS} Adam steps of net-5 on the default backend"):
        tx = optim.adam(2e-3)
        p = [{k: v.clone() for k, v in q.items()} for q in params]
        opt_state = tx.init(p)
        torch.cuda.reset_peak_memory_stats()
        steps = []
        for i in range(ADAM_STEPS):
            loss, grads, fwd_s, bwd_s = timed_step(p, None)
            t0 = time.perf_counter()
            it = iter(grads)
            with torch.no_grad():
                updates, opt_state = tx.update(
                    [{k: next(it) for k in q} for q in p], opt_state, p)
                p = optim.apply_updates(p, updates)
            torch.cuda.synchronize()
            steps.append({"loss": loss.item(), "forward_s": fwd_s,
                          "backward_s": bwd_s,
                          "update_s": time.perf_counter() - t0})
            log(f"  step {i}: loss {loss.item():.6f}; forward {fwd_s:.2f} s, "
                f"backward {bwd_s:.2f} s, update "
                f"{steps[-1]['update_s'] * 1e3:.1f} ms")
        peak = torch.cuda.max_memory_allocated()
        log(f"  peak memory {peak / 2**30:.2f} GiB "
            f"(torch.cuda.max_memory_allocated) at batch {TRAIN_BATCH}")
        if not all(math.isfinite(r["loss"]) for r in steps):
            raise AssertionError(f"non-finite loss: {steps}")
        if int(opt_state[0].count) != ADAM_STEPS:
            raise AssertionError("the optimizer did not count its steps")
        report["adam"] = {"steps": steps, "peak_bytes": peak,
                          "batch": TRAIN_BATCH}
        del p, opt_state, grads, updates

    # ---- 6. the whole cell through the torch TraceCache -----------------
    with Phase("dvs-conv cell through the torch TraceCache"):
        wl = workloads.get("dvs-conv")
        assignment = {"num_steps": CELL_STEPS}
        with tempfile.TemporaryDirectory() as root:
            cache = workloads.TraceCache(root=root)
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            miss = cache.resolve(wl, assignment, seed=SEED, quant_bits=(8,))
            torch.cuda.synchronize()
            miss_s = time.perf_counter() - t0
            cell_launches = ops.launch_counts()
            t0 = time.perf_counter()
            hit = cache.resolve(wl, assignment, seed=SEED, quant_bits=(8,))
            hit_s = time.perf_counter() - t0
        want = dvs_cell_launches(wl, CELL_STEPS)
        log(f"  miss: {miss_s:.1f} s (train {wl.train_steps} steps at batch "
            f"{wl.batch_size}, evaluate, dump_traces, 8-bit accuracy); hit: "
            f"{hit_s:.2f} s; float accuracy {miss.accuracy:.4f}, 8-bit "
            f"{miss.quant_acc.get(8)}; launches in the miss {cell_launches}")
        if (miss.cache_hit, hit.cache_hit) != (False, True):
            raise AssertionError("expected a miss, then a hit")
        if cell_launches != want:
            raise AssertionError(f"the cell launched {cell_launches}, "
                                 f"expected {want}")
        same = (hit.accuracy == miss.accuracy
                and hit.quant_acc == miss.quant_acc
                and len(hit.counts) == len(miss.counts) == 4
                and all(np.array_equal(a, b)
                        for a, b in zip(hit.counts, miss.counts))
                and all(np.array_equal(p[k], q[k])
                        for p, q in zip(hit.params, miss.params) for k in p))
        if not same:
            raise AssertionError("the hit differs from the miss")
        if not all(np.isfinite(c).all() and c.shape == (CELL_STEPS, 64)
                   for c in miss.counts) or not 0.0 <= miss.accuracy <= 1.0:
            raise AssertionError("bad cell artifact")
        report["cell"] = {"workload": wl.name, "num_steps": CELL_STEPS,
                          "miss_s": miss_s, "hit_s": hit_s,
                          "accuracy": miss.accuracy,
                          "quant_acc": miss.quant_acc,
                          "launches": cell_launches,
                          "mean_counts": [float(c.mean())
                                          for c in miss.counts]}

    # ---- 6b. the paper's study loop on the torch cache ------------------
    with Phase("the study loop: Fig.-1 sparsity, coexplore, a budgeted "
               "explore and its repeat"):
        study = {}
        t0 = time.perf_counter()
        stats = sparsity.analyze(cfg, params, torch.as_tensor(
            data.x_test, device=dev).permute(1, 0, 2, 3, 4))
        study["sparsity_s"] = time.perf_counter() - t0
        log(f"  net-5's input traffic per layer (sparsity.analyze, "
            f"{study['sparsity_s']:.2f} s):")
        for line in sparsity.firing_table(stats).splitlines():
            log(f"    {line}")
        # the same traffic as the inference phase's trace_counts
        if [s_.avg_spikes_per_step for s_ in stats] != [
                float(np.mean(m)) for m in mean0] or [
                s_.logical_neurons for s_ in stats] != [
                32768, 131072, 32768, 512, 256]:
            raise AssertionError("sparsity.analyze disagrees with the "
                                 "inference phase's traces")
        study["firing"] = [{"layer": s_.layer, "neurons": s_.logical_neurons,
                            "avg_spikes": s_.avg_spikes_per_step,
                            "firing_ratio": s_.firing_ratio}
                           for s_ in stats]

        def run(what, fn, cache):
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            row = {"seconds": secs, "misses": cache.misses,
                   "hits": cache.hits, "launches": ops.launch_counts(),
                   "n_evaluated": res.n_evaluated,
                   "frontier_size": len(res.frontier),
                   "cells": len(res.cells)}
            log(f"  {what}: {secs:.1f} s, {cache.misses} misses, "
                f"{cache.hits} hits, {res.n_evaluated} candidates, "
                f"frontier of {len(res.frontier)}; launches "
                f"{row['launches']}")
            if len(res.frontier) == 0 or any(
                    row["launches"][k] for k in API_ONLY):
                raise AssertionError(f"{what}: empty frontier, or the "
                                     f"model's path launched lif_step or "
                                     f"penc_compact")
            study[what] = row
            return res

        with tempfile.TemporaryDirectory() as root:
            dvs = workloads.get("dvs-conv")
            cache = workloads.TraceCache(root=root)
            co = run("coexplore dvs-conv", lambda: dse.coexplore(
                "dvs-conv", num_steps=(8, 12, 16), population=(1.0,),
                cache=cache), cache)
            want = {k: sum(dvs_cell_launches(dvs, t)[k] for t in (8, 12, 16))
                    for k in EXPECTED["torch"]}
            if (cache.misses, cache.hits) != (3, 0) or \
                    study["coexplore dvs-conv"]["launches"] != want:
                raise AssertionError(f"coexplore: expected 3 misses and "
                                     f"launches {want}")
            err = co.frontier.columns["error"]
            if not (np.isfinite(err).all() and (err >= 0).all()
                    and (err <= 1).all()):
                raise AssertionError("coexplore: error outside [0, 1]")
            best = co.best_under("cycles", error=float(err.min()) + 0.05)
            log(f"  fastest design within 5 points of the best error: "
                f"{best}")
            study["coexplore_best"] = best

            mlp = workloads.get("mnist-mlp")
            tmpl = arch.from_snn_config(mlp.build(4, 1.0))
            space = (dse.SearchSpace(tmpl)
                     .add_model("num_steps", (4, 8))
                     .add_model("population", (0.5, 1.0))
                     .add_per_layer("lhr", [dse.pow2_values(8)
                                            for _ in tmpl.layers])
                     .add_global("weight_bits", (4, 8)))

            def explore(cache, budget):
                return dse.explore(space, workload=mlp, cache=cache,
                                   train_budget=budget,
                                   strategy=dse.EvolutionarySearch(
                                       population=16, generations=4,
                                       seed=0))

            cache = workloads.TraceCache(root=root)
            first = run("explore mnist-mlp, train_budget=2",
                        lambda: explore(cache, 2), cache)
            spent = first.summary["train_budget"]["spent"]
            if not 0 < cache.misses == spent <= 2:
                raise AssertionError(f"explore: {cache.misses} misses for "
                                     f"a budget of 2 ({spent} spent)")
            # the repeat: the same study on the same root, with its budget
            # already spent as the first left it, may only hit
            cache = workloads.TraceCache(root=root)
            budget = workloads.TrainingBudget(2)
            budget.charge(spent)
            again = run("the same explore again", lambda: explore(
                cache, budget), cache)
            if cache.misses != 0 or cache.hits != len(again.cells):
                raise AssertionError("the repeat explore was not all hits")
            same = (first.frontier.columns.keys()
                    == again.frontier.columns.keys() and all(
                        np.array_equal(first.frontier.columns[k], v)
                        for k, v in again.frontier.columns.items()))
            if not same or {k: v for k, v in first.summary.items()
                            if k != "cache"} != {
                    k: v for k, v in again.summary.items() if k != "cache"}:
                raise AssertionError("the repeat explore's frontier or "
                                     "summary differs")
            log(f"  the repeat is all hits with an equal frontier and "
                f"summary: {again.summary}")
            study["explore_summary"] = first.summary
        report["study"] = study

    # ---- 7. timing at the main path's shapes and traffic -----------------
    layers = dict(zip(names, zip(specs, [p for p in params if p])))
    per_layer = []
    with Phase("timing"):
        for name in ("fc1", "fc2", "fc3"):
            spec, p = layers[name]
            s = probe[name].reshape(BATCH, -1)
            w, b = p["w"], p["b"]
            m, k = s.shape
            n = w.shape[1]
            flags = ops.block_flags(s)
            nnz = float(s.sum())
            u0 = torch.zeros(m, n, device=dev)
            s0 = torch.zeros(m, n, device=dev)
            s_read, _, w_rows = gated_counts(torch, flags, m, k)
            gemm_bytes = 4 * (s_read + w_rows * n + m * n + flags.numel())
            splits = gemm_kernel.split_plan(m, n, k)[0]
            row = {"kernel": "spike_gemm", "layer": name,
                   "shape": [m, k, n], "splits": splits,
                   "input_rate": nnz / s.numel(),
                   "skip_fraction": ops.skip_fraction(s),
                   "ms": median_ms(torch, lambda: ops.spike_gemm(s, w)),
                   "kernel_ms": median_ms(torch, lambda: gemm_kernel
                                          .spike_gemm_cuda(s, w, flags)),
                   "plain_ms": median_ms(torch,
                                         lambda: ref.spike_gemm_ref(s, w)),
                   "library_ms": median_ms(torch, lambda: torch.matmul(s, w)),
                   "kernel_device_ms": device_ms(torch, lambda: gemm_kernel
                                                 .spike_gemm_cuda(s, w,
                                                                  flags)),
                   "library_device_ms": device_ms(
                       torch, lambda: torch.matmul(s, w))}
            row["bound_ms"], row["bound_by"] = bound_ms(gemm_bytes,
                                                        2 * nnz * n)
            per_layer.append(row)
            lif = spec.lif
            fused_bytes = gemm_bytes + 4 * (n + 3 * m * n)
            row = {"kernel": "spike_gemm_lif", "layer": name,
                   "shape": [m, k, n], "splits": splits,
                   "input_rate": nnz / s.numel(),
                   "skip_fraction": ops.skip_fraction(s),
                   "ms": median_ms(torch, lambda: ops.spike_gemm_lif_step(
                       s, w, b, u0, s0, beta=lif.beta,
                       threshold=lif.threshold)),
                   "kernel_ms": median_ms(torch, lambda: fused_kernel
                                          .spike_gemm_lif_cuda(
                                              s, w, b, u0, s0, flags,
                                              beta=lif.beta,
                                              threshold=lif.threshold)),
                   "plain_ms": median_ms(torch, lambda: ref
                                         .spike_gemm_lif_ref(
                                             s, w, b, u0, s0, beta=lif.beta,
                                             threshold=lif.threshold)),
                   "library_ms": None,
                   "kernel_device_ms": device_ms(torch, lambda: fused_kernel
                                                 .spike_gemm_lif_cuda(
                                                     s, w, b, u0, s0, flags,
                                                     beta=lif.beta,
                                                     threshold=lif.threshold)
                                                 )}
            row["bound_ms"], row["bound_by"] = bound_ms(
                fused_bytes, 2 * nnz * n + 5 * m * n)
            per_layer.append(row)
        # the convs: the kernel reads every input and W once and writes
        # every output once; its operations are the events' (the nonzeros
        # of the patch matrix, which is never built), 2 * F each
        for name in ("conv1", "conv2"):
            spec, p = layers[name]
            x, w = probe[name], p["w"]
            x_nchw = x.permute(0, 3, 1, 2)          # channels-last strides
            w_oihw = w.permute(3, 2, 0, 1).contiguous()
            bsz, h, wd, c = x.shape
            feats = w.shape[-1]
            reach = conv_reach(torch, ref, x, 3, 1, "SAME")
            nnz = float(reach.sum())
            row = {"kernel": "spike_conv", "layer": name,
                   "shape": [bsz, h, wd, c, feats],
                   "input_rate": float(x.mean()),
                   "skip_fraction": float((reach == 0).double().mean()),
                   "ms": median_ms(torch, lambda: ops.spike_conv(x, w)),
                   "kernel_ms": median_ms(torch, lambda: conv_kernel
                                          .spike_conv_cuda(x, w, 1, "SAME")),
                   "plain_ms": median_ms(torch,
                                         lambda: ref.spike_conv_ref(x, w)),
                   "library_ms": median_ms(torch, lambda: F.conv2d(
                       x_nchw, w_oihw, padding=1)),
                   "kernel_device_ms": device_ms(
                       torch, lambda: conv_kernel.spike_conv_cuda(
                           x, w, 1, "SAME")),
                   "library_device_ms": device_ms(torch, lambda: F.conv2d(
                       x_nchw, w_oihw, padding=1))}
            row["bound_ms"], row["bound_by"] = bound_ms(
                4 * (x.numel() + w.numel() + bsz * h * wd * feats),
                2 * nnz * feats)
            per_layer.append(row)
        layer_of = {(m, k): name for name, (m, k, _) in net5_bwd.items()}
        conv_of = {(BATCH, 128, 128, 2): "conv1", (BATCH, 64, 64, 32): "conv2"}
        for (kind, _, _), (a, b, kw, args) in sorted(bwd_probe.items()):
            if kind == "conv dw":
                # dW reads the input spikes, the g rows an event reaches,
                # and writes dW; the bound of the matrix dW over the patch
                # matrix's flagged tiles is kept beside it (patch_bound_ms)
                x, g = a, b
                bsz, h, wd, c = x.shape
                n = g.shape[-1]
                reach = conv_reach(torch, ref, x, 3, 1, "SAME")
                nnz = float(reach.sum())
                x_nchw = x.permute(0, 3, 1, 2)
                g_nchw = g.permute(0, 3, 1, 2)
                w_shape = (n, c, 3, 3)
                row = {"kernel": "spike_gemm_dw",
                       "layer": layer_of[(bsz * h * wd, 9 * c)],
                       "shape": [bsz, h, wd, c, n],
                       "input_rate": float(x.mean()),
                       "skip_fraction": float((reach == 0).double().mean()),
                       "ms": median_ms(torch, lambda: ops.spike_conv_bwd_dw(
                           x, g, **kw)),
                       "kernel_ms": median_ms(torch, lambda: bwd_kernel
                                              .spike_conv_dw_cuda(
                                                  x, g, 3, 3, 1, "SAME")),
                       "plain_ms": median_ms(torch, lambda: ref
                                             .spike_conv_dw_ref(x, g, 3, 3)),
                       "library_ms": median_ms(
                           torch, lambda: torch.nn.grad.conv2d_weight(
                               x_nchw, w_shape, g_nchw, padding=1)),
                       "kernel_device_ms": device_ms(
                           torch, lambda: bwd_kernel.spike_conv_dw_cuda(
                               x, g, 3, 3, 1, "SAME")),
                       "library_device_ms": device_ms(
                           torch, lambda: torch.nn.grad.conv2d_weight(
                               x_nchw, w_shape, g_nchw, padding=1))}
                row["bound_ms"], row["bound_by"] = bound_ms(
                    4 * (x.numel() + float((reach > 0).sum()) * n
                         + 9 * c * n), 2 * nnz * n)
                patches = conv_kernel.conv_patches(x, 3, 3, 1, "SAME")
                flags = ops.block_flags(patches)
                s_read, g_rows, _ = gated_counts(torch, flags,
                                                 *patches.shape)
                row["patch_bound_ms"] = bound_ms(
                    4 * (s_read + g_rows * n + 9 * c * n + flags.numel()),
                    2 * nnz * n)[0]
                del patches, flags
            elif kind == "conv ds":
                # the whole input gradient: the kernel reads g and W once
                # and writes dS once; its operations are each nonzero of g
                # times the C channels of each input pixel it reaches
                g, w = a, b
                x_shape = tuple(args[0])
                bsz, h, wd, c = x_shape
                feats = w.shape[-1]
                nnz_px = (g != 0).sum(-1).double()
                reach = [torch.tensor([sum(0 <= o + d - 1 < size
                                           for d in range(3))
                                       for o in range(size)],
                                      dtype=torch.float64, device=dev)
                         for size in (h, wd)]
                nnz = float((nnz_px * reach[0][:, None]
                             * reach[1][None, :]).sum())
                g_nchw = g.permute(0, 3, 1, 2)
                w_oihw = w.permute(3, 2, 0, 1).contiguous()
                in_nchw = (bsz, c, h, wd)
                row = {"kernel": "spike_gemm_ds", "layer": conv_of[x_shape],
                       "shape": [bsz, h, wd, c, feats],
                       "cotangent_density": float((g != 0).double().mean()),
                       "zero_row_share": float((nnz_px == 0).double()
                                               .mean()),
                       "ms": median_ms(torch, lambda: ops.spike_conv_bwd_ds(
                           g, w, x_shape, **kw)),
                       "kernel_ms": median_ms(torch, lambda: bwd_kernel
                                              .spike_conv_ds_cuda(
                                                  g, w, x_shape, 1, "SAME")),
                       "plain_ms": median_ms(torch, lambda: ref
                                             .spike_conv_ds_ref(g, w,
                                                                x_shape)),
                       "library_ms": median_ms(
                           torch, lambda: torch.nn.grad.conv2d_input(
                               in_nchw, w_oihw, g_nchw, padding=1)),
                       "kernel_device_ms": device_ms(
                           torch, lambda: bwd_kernel.spike_conv_ds_cuda(
                               g, w, x_shape, 1, "SAME")),
                       "library_device_ms": device_ms(
                           torch, lambda: torch.nn.grad.conv2d_input(
                               in_nchw, w_oihw, g_nchw, padding=1))}
                row["bound_ms"], row["bound_by"] = bound_ms(
                    4 * (g.numel() + w.numel() + bsz * h * wd * c),
                    2 * nnz * c)
            elif kind == "dw":
                s, g, flags = a, b, kw["flags"]
                m, k = s.shape
                n = g.shape[1]
                nnz = float(s.sum())
                row = {"kernel": "spike_gemm_dw", "layer": layer_of[(m, k)],
                       "shape": [m, k, n], "input_rate": nnz / s.numel(),
                       "skip_fraction": 1.0 - flags.float().mean().item(),
                       "ms": median_ms(torch, lambda: ops.spike_gemm_bwd_dw(
                           s, g, flags=flags)),
                       "kernel_ms": median_ms(torch, lambda: bwd_kernel
                                              .spike_gemm_dw_cuda(s, g)),
                       "plain_ms": median_ms(
                           torch, lambda: ref.spike_gemm_dw_ref(s, g)),
                       "library_ms": median_ms(torch,
                                               lambda: torch.matmul(s.T, g)),
                       "kernel_device_ms": device_ms(
                           torch, lambda: bwd_kernel.spike_gemm_dw_cuda(s, g)),
                       "library_device_ms": device_ms(
                           torch, lambda: torch.matmul(s.T, g))}
                s_read, g_rows, _ = gated_counts(torch, flags, m, k)
                row["bound_ms"], row["bound_by"] = bound_ms(
                    4 * (s_read + g_rows * n + k * n + flags.numel()),
                    2 * nnz * n)
            else:
                g, w = a, b
                m, n = g.shape
                k = w.shape[0]
                gflags = ops.cotangent_block_flags(g)
                nnz = float((g != 0).sum())
                row = {"kernel": "spike_gemm_ds", "layer": layer_of[(m, k)],
                       "shape": [m, k, n], "cotangent_density":
                           nnz / g.numel(),
                       "skip_fraction": 1.0 - gflags.float().mean().item(),
                       "ms": median_ms(torch,
                                       lambda: ops.spike_gemm_bwd_ds(g, w)),
                       "kernel_ms": median_ms(torch, lambda: bwd_kernel
                                              .spike_gemm_ds_cuda(g, w)),
                       "plain_ms": median_ms(
                           torch, lambda: ref.spike_gemm_ds_ref(g, w)),
                       "library_ms": median_ms(torch,
                                               lambda: torch.matmul(g, w.T)),
                       "kernel_device_ms": device_ms(
                           torch, lambda: bwd_kernel.spike_gemm_ds_cuda(g, w)),
                       "library_device_ms": device_ms(
                           torch, lambda: torch.matmul(g, w.T))}
                g_read, _, w_cols = gated_counts(torch, gflags, m, n)
                row["bound_ms"], row["bound_by"] = bound_ms(
                    4 * (g_read + k * w_cols + m * k + gflags.numel()),
                    2 * nnz * k)
            per_layer.append(row)
        # the kernel API's kernels at net-5's shapes, one time step: the
        # LIF update of every layer's membrane (fp32; bf16 apart), and the
        # addresses of every layer's input traffic at step T/2 (capacity N;
        # the ECU's chunk apart).  Neither has one PyTorch call computing
        # the same function (torch.nonzero neither packs per row nor caps).
        for name, shape in net5_membranes.items():
            lif = layers[name][0].lif
            u0 = torch.randn(shape, generator=gen, device=dev)
            s0 = spikes(shape, 0.1)
            cur = torch.randn(shape, generator=gen, device=dev)
            for dtype in (torch.float32, torch.bfloat16):
                args = [a.to(dtype) for a in (u0, s0, cur)]
                kw = dict(beta=lif.beta, threshold=lif.threshold,
                          reset_mechanism=lif.reset_mechanism)
                row = {"kernel": "lif_step" if dtype == torch.float32
                       else "lif_step_bf16", "layer": name,
                       "shape": list(shape), "dtype": str(dtype),
                       "ms": median_ms(torch, lambda: ops.lif_step(
                           *args, **kw)),
                       "kernel_ms": median_ms(torch, lambda: lif_kernel
                                              .lif_step_cuda(*args, **kw)),
                       "plain_ms": median_ms(torch, lambda: ref.lif_step_ref(
                           *args, **kw)),
                       "library_ms": None}
                # 3 reads and 2 writes of each element; 5 operations each
                row["bound_ms"], row["bound_by"] = bound_ms(
                    5 * args[0].element_size() * args[0].numel(),
                    5 * args[0].numel())
                per_layer.append(row)
        del u0, s0, cur, args
        for name in names:
            rows = probe[name].reshape(BATCH, -1)
            b, n = rows.shape
            for cap in (n, PENC_CHUNK):
                row = {"kernel": "penc_compact" if cap == n
                       else "penc_compact_chunk", "layer": name,
                       "shape": [b, n], "capacity": cap,
                       "input_rate": float(rows.mean()),
                       "ms": median_ms(torch, lambda: ops.penc_compact(
                           rows, cap)),
                       "kernel_ms": median_ms(torch, lambda: penc_kernel
                                              .penc_compact_cuda(rows, cap)),
                       "plain_ms": median_ms(torch, lambda: ref
                                             .penc_compact_ref(rows, cap)),
                       "library_ms": None}
                # read every spike once, write every address slot and count
                row["bound_ms"], row["bound_by"] = bound_ms(
                    4 * (b * n + b * (cap + 1)), b * n)
                per_layer.append(row)
        if sorted(r["layer"] for r in per_layer
                  if r["kernel"] == "spike_gemm_dw") != sorted(net5_bwd) or \
                len([r for r in per_layer
                     if r["kernel"] == "spike_gemm_ds"]) != 4:
            raise AssertionError("the backward's operands were not captured "
                                 "for every layer")
        for row in per_layer:
            log("  " + json.dumps(row))
        report["per_layer"] = per_layer

    kernels = []
    for name in LINES:
        rows = [r for r in per_layer if r["kernel"] == name]
        lib = [r["library_ms"] for r in rows]
        bound = sum(r["bound_ms"] for r in rows)
        # forward kernels: launches of the inference path; backward
        # kernels: of one net-5 training step; the kernel API's own: of the
        # kernel API phase
        counted = train_launches if name in BACKWARD else launches
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "headers": [f"src/repro_torch/kernels/csrc/{h}"
                        for h in HEADERS[name]],
            "replaces": LINES[name],
            "launches": (api_launches[name] if name in API_ONLY
                         else counted[LAUNCHED_ON[name]][name]),
            "launched_on": LAUNCHED_ON[name],
            "launches_by_backend": {b: c[name] for b, c in counted.items()},
            "training_launches_by_backend": {
                b: c[name] for b, c in train_launches.items()},
            "api_path_launches": api_launches[name],
            "max_abs_err": errs[name],
            "normal_weights_rel_err": normal.get(name),
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": bound,
            "bound_by": max(rows, key=lambda r: r["bound_ms"])["bound_by"],
            "library_ms": None if None in lib else sum(lib),
            "layers": [r["layer"] for r in rows]})
    report["kernels"] = kernels
    report["card"] = smi
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(report, indent=1, default=str))
    log(json.dumps({"kernels": kernels}))
    log(smi_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
