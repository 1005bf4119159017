#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's DSE cell, inference and training, on one
NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root

Phases, in the order they run, each of which raises on failure (the
script then exits non-zero and never prints its result line):

1. TF32 off for matmuls and cuDNN; the card's name and power limit; build
   the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc.
2. Hold each forward kernel against its plain PyTorch version on the card,
   at spike densities 0 .. 100%, on ragged shapes and on net-5's own.
   Weights on the 2^-12 grid make every partial sum exact in fp32, so the
   results must be equal; normal weights are checked to a stated
   tolerance.
3. The same for the backward kernels (dW, dS), with cotangents on a
   coarse grid; dW twice, for the same bytes; a cotangent tile of +x and
   -x must not be skipped.
4. The inference path: net-5 (DVSGesture 128x128x2 - 32C3 - P2 - 32C3 -
   P2 - 512 - 256 - 11, T = 124) with seeded random weights on 64
   synthetic event streams: ``evaluate``, ``dump_traces``,
   ``trace_counts`` on each backend, with the kernels' launch counters set
   to 0 before each backend and read after it, so each kernel must launch
   exactly on the paths that use it (and the plain ``torch`` backend
   launches none); then the accelerator model and ``dse.search`` over
   11,664 LHR candidates, and a profile of 8 forward steps.
5. The training path, net-5 at full width: one training step (forward and
   BPTT) on each backend from the same grid weights and batch, with the
   counters set to 0 before each backend and read after it (dW and dS
   included); equal losses and gradients within a stated tolerance; a
   profile of the step's forward and backward by kernel; three Adam steps
   on the default backend with their losses, times and peak memory.
6. The whole cell: the registry's dvs-conv at T = 8 with its own recipe
   through the torch ``TraceCache`` in a temporary root, a miss (training,
   traces, fixed-point accuracy) with its launches counted, then a hit
   with equal params and counts.
7. Time each kernel, its plain version and one library call at the main
   path's shapes on the main path's own traffic (the backward kernels on
   the operands of phase 5's middle time step), next to the least time
   the card could take for the same work.

The line before the last is the card's name and power limit; the last line
is ``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.
"""
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
# Inference runs no backward kernel.
EXPECTED = {"spike_gemm_fused": {"spike_gemm": 0, "spike_gemm_lif": 3,
                                 "spike_conv": 2, "spike_gemm_dw": 0,
                                 "spike_gemm_ds": 0},
            "spike_gemm": {"spike_gemm": 3, "spike_gemm_lif": 0,
                           "spike_conv": 2, "spike_gemm_dw": 0,
                           "spike_gemm_ds": 0},
            "torch": {"spike_gemm": 0, "spike_gemm_lif": 0, "spike_conv": 0,
                      "spike_gemm_dw": 0, "spike_gemm_ds": 0}}
# The same for one training step (forward and BPTT), per time step: dW for
# each of the 5 spiking layers, dS for 4 of them, because conv1's input is
# the encoded events, which need no gradient (dS runs only where
# ctx.needs_input_grad asks for it).
TRAIN_EXPECTED = {
    backend: {**counts, "spike_gemm_dw": 5 if backend != "torch" else 0,
              "spike_gemm_ds": 4 if backend != "torch" else 0}
    for backend, counts in EXPECTED.items()}
# The backend on which each kernel's launches are reported.
LAUNCHED_ON = {"spike_gemm": "spike_gemm", "spike_gemm_lif": "spike_gemm_fused",
               "spike_conv": "spike_gemm_fused",
               "spike_gemm_dw": "spike_gemm_fused",
               "spike_gemm_ds": "spike_gemm_fused"}
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
         "spike_gemm_ds": "src/repro/kernels/spike_gemm_bwd.py:102"}
SOURCES = {"spike_gemm": "src/repro_torch/kernels/csrc/spike_gemm.cu",
           "spike_gemm_lif": "src/repro_torch/kernels/csrc/spike_gemm_fused.cu",
           "spike_conv": "src/repro_torch/kernels/csrc/spike_conv.cu",
           "spike_gemm_dw": "src/repro_torch/kernels/csrc/spike_gemm_bwd.cu",
           "spike_gemm_ds": "src/repro_torch/kernels/csrc/spike_gemm_bwd.cu"}


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


def conv_input_needed(torch, x, flags, kh: int, kw: int, stride: int,
                      padding: str) -> float:
    """Elements of the conv input ``x`` that feed a flagged tile of its
    patch matrix: col2im of the tile mask, counted where it is > 0."""
    from repro_torch.kernels.build import TILE
    from repro_torch.kernels.spike_conv import conv_patches
    bm, bk = TILE["block_m"], TILE["block_k"]
    xx = torch.zeros_like(x, requires_grad=True)
    with torch.enable_grad():
        patches = conv_patches(xx, kh, kw, stride, padding)
    rows, cols = patches.shape
    mask = (flags.to(x.dtype).repeat_interleave(bm, 0)
            .repeat_interleave(bk, 1)[:rows, :cols])
    (hits,) = torch.autograd.grad(patches, xx, mask)
    return float((hits > 0).sum())


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

    from repro_torch import optim
    from repro_torch.core import dse, snn, train_snn, workloads
    from repro_torch.core.accelerator import arch
    from repro_torch.data import synthetic
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import spike_conv as conv_kernel
    from repro_torch.kernels import spike_gemm as gemm_kernel
    from repro_torch.kernels import spike_gemm_bwd as bwd_kernel
    from repro_torch.kernels import spike_gemm_fused as fused_kernel

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
        for name in sorted(libs):
            for line in (libs[name].parent / f"{name}.log").read_text() \
                    .splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  {name}: {line.strip()}")

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
    with Phase("kernels vs plain versions"):
        n_cases = 0
        for m, k, n in [(70, 1000, 130), (5, 33, 7)] + net5_dense:
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
        conv_cases = [((3, 17, 15, 4), 33, st, pad) for st in (1, 2)
                      for pad in ("SAME", "VALID")]
        conv_cases += [((BATCH, 128, 128, 2), 32, 1, "SAME"),
                       ((BATCH, 64, 64, 32), 32, 1, "SAME")]
        for shape, feats, stride, padding in conv_cases:
            cin = shape[-1]
            w = on_grid(torch.randn(3, 3, cin, feats, generator=gen,
                                    device=dev) / math.sqrt(9 * cin) * 2)
            for d in DENSITIES:
                x = spikes(shape, d)
                hold("spike_conv",
                     [ops.spike_conv(x, w, stride=stride, padding=padding)],
                     [ref.spike_conv_ref(x, w, stride=stride,
                                         padding=padding)],
                     f"x{shape} F={feats} stride {stride} {padding} "
                     f"density {d}")
                n_cases += 1
        torch.cuda.synchronize()
        log(f"{n_cases} cases equal to the plain versions on 2^-"
            f"{GRID_BITS}-grid weights; max |diff| {errs}")
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
        for m, k, n in [(70, 1000, 130), (5, 33, 7), (4100, 18, 32)] + list(
                net5_bwd.values()):
            w = on_grid(torch.randn(k, n, generator=gen, device=dev)
                        / math.sqrt(k) * 2)
            for d in DENSITIES:
                s, g = spikes((m, k), d), cotangent((m, n), d)
                bound_dw = float((s.T @ g.abs()).max())
                bound_ds = float((g.abs() @ w.abs().T).max())
                if not (bound_dw < 2.0 ** 24
                        and bound_ds < 2.0 ** (24 - GRID_BITS)):
                    raise AssertionError("operands break the exact-sum bound")
                what = f"S{(m, k)} g{(m, n)} W{(k, n)} density {d}"
                dw = ops.spike_gemm_bwd_dw(s, g)
                hold("spike_gemm_dw", [dw, ops.spike_gemm_bwd_dw(s, g)],
                     [ref.spike_gemm_dw_ref(s, g)] * 2, what)
                hold("spike_gemm_ds", [ops.spike_gemm_bwd_ds(g, w)],
                     [ref.spike_gemm_ds_ref(g, w)], what)
                n_cases += 2
        torch.cuda.synchronize()
        log(f"{n_cases} cases equal to the plain versions on grid operands "
            f"(dW twice, the same bytes both times); max |diff| "
            f"{ {k: errs[k] for k in BACKWARD} }")
        g = torch.zeros(40, 64, device=dev)
        g[3, 5], g[7, 9] = 0.75, -0.75          # one tile, its sum is zero
        if ops.cotangent_block_flags(g).tolist() != [[1, 0], [0, 0]] or \
                not torch.equal(ops.spike_gemm_bwd_ds(
                    g, torch.ones(6, 64, device=dev))[[3, 7]],
                    torch.tensor([[0.75] * 6, [-0.75] * 6], device=dev)):
            raise AssertionError("dS skipped a tile whose entries cancel")
        log("  a cotangent tile of +0.75 and -0.75 is flagged and "
            "accumulated")
        for layer in ("conv1", "conv2", "fc1"):
            m, k, n = net5_bwd[layer]
            s = spikes((m, k), 0.1)
            g = torch.randn(m, n, generator=gen, device=dev)
            w = torch.randn(k, n, generator=gen, device=dev) / math.sqrt(k)
            dw = ops.spike_gemm_bwd_dw(s, g)
            if not torch.equal(dw, ops.spike_gemm_bwd_dw(s, g)):
                raise AssertionError(f"dW differs between two runs ({layer})")
            hold_close("spike_gemm_dw", dw, ref.spike_gemm_dw_ref(s, g),
                       (s.T @ g.abs()).max().item(), f"{layer} {(m, k, n)}")
            if layer != "conv1":
                hold_close("spike_gemm_ds", ops.spike_gemm_bwd_ds(g, w),
                           ref.spike_gemm_ds_ref(g, w),
                           (g.abs() @ w.abs().T).max().item(),
                           f"{layer} {(m, k, n)}")
        del s, g, w, dw
        report["normal_weights_rel_err"] = normal

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
                    skips = [ops.skip_fraction(conv_kernel.conv_patches(
                        train[t], spec.kernel, spec.kernel, spec.stride,
                        spec.padding)) for t in range(NUM_STEPS)]
                else:
                    skips = [ops.skip_fraction(train[t].reshape(BATCH, -1))
                             for t in range(NUM_STEPS)]
                layer_rates[name] = {"input_rate": rate,
                                     "skip_fraction": statistics.fmean(skips)}
                log(f"  {name} input: firing rate {rate:.4f}, skip fraction "
                    f"at {build.TILE['block_m']}x{build.TILE['block_k']} "
                    f"tiles {statistics.fmean(skips):.4f}")
                if rate == 0.0:
                    raise AssertionError(f"{name}'s input train is empty: "
                                         f"the kernels would skip it all")
                probe[name] = train[t_mid].contiguous().clone()
            del trains, x
        report["layers"] = layer_rates

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

        def wrapper(a, b, **kw):
            key = (kind, tuple(a.shape), tuple(b.shape))
            calls[key] = calls.get(key, 0) + 1
            if calls[key] == NUM_STEPS - NUM_STEPS // 2:
                bwd_probe[key] = (a.detach().clone(), b.detach().clone(),
                                  {k: v.clone() for k, v in kw.items()})
            return real(a, b, **kw)
        return wrapper

    with Phase("net-5 training step on every backend"):
        train_results, train_launches, train_report = {}, {}, {}
        for backend in EXPECTED:
            real = (ops.spike_gemm_bwd_dw, ops.spike_gemm_bwd_ds)
            if backend == "spike_gemm_fused":
                ops.spike_gemm_bwd_dw = capturing(real[0], "dw")
                ops.spike_gemm_bwd_ds = capturing(real[1], "ds")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            try:
                loss, grads, fwd_s, bwd_s = timed_step(params, backend)
            finally:
                ops.spike_gemm_bwd_dw, ops.spike_gemm_bwd_ds = real
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
        # per Adam step: the 2 convs and the 2 dense layers forward, dW on
        # all 4, dS on 3 (not on the events); then one inference each in
        # evaluate (128 test samples, one batch) and dump_traces
        runs = wl.train_steps + 2
        want = {"spike_gemm": 0,
                "spike_gemm_lif": 2 * CELL_STEPS * runs,
                "spike_conv": 2 * CELL_STEPS * runs,
                "spike_gemm_dw": 4 * CELL_STEPS * wl.train_steps,
                "spike_gemm_ds": 3 * CELL_STEPS * wl.train_steps}
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
            row = {"kernel": "spike_gemm", "layer": name,
                   "shape": [m, k, n], "input_rate": nnz / s.numel(),
                   "skip_fraction": ops.skip_fraction(s),
                   "ms": median_ms(torch, lambda: ops.spike_gemm(s, w)),
                   "kernel_ms": median_ms(torch, lambda: gemm_kernel
                                          .spike_gemm_cuda(s, w, flags)),
                   "plain_ms": median_ms(torch,
                                         lambda: ref.spike_gemm_ref(s, w)),
                   "library_ms": median_ms(torch, lambda: torch.matmul(s, w))}
            row["bound_ms"], row["bound_by"] = bound_ms(gemm_bytes,
                                                        2 * nnz * n)
            per_layer.append(row)
            lif = spec.lif
            fused_bytes = gemm_bytes + 4 * (n + 3 * m * n)
            row = {"kernel": "spike_gemm_lif", "layer": name,
                   "shape": [m, k, n], "input_rate": nnz / s.numel(),
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
                   "library_ms": None}
            row["bound_ms"], row["bound_by"] = bound_ms(
                fused_bytes, 2 * nnz * n + 5 * m * n)
            per_layer.append(row)
        for name in ("conv1", "conv2"):
            spec, p = layers[name]
            x, w = probe[name], p["w"]
            patches = conv_kernel.conv_patches(x, 3, 3, 1, "SAME")
            flags = ops.block_flags(patches)
            w2 = w.reshape(-1, w.shape[-1]).contiguous()
            x_nchw = x.permute(0, 3, 1, 2)          # channels-last strides
            w_oihw = w.permute(3, 2, 0, 1).contiguous()
            bsz, h, wd, c = x.shape
            feats = w.shape[-1]
            nnz = float(patches.sum())
            row = {"kernel": "spike_conv", "layer": name,
                   "shape": [bsz, h, wd, c, feats],
                   "input_rate": float(x.mean()),
                   "skip_fraction": ops.skip_fraction(patches),
                   "ms": median_ms(torch, lambda: ops.spike_conv(x, w)),
                   "kernel_ms": median_ms(torch, lambda: conv_kernel
                                          .spike_conv_cuda(patches, w2,
                                                           flags)),
                   "plain_ms": median_ms(torch,
                                         lambda: ref.spike_conv_ref(x, w)),
                   "library_ms": median_ms(torch, lambda: F.conv2d(
                       x_nchw, w_oihw, padding=1))}
            _, _, w_rows = gated_counts(torch, flags, *patches.shape)
            x_read = conv_input_needed(torch, x, flags, 3, 3, 1, "SAME")
            row["bound_ms"], row["bound_by"] = bound_ms(
                4 * (x_read + w_rows * feats + bsz * h * wd * feats
                     + flags.numel()),
                2 * nnz * feats)
            per_layer.append(row)
        layer_of = {(m, k): name for name, (m, k, _) in net5_bwd.items()}
        for (kind, _, _), (a, b, kw) in sorted(bwd_probe.items()):
            if kind == "dw":
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
                                              .spike_gemm_dw_cuda(s, g,
                                                                  flags)),
                       "plain_ms": median_ms(
                           torch, lambda: ref.spike_gemm_dw_ref(s, g)),
                       "library_ms": median_ms(torch,
                                               lambda: torch.matmul(s.T, g))}
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
                                              .spike_gemm_ds_cuda(g, w,
                                                                  gflags)),
                       "plain_ms": median_ms(
                           torch, lambda: ref.spike_gemm_ds_ref(g, w)),
                       "library_ms": median_ms(torch,
                                               lambda: torch.matmul(g, w.T))}
                g_read, _, w_cols = gated_counts(torch, gflags, m, n)
                row["bound_ms"], row["bound_by"] = bound_ms(
                    4 * (g_read + k * w_cols + m * k + gflags.numel()),
                    2 * nnz * k)
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
        # kernels: of one net-5 training step
        counted = train_launches if name in BACKWARD else launches
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": LINES[name],
            "launches": counted[LAUNCHED_ON[name]][name],
            "launched_on": LAUNCHED_ON[name],
            "launches_by_backend": {b: c[name] for b, c in counted.items()},
            "training_launches_by_backend": {
                b: c[name] for b, c in train_launches.items()},
            "max_abs_err": errs[name],
            "normal_weights_rel_err": normal[name],
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
