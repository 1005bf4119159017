#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's DSE inference leg on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root

Phases, each of which raises on failure (the script then exits non-zero
and never prints its result line):

1. TF32 off for matmuls and cuDNN; the card's name and power limit; build
   the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc.
2. Hold each kernel against its plain PyTorch version on the card, at
   spike densities 0 .. 100%, on ragged shapes and on net-5's own.  Weights
   on the 2^-12 grid make every partial sum exact in fp32, so the results
   must be equal; normal weights are checked to a stated tolerance.
3. The main path: net-5 (DVSGesture 128x128x2 - 32C3 - P2 - 32C3 - P2 -
   512 - 256 - 11, T = 124) with seeded random weights on 64 synthetic
   event streams: ``evaluate``, ``dump_traces``, ``trace_counts`` on each
   backend, with the kernels' launch counters set to 0 before each backend
   and read after it, so each kernel must launch exactly on the paths that
   use it (and the plain ``torch`` backend launches none); then the
   accelerator model and ``dse.search`` over 11,664 LHR candidates.
4. Time each kernel, its plain version and one library call at the main
   path's shapes on the main path's own traffic, next to the least time
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
EXPECTED = {"spike_gemm_fused": {"spike_gemm": 0, "spike_gemm_lif": 3,
                                 "spike_conv": 2},
            "spike_gemm": {"spike_gemm": 3, "spike_gemm_lif": 0,
                           "spike_conv": 2},
            "torch": {"spike_gemm": 0, "spike_gemm_lif": 0, "spike_conv": 0}}
# The backend on which each kernel's launches are reported.
LAUNCHED_ON = {"spike_gemm": "spike_gemm", "spike_gemm_lif": "spike_gemm_fused",
               "spike_conv": "spike_gemm_fused"}
# Published peaks of one H100 SXM at its 700 W limit (dense, no sparsity).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
LINES = {"spike_gemm": "src/repro/kernels/spike_gemm.py:49",
         "spike_gemm_lif": "src/repro/kernels/spike_gemm_fused.py:59",
         "spike_conv": "src/repro/kernels/spike_conv.py:91"}
SOURCES = {"spike_gemm": "src/repro_torch/kernels/csrc/spike_gemm.cu",
           "spike_gemm_lif": "src/repro_torch/kernels/csrc/spike_gemm_fused.cu",
           "spike_conv": "src/repro_torch/kernels/csrc/spike_conv.cu"}


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

    from repro_torch.core import dse, snn, train_snn
    from repro_torch.core.accelerator import arch
    from repro_torch.data import synthetic
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import spike_conv as conv_kernel
    from repro_torch.kernels import spike_gemm as gemm_kernel
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

    # ---- 3. the main path ------------------------------------------------
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

    # ---- 4. timing at the main path's shapes and traffic -----------------
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
            gemm_bytes = 4 * (m * k + k * n + m * n) + 4 * flags.numel()
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
            row["bound_ms"], row["bound_by"] = bound_ms(
                4 * (x.numel() + w.numel() + bsz * h * wd * feats),
                2 * nnz * feats)
            per_layer.append(row)
        for row in per_layer:
            log("  " + json.dumps(row))
        report["per_layer"] = per_layer

    kernels = []
    for name in LINES:
        rows = [r for r in per_layer if r["kernel"] == name]
        lib = [r["library_ms"] for r in rows]
        bound = sum(r["bound_ms"] for r in rows)
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": LINES[name],
            "launches": launches[LAUNCHED_ON[name]][name],
            "launched_on": LAUNCHED_ON[name],
            "launches_by_backend": {b: c[name] for b, c in launches.items()},
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
