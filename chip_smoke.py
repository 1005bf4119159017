#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's DSE cell, inference and training, and its
LM serving and training paths, on one NVIDIA GPU.

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
   kernels must give the same bytes on two calls.  Then the cell axis: each
   forward kernel on slabs of 3 cells with their own weights and spike
   densities (a B that is not a multiple of 32 among them), one launch a
   slab, each cell equal to its solo launch and to the plain version.
3. The same for the backward kernels (the dense layers' dW and dS, the
   conv layers' dW on their input spikes and their dS in conv form, at
   every conv geometry of phase 2), with cotangents on a coarse grid, each
   twice for the same bytes, and on spikes of other values; a cotangent
   tile (dense dS) and a cotangent pixel (conv dS) of +x and -x must not be
   skipped; on normal operands the conv dS must equal col2im of the card's
   dense dS bit for bit; one ``spike_conv_train`` forward and backward on
   the card equal to the CPU's; the cell axis of every backward kernel as
   in phase 2.  Then the kernel API's own kernels:
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
   dS must not go through patch space); on the kernel backends the step's
   graph holds one conv-epilogue node a conv layer a time step and no
   OR-pool node of its own; equal losses and gradients within a stated
   tolerance; a
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
   Then many cells at once (6c): 16 dvs-conv cells (seeds 0-15, the
   registry's recipe at T = 8) trained as one slab
   (``cellstack.resolve_stacked``), with the launch counters set to 0
   before and read after: the slab must launch each kernel as often as one
   solo cell does; solo misses of seeds 0 and 1, equal to the slab's cells
   bit for bit; ``resolve_cells(workers=2)`` of seeds 16 and 17 in two
   spawned processes on the card, equal to their solo misses; ``coexplore``
   of dvs-conv and its ``data_seed=17`` shard with ``stack=True`` against
   the serial run, with equal frontiers; the slab's and a solo miss's wall
   time and cells a minute, the slab's peak memory, and a profile of one
   replayed slab step against one replayed solo step (each after its
   warm-up and capture; device busy share, kernels a step), each replay's
   kernels by name equal to its eager warm-up's, as the profiler lists
   them, and its launch counts equal too.
   Then the DSE service over the fleet (6d), in another temporary root:
   a ``DSEService(workers="cluster")`` stepping on its background thread
   (``start``/``stop``) and two spawned ``fleet.run_worker`` processes on
   the card; tenant alpha submits dvs-conv at T = 8, 12 and tenant beta
   at T = 8, 16 (3 cells in 4 resolutions): both studies must complete,
   the workers train each cell exactly once and the service's cache only
   loads, each tenant's frontier equals an all-hit ``dse.explore`` of its
   grid afterwards, and the T = 8 cell equals phase 6's miss bit for bit.
   A worker SIGKILL'd once it holds the lease of seed 1 at T = 8: the
   submitter's ``resolve_cells(workers="cluster")`` breaks the stale lease
   and trains the cell in process with one solo miss's launches of
   kernels 2-5 (counters set to 0 before, read after), equal to phase
   6c's solo miss of seed 1.  Then 75 dvs-conv Adam steps under
   ``TrainSupervisor`` (async saves every 25 steps, a failure injected at
   step 40), equal bit for bit to 75 unsupervised steps, one restart.
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
   ``torch.nn.grad.conv2d_input``.  Then the conv epilogue's two kernels
   alone (``epilogue_phase``), L2 flushed, at net-5's two conv layers,
   against their byte bounds and the unfused chain of PyTorch ops.
8. The LM serving path (it runs between phases 6d and 7), with the seven
   kernels' counters set to 0 before it and read after: all must read 0.
   Every family, each config at full width in bf16 with weights from the
   port's ``init_params`` on a card generator seeded 0, one after another
   (each freed before the next): tinyllama-1.1b (22 layers, d_model 2048,
   16 new tokens), llama3.2-3b, granite-3-2b (tied embeddings),
   chatglm3-6b (2-D rope), mamba2-780m (48 Mamba2 blocks), zamba2-2.7b (54
   blocks and 9 applications of the shared attention block) and the
   mixtures of experts mixtral-8x7b and arctic-480b cut to 8 of 32 and 1
   of 35 layers (their full depth does not fit one card), 8 new tokens
   each, answer the 4 requests ``launch/serve.py`` draws (prompts of 4-11
   tokens) through ``ServeLoop(batch_size=4, max_len=128)``;
   seamless-m4t-large-v2 (24 + 24 layers), which the ServeLoop cannot serve
   (it passes tokens only, as the JAX package's does), answers them over 64
   precomputed frames each (drawn on the card from seed 0) through the
   engine's prefill and decode steps, greedy.  Each runs twice with equal
   tokens: every request gets its tokens, each in [0, vocab_padded), every
   logit finite; the prefill's ms, the median decode step, tokens a
   second, init's and serving's peak memory, the decode step's least time
   (``lm_decode_bound``) and the device's busy share of one step.  The
   prefill of 31 tokens and one decode step of tinyllama, mamba2, zamba2
   and seamless are held against ``forward`` on 4 prompts of 32 tokens at
   positions 30 and 31, within ``LM_BF16_TOL`` of their family (the
   mixtures of experts are exempt: serving routes its groups with other
   capacities), and tinyllama's bf16 forward against a forward of the same
   weights widened to fp32 on the card, within ``LM_BF16_FP32_TOL``; phase
   1 turns TF32 and cuBLAS's reduced-precision bf16 sums off.  Reduced
   fp32 configs of every family (a 4:1 GQA transformer, and
   tests/test_archs.py's mamba2-r, zamba2-r, seamless-r, mixtral-r and
   arctic-r) run on the card and on the CPU from the same converted
   weights: the MoE routing of layer 0 equal, logits within
   ``LM_FP32_TOL``, equal tokens.  Then the SNN codes that the port adds
   to the rate code (constant-current, time-to-first-spike, burst) and
   ``lif_init_state`` on the card against the CPU, bit for bit.
9. The LM training path (it runs after phase 8, before the timing), with
   the seven kernels' counters set to 0 before it and read after: all must
   read 0.  tinyllama-1.1b (22 layers, d_model 2048, bf16) takes 6 and
   mamba2-780m (48 blocks, d_model 1536, chunk 256, bf16 with float32
   ``A_log``, ``dt_bias`` and ``D``) 4 AdamW steps at full width through
   ``launch.train.run_training`` (``main --full``'s defaults: batch 8 x
   256, lr 3e-4, seed 0, remat on, no checkpoint directory), each freed
   before the next: every loss and grad norm finite, every leaf moved by
   the first step but the bf16 norm scales near 1 (half their ulp exceeds
   the update, in the JAX package as here), every leaf's dtype kept; the
   median step of steps 2-5, tokens a second, peak memory, the step's
   least time (``lm_train_bound``) and one profiled step (busy share,
   kernels, the kernels that took the most time).  The reduced fp32
   configs (the 4:1 GQA transformer, also under Adafactor; mixtral-r in
   two microbatches; mamba2-r, zamba2-r; seamless-r over 64 frames drawn
   on the card from seed 0) take two ``build_train_step`` steps on the
   card and on the CPU from the same converted weights and batch, the
   second of each from the CPU's first-step state, within
   ``LM_TRAIN_FP32_TOL``; the dense one also with remat off against on,
   on the card.  Then the 100M example's training
   (``examples/torch_train_lm_100m.py``: llama3.2-3b's wiring scaled to
   14 layers, d_model 640, vocab 16384, fp32; 300 steps of 2 x 256, lr
   1e-3, data vocab 512, no checkpoints): its last ten losses' mean must
   be below its first ten's by more than 0.5.

10. The mesh path (after phase 9, before the timing), with the seven
   kernels' counters set to 0 before it and read after: all must read 0.
   A world-size-1 NCCL group (``dist.HashStore``) and a 1x1 ("data",
   "model") ``DeviceMesh`` on the card; tinyllama-1.1b at full width in
   bf16 from seed 0 takes ``MESH_TRAIN_STEPS`` AdamW steps of 8 x 256
   through ``run_training(mesh=...)`` (remat on) and the same with
   mesh=None: losses and grad norms within ``LM_TRAIN_FP32_TOL["rtol"]``,
   every leaf after step 1 within ``LM_TRAIN_FP32_TOL``, every state leaf a
   DTensor on the card; then ``MESH_TIMED`` more steps of each from its
   final state for a warm median (the difference is DTensor's host
   dispatch).  Then 4 requests of 32 tokens are prefilled and decoded 8
   steps through the engine's steps on state placed by
   ``serve.engine.place_for_serving`` (``mode="prefill"``, then
   ``"decode"``; the cache on ``cache_specs``) and with mesh=None: greedy
   tokens equal, every cache leaf a DTensor on the card.  Step times and
   peak memory of both; the group is destroyed before the timing.

11. The roofline and the dry run (after phase 10, before the timing).
   ``python -m repro_torch.launch.dryrun --mesh single --device cuda`` in
   one subprocess per cell of ``ROOFLINE_GROUPS`` (each its own fake
   16x16 process group, apart from phase 10's NCCL group), all at once:
   tinyllama-1.1b's train_4k, prefill_32k and decode_32k and mixtral-8x7b's
   decode_32k must end ``ok`` and tinyllama-1.1b's long_500k ``skipped``;
   each cell's per-rank FLOPs, bytes, collectives by kind, memory, the
   three roofline terms, bottleneck and useful ratio (0 < it <= 1) are
   printed.  Meanwhile one AdamW step of tinyllama-1.1b at full width in
   bf16 (mesh=None, LM_TRAIN_BATCH x LM_TRAIN_SEQ, remat) runs on the
   card, timed without the counter and once under
   ``roofline.counting.count`` (the seven kernels' counters 0 before, read
   after: all 0): its loss and new params and optimizer state equal the
   uncounted step's bit for bit, its FLOPs equal the same step counted on
   fake tensors in this process, and lm_train_bound's FLOPs less the down
   projections' recompute and the norm scales exactly (the bound's gap
   within ``ROOFLINE_BOUND_GAP``); the counted compute and memory terms at
   the data sheet's peaks are printed beside the measured step, with the
   card's name and power limit.  Records in ``chiprun_out/dryrun/``.

The line before the last is the card's name and power limit; the last line
is ``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.
"""
import collections
import dataclasses
import importlib
import json
import math
import os
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
# On both kernel backends each conv layer's epilogue (bias, LIF, spike and
# its OR-pool) is one conv_epilogue launch.
API_ONLY = {"lif_step": 0, "penc_compact": 0}
EXPECTED = {"spike_gemm_fused": {"spike_gemm": 0, "spike_gemm_lif": 3,
                                 "spike_conv": 2, "spike_gemm_dw": 0,
                                 "spike_gemm_ds": 0, **API_ONLY,
                                 "conv_epilogue": 2},
            "spike_gemm": {"spike_gemm": 3, "spike_gemm_lif": 0,
                           "spike_conv": 2, "spike_gemm_dw": 0,
                           "spike_gemm_ds": 0, **API_ONLY,
                           "conv_epilogue": 2},
            "torch": {"spike_gemm": 0, "spike_gemm_lif": 0, "spike_conv": 0,
                      "spike_gemm_dw": 0, "spike_gemm_ds": 0, **API_ONLY,
                      "conv_epilogue": 0}}
# The same for one training step (forward and BPTT), per time step: dW for
# each of the 5 spiking layers, dS for 4 of them, because conv1's input is
# the encoded events, which need no gradient (dS runs only where
# ctx.needs_input_grad asks for it), and the conv epilogue's backward for
# the 2 conv layers.
TRAIN_EXPECTED = {
    backend: {**counts, "spike_gemm_dw": 5 if backend != "torch" else 0,
              "spike_gemm_ds": 4 if backend != "torch" else 0,
              "conv_epilogue": 4 if backend != "torch" else 0}
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
                "penc_compact": 5, "conv_epilogue": 0}
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
# The cell axis of kernels 1-5 (a DSE slab): CELLS cells of one shape, each
# with its own weights and its own spike density, held cell by cell against
# the solo launch and the plain version.  The dense shapes: a B that is not
# a multiple of 32 (no flag tile may mix two cells), net-5's ragged split
# path, and the dvs-conv cell's fc and output layers.
CELLS = 3
CELL_DENSITIES = (0.0, 0.05, 0.3)
CELL_DENSE = [(45, 1000, 130), (70, 32 * 32 * 32 + 37, 130),
              (BATCH, 1024, 64), (BATCH, 64, 16)]
# The slab of phase 6c: the registry's dvs-conv cells at T = CELL_STEPS,
# seeds 0 .. SLAB_CELLS-1, one slab (cellstack.MAX_STACK).
SLAB_CELLS = 16
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
# Phase 6d: the two tenants' dvs-conv grids, the seconds a fleet worker
# waits on an empty spool before it exits (longer than one cell, so a
# worker outlives the gap while the other trains the cell that unblocks
# the next study round), and the supervised run's steps, save period and
# injected failure.
FLEET_TENANTS = {"alpha": (8, 12), "beta": (8, 16)}
FLEET_IDLE_S = 20.0
SUPERVISED = {"steps": 75, "every": 25, "fail_at": 40}
# Phase 8, the LM serving path: every config served at full width in bf16
# with random weights from SEED, and the new tokens each request asks for;
# the depth each is cut to, where its full depth does not fit one card
# (mixtral-8x7b's 32 layers hold about 93 GB, arctic-480b's 35 about 950
# GB); the ServeLoop's batch and cache length; the precomputed frames an
# encoder-decoder reads; the prompts and tokens of the prefill/decode
# against forward check; the reduced fp32 configs run on the card and on
# the CPU (tests/test_archs.py's shapes).
LM_ARCHS = {"tinyllama_1_1b": 16, "llama3_2_3b": 8, "granite_3_2b": 8,
            "chatglm3_6b": 8, "mamba2_780m": 8, "zamba2_2_7b": 8,
            "seamless_m4t_large_v2": 8, "mixtral_8x7b": 8, "arctic_480b": 8}
LM_LAYERS = {"mixtral_8x7b": 8, "arctic_480b": 1}
LM_BATCH, LM_MAX_LEN, LM_REQUESTS = 4, 128, 4
LM_FRAMES = 64
LM_CHECK = (4, 32)
LM_REDUCED = dict(name="tinyllama-r", family="transformer", num_layers=2,
                  d_model=128, n_heads=4, n_kv=1, d_ff=192, vocab=512,
                  head_dim=32, dtype="float32")
_SSM_R = dict(state_dim=16, head_dim=16, expand=2, conv_width=4, chunk=4)
LM_REDUCED_FAMILIES = {
    "mamba2-r": dict(name="mamba2-r", family="ssm", num_layers=2,
                     d_model=64, n_heads=8, n_kv=0, d_ff=0, vocab=512,
                     head_dim=16, rope="none", ssm=_SSM_R, dtype="float32"),
    "zamba2-r": dict(name="zamba2-r", family="hybrid", num_layers=4,
                     d_model=64, n_heads=4, n_kv=4, d_ff=128, vocab=512,
                     head_dim=16, ssm=_SSM_R, shared_attn_every=2,
                     dtype="float32"),
    "seamless-r": dict(name="seamless-r", family="encdec", num_layers=2,
                       encoder_layers=2, d_model=128, n_heads=4, n_kv=4,
                       d_ff=256, vocab=512, head_dim=32, frontend="audio",
                       dtype="float32"),
    "mixtral-r": dict(name="mixtral-r", family="moe", num_layers=2,
                      d_model=128, n_heads=4, n_kv=2, d_ff=256, vocab=512,
                      head_dim=32, window=16,
                      moe=dict(num_experts=4, top_k=2, capacity_factor=2.0),
                      dtype="float32"),
    "arctic-r": dict(name="arctic-r", family="moe", num_layers=2,
                     d_model=128, n_heads=4, n_kv=2, d_ff=128, vocab=512,
                     head_dim=32,
                     moe=dict(num_experts=8, top_k=2, capacity_factor=2.0,
                              dense_residual=True, dense_d_ff=128),
                     dtype="float32"),
}
# Prefill (31 tokens) and one decode step against the full forward, in
# bf16 at full width: max |logit difference| / max |logit|, per family.
# bf16 rounds each product's output, and a 31-row and a 32-row product
# need not round alike; a Mamba2 block's prefill carries its state out of
# the chunked scan, its decode steps the recurrence.  Each tolerance is
# three times the value measured on an NVIDIA H100 80GB HBM3 at 700 W
# (PERF.md §6), rounded up: tinyllama-1.1b 0.0133 (the transformer
# family's), mamba2-780m 0.02946, zamba2-2.7b 0.03523, seamless-m4t-
# large-v2 0.01316.  The mixture of experts is exempt: serving and the
# forward route their groups with other capacities by design
# (tests/test_archs.py skips it).
LM_BF16_TOL = {"transformer": 0.04, "ssm": 0.09, "hybrid": 0.11,
               "encdec": 0.04}
# The same bf16 forward against a forward of its weights widened to fp32
# on the card (TF32 off, bf16 products summed in fp32): what bf16's
# rounding of every activation adds up to over 22 layers.  Measured 0.0162
# on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6); the tolerance is three
# times that, rounded up.
LM_BF16_FP32_TOL = 0.05
# The reduced fp32 configs, card against CPU (TF32 off): the same ops,
# summed in other orders.
LM_FP32_TOL = dict(rtol=1e-5, atol=5e-5)
# Phase 9, the LM training path: full-width configs trained through
# launch.train.run_training (AdamW, remat, batch x sequence, steps); the
# reduced fp32 configs trained on the card and on the CPU (the dense one
# also under Adafactor and with remat off, mixtral-r in two microbatches,
# seamless-r over LM_TRAIN_FRAMES frames); the 100M example's run.
LM_TRAIN = {"tinyllama_1_1b": 6, "mamba2_780m": 4}
LM_TRAIN_BATCH, LM_TRAIN_SEQ = 8, 256
LM_TRAIN_FRAMES = 64
LM_100M = dict(d_model=640, layers=14, vocab=16384, steps=300, batch=2,
               seq=256, lr=1e-3, data_vocab=512)
# The reduced fp32 configs' two train steps, card against CPU, the second
# of each from the CPU's first-step state: the loss and metrics to
# ``rtol``; each updated leaf within ``param`` of its largest |value|,
# except where AdamW divides by a gradient near zero (a clipped gradient of
# 1e-9 against an eps of 1e-8 makes the update follow the gradient's last
# digits): there a share ``near_zero`` of a leaf may move by up to two
# learning rates (tests/test_torch_lm_train.py, where the CPU against the
# JAX package measured 1.2e-4 of a leaf).  Remat on and off, both on the
# card, within the same.  Phase 8's logits agree card against CPU to
# about 7e-6 (PERF.md §6).
LM_TRAIN_FP32_TOL = dict(rtol=1e-5, param=1e-5, near_zero=1e-3)
# Phase 10, the mesh path: tinyllama-1.1b at full width in bf16 on a 1x1
# ("data", "model") DeviceMesh over a world-size-1 NCCL group, against the
# same runs with mesh=None, each timed in the same phase: MESH_TRAIN_STEPS
# AdamW steps of LM_TRAIN_BATCH x LM_TRAIN_SEQ through run_training (remat
# on), then MESH_TIMED more steps of each on its final state for a warm
# median; prefill of LM_REQUESTS prompts of MESH_PROMPT tokens and
# MESH_DECODE greedy decode steps through the engine's steps (LM_MAX_LEN
# slots).  Losses and grad norms to LM_TRAIN_FP32_TOL["rtol"], the params
# after step 1 within LM_TRAIN_FP32_TOL, greedy tokens equal.
MESH_ARCH = "tinyllama_1_1b"
MESH_TRAIN_STEPS, MESH_TIMED = 2, 3
MESH_PROMPT, MESH_DECODE = 32, 8
# Published peaks of one H100 SXM at its 700 W limit (dense, no sparsity):
# bf16 and the memory rate from the port's roofline analysis, which holds
# the card's peaks in one place; float32 outside the tensor cores here.
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.roofline.analysis import HBM_BW as PEAK_BYTES_PER_S  # noqa: E402
from repro_torch.roofline.analysis import PEAK_FLOPS as PEAK_BF16_FLOPS  # noqa: E402
PEAK_FP32_FLOPS = 67e12
# Phase 11, the roofline and the dry run: the cells that
# ``python -m repro_torch.launch.dryrun --mesh single`` runs on fake
# tensors over a fake 16x16 group (one subprocess a cell, each process its
# own group), and the status each must end with; then one
# AdamW step of tinyllama-1.1b (bf16, LM_TRAIN_BATCH x LM_TRAIN_SEQ) on the
# card under roofline.counting.count.  Its counted FLOPs against
# lm_train_bound's: the bound recomputes every product under remat and
# counts the norm scales as products, where torch.utils.checkpoint stops
# recomputing a layer after the last tensor its backward needs (the MLP's
# down projection is not recomputed, as XLA drops it in the JAX package's
# step) and a norm scale enters no product.  So the count is the bound
# less 2 FLOPs a token for each down-projection weight and 8 for each norm
# scale, exactly, and that gap, a share of the bound, stays within
# ROOFLINE_BOUND_GAP (6.10% at tinyllama-1.1b's widths, on the card).
ROOFLINE_CELLS = [("tinyllama_1_1b", "train_4k", "ok"),
                  ("tinyllama_1_1b", "prefill_32k", "ok"),
                  ("tinyllama_1_1b", "decode_32k", "ok"),
                  ("tinyllama_1_1b", "long_500k", "skipped"),
                  ("mixtral_8x7b", "decode_32k", "ok")]
ROOFLINE_GROUPS = [["--arch", "tinyllama_1_1b", "--shape", "train_4k"],
                   ["--arch", "tinyllama_1_1b", "--shape", "prefill_32k"],
                   ["--arch", "tinyllama_1_1b", "--shape", "decode_32k"],
                   ["--arch", "tinyllama_1_1b", "--shape", "long_500k"],
                   ["--arch", "mixtral_8x7b", "--shape", "decode_32k"]]
ROOFLINE_TIMEOUT_S = 600
ROOFLINE_BOUND_GAP = 0.065
ROOFLINE_TIMED = 3
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


def profiled_names(torch, step) -> collections.Counter:
    """The device kernels of one call of ``step`` under the profiler, by
    name, copies and fills of memory left out: a CUDA graph's replay lists
    its in-graph copies as kernels (``memcpy32_post``), and the copies into
    its static inputs and out of its outputs are the replay's own, so an
    eager step and a replay of it compare equal under this count.  The
    profiler can miss the first kernels launched after it starts (an eager
    step's first fills and its first conv), so spin kernels run first,
    their trace left out."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(32):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(0.05)
        step()
        torch.cuda.synchronize()
    return collections.Counter(
        e.name for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and "spin_kernel" not in e.name
        and not e.name.lower().startswith(("memcpy", "memset")))


def step_profile(torch, step, top: int = 0) -> dict:
    """One call of ``step`` (warmed up by the caller) between two
    synchronises, then one more under the profiler: the call's wall time,
    the device's busy time (its CUDA kernels' device time summed), the
    busy share of the wall and the kernels launched; with ``top``, also the
    ``top`` operators whose kernels took the most device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time_total for e in kern) / 1e3
    out = {"wall_ms": wall * 1e3, "device_busy_ms": busy,
           "busy_share": busy / (wall * 1e3) if kern else None,
           "kernels": len(kern)}
    if top:
        ops_ = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CPU
                and e.self_device_time_total > 0]
        out["top"] = [{"op": e.key, "ms": e.self_device_time_total / 1e3,
                       "calls": e.count}
                      for e in sorted(ops_, key=lambda e:
                                      -e.self_device_time_total)[:top]]
    return out


def device_ms(torch, fn, calls=20, tries=3, flush=None):
    """Device time a call of ``fn`` takes: the profiler's sum of the CUDA
    kernels ``calls`` calls launch, over ``calls``, after one warm-up.
    Unlike ``median_ms`` it leaves out the host time before each launch,
    which one timed call encloses whenever the host is slower than the
    device.  ``flush`` (``l2_flush``), if given, runs before each call, and
    the kernels of a trace of ``flush`` alone are not counted.  The
    profiler now and then records no kernel at all; then it tries again,
    and after ``tries`` empty traces returns None (not measured), never 0."""
    from torch.profiler import ProfilerActivity, profile

    def kernels(fns):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                for f in fns:
                    f()
            torch.cuda.synchronize()
        return [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        skip = {e.name for e in kernels([flush])} if flush else set()
        if flush and not skip:
            continue
        total = sum(e.device_time_total
                    for e in kernels([flush, fn] if flush else [fn])
                    if e.name not in skip)
        if total > 0:
            return total / calls / 1e3
    return None


def l2_flush(torch, device):
    """A call that reads 128 MB, over twice the H100's 50 MB L2, so that
    nothing an earlier call read or wrote stays there; a read leaves no
    dirty line for the next kernel to write back."""
    scrub = torch.zeros(32 * 2 ** 20, dtype=torch.float32, device=device)
    return scrub.sum


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
    on 3 (not on the events), the 2 conv epilogues each way; then one
    inference each in evaluate (128 test samples, one batch) and
    dump_traces."""
    runs = wl.train_steps + 2
    return {"spike_gemm": 0, "spike_gemm_lif": 2 * num_steps * runs,
            "spike_conv": 2 * num_steps * runs,
            "spike_gemm_dw": 4 * num_steps * wl.train_steps,
            "spike_gemm_ds": 3 * num_steps * wl.train_steps, **API_ONLY,
            "conv_epilogue": 2 * num_steps * (runs + wl.train_steps)}


def same_cell(a, b, what):
    """Two cache artifacts with equal params, counts and accuracy."""
    if not (a.accuracy == b.accuracy
            and len(a.counts) == len(b.counts)
            and all(np.array_equal(x, y)
                    for x, y in zip(a.counts, b.counts))
            and all(np.array_equal(p[k], q[k])
                    for p, q in zip(a.params, b.params) for k in p)):
        raise AssertionError(f"{what}: the artifacts differ")


def fleet_phase(torch, dev, miss, solo_seed1) -> dict:
    """Phase 6d: the DSE service over the fleet, a worker killed mid-cell,
    the training supervisor (see the module docstring).  ``miss`` is
    phase 6's dvs-conv miss (seed 0, T = CELL_STEPS) and ``solo_seed1``
    phase 6c's solo miss of seed 1; the workers train on ``dev``."""
    import multiprocessing
    import os
    import signal
    from unittest import mock

    from repro_torch import optim
    from repro_torch.checkpoint import store
    from repro_torch.core import dse, train_snn, workloads
    from repro_torch.data import synthetic
    from repro_torch.distributed import cellfarm, fleet
    from repro_torch.distributed.fault_tolerance import (SupervisorConfig,
                                                         TrainSupervisor)
    from repro_torch.kernels import ops
    from repro_torch.serve import DSEService, StudyCompleted, Submission

    out = {}
    dvs = workloads.get("dvs-conv")
    asn = {"num_steps": CELL_STEPS, "population": 1.0}
    grid = dict(population=(1.0,), max_lhr=4, weight_bits=(4, 8))
    ctx = multiprocessing.get_context("spawn")      # CUDA is not fork-safe
    with tempfile.TemporaryDirectory() as root:
        # 1. two tenants over the fleet
        cells = f"{root}/cells"
        stats_paths = [f"{root}/worker-{i}.json" for i in range(2)]
        cache = workloads.TraceCache(root=cells, device=dev)
        service = DSEService(cache, workers="cluster", max_active=2)
        t0 = time.perf_counter()
        service.start()
        procs = [ctx.Process(target=fleet.run_worker, kwargs=dict(
            root=cells, worker_id=f"fleet-{i}", device=str(dev),
            idle_timeout=FLEET_IDLE_S, stats_path=path))
            for i, path in enumerate(stats_paths)]
        try:
            for p in procs:
                p.start()
            handles = {t: service.submit(Submission(
                tenant=t, name="dvs-conv", workload=dvs, num_steps=steps,
                **grid)) for t, steps in FLEET_TENANTS.items()}
            for t, h in handles.items():
                if not h.wait(timeout=600):
                    raise AssertionError(f"tenant {t}'s study did not end")
            service_s = time.perf_counter() - t0
            # a study still stepping may block in the fleet's wait; its
            # daemon thread then ends with the process
            service.stop()
        finally:
            for p in procs:
                p.join(timeout=120)
                if p.is_alive():
                    p.kill()
                    p.join()
        workers_s = time.perf_counter() - t0
        stats = []
        for path in stats_paths:
            with open(path) as f:
                stats.append(json.load(f))
        kinds = {t: [type(e).__name__ for e in h.events()]
                 for t, h in handles.items()}
        trained = sum(s_["cells_trained"] for s_ in stats)
        log(f"  the service over two fleet workers: both studies done in "
            f"{service_s:.2f} s, workers exited at {workers_s:.2f} s "
            f"(spawn and their {FLEET_IDLE_S:.0f} s idle wait included); "
            f"{trained} cells, {trained / service_s * 60:.2f} cells a "
            f"minute through the fleet")
        for s_ in stats:
            log(f"  worker {s_}")
        for t, k in kinds.items():
            log(f"  tenant {t}'s events: {k}")
        for t, h in handles.items():
            if h.status != "completed" or kinds[t][-1] != "StudyCompleted":
                raise AssertionError(f"tenant {t}: {h.status}, {h.error}")
        if (trained, sum(s_["cells_skipped"] for s_ in stats),
                sum(s_["cells_failed"] for s_ in stats)) != (3, 0, 0):
            raise AssertionError(f"expected 3 cells trained once each by "
                                 f"the fleet, none skipped or failed: "
                                 f"{stats}")
        if cache.misses != 0:
            raise AssertionError(f"the service's cache trained "
                                 f"{cache.misses} cells itself")
        for t, steps in FLEET_TENANTS.items():
            again = workloads.TraceCache(root=cells, device=dev)
            ref = dse.explore(workload=dvs, num_steps=steps, cache=again,
                              **grid)
            a, b = handles[t].frontier.columns, ref.frontier.columns
            if (again.misses, again.hits) != (0, len(steps)) or \
                    a.keys() != b.keys() or not all(
                        np.array_equal(a[k], b[k]) for k in a):
                raise AssertionError(f"tenant {t}'s frontier differs from "
                                     f"an all-hit explore of its grid")
        first = workloads.TraceCache(root=cells, device=dev).resolve(
            dvs, asn, seed=SEED, quant_bits=(8,))
        same_cell(first, miss, "the fleet's T = 8 cell against phase 6's")
        if first.quant_acc.get(8) != miss.quant_acc.get(8):
            raise AssertionError("the fleet's T = 8 cell's 8-bit accuracy "
                                 "differs from phase 6's")
        log(f"  frontiers equal all-hit explores of each grid; the T = 8 "
            f"cell equals phase 6's miss bit for bit")
        out["service"] = {
            "service_s": service_s, "workers_exit_s": workers_s,
            "cells_trained": trained,
            "cells_per_minute": trained / service_s * 60,
            "workers": stats, "events": kinds,
            "cache": dict(cache.stats),
            "frontier_sizes": {t: len(h.frontier)
                               for t, h in handles.items()}}

        # 2. a worker killed mid-cell; the submitter reclaims the cell
        killed = f"{root}/killed"
        job = cellfarm.CellJob(dvs, asn, seed=1, quant_bits=(8,))
        [key] = fleet.spool(killed, [job])
        victim = ctx.Process(target=fleet.run_worker, kwargs=dict(
            root=killed, worker_id="victim", device=str(dev),
            idle_timeout=600))
        t0 = time.perf_counter()
        victim.start()
        try:
            while not os.path.exists(fleet._lease_path(killed, key)):
                if not victim.is_alive() or time.perf_counter() - t0 > 300:
                    raise AssertionError("the victim never claimed the "
                                         "cell")
                time.sleep(0.01)
            claim_s = time.perf_counter() - t0
            os.kill(victim.pid, signal.SIGKILL)
        finally:
            victim.join(timeout=60)
            if victim.is_alive():
                victim.kill()
                victim.join()
        if workloads.TraceCache(root=killed, device=dev).contains_key(key):
            raise AssertionError("the victim published before the kill")
        with mock.patch.dict(os.environ, {"REPRO_FLEET_LEASE_TTL": "1",
                                          "REPRO_FLEET_TIMEOUT": "2"}):
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            [got] = cellfarm.resolve_cells([job], killed, workers="cluster",
                                           device=dev)
            torch.cuda.synchronize()
            reclaim_s = time.perf_counter() - t0
            launches = ops.launch_counts()
        want = dvs_cell_launches(dvs, CELL_STEPS)
        log(f"  a worker killed {claim_s:.2f} s after its spawn, once it "
            f"held the lease; the submitter reclaimed and trained the cell "
            f"in {reclaim_s:.2f} s (the 2 s no-progress window included); "
            f"launches {launches}")
        if not got.trained or got.error is not None:
            raise AssertionError(f"the reclaim failed: {got}")
        if launches != want:
            raise AssertionError(f"the reclaim launched {launches}, "
                                 f"expected one solo miss's {want}")
        same_cell(workloads.TraceCache(root=killed, device=dev).resolve(
            dvs, asn, seed=1, quant_bits=(8,)), solo_seed1,
            "the reclaimed cell against phase 6c's solo miss of seed 1")
        out["reclaim"] = {"claim_s": claim_s, "reclaim_s": reclaim_s,
                          "launches": launches}

        # 3. the supervisor: a batch and a generator per step number, so a
        # replay after the restore draws the bits the first pass drew
        cfg = dvs.build(CELL_STEPS, 1.0)
        tx = optim.adam(dvs.lr)
        train_step = train_snn.make_train_step(cfg, tx)
        data = dvs.make_data(CELL_STEPS)
        it = synthetic.batches(data.x_train, data.y_train, dvs.batch_size,
                               seed=SEED, epochs=10_000)
        batches = [tuple(torch.as_tensor(a, device=dev) for a in next(it))
                   for _ in range(SUPERVISED["steps"])]

        def step_fn(state, step):
            gen = torch.Generator(device=dev).manual_seed(SEED + step)
            params, opt_state, _ = train_step(state["params"], state["opt"],
                                              gen, *batches[step])
            return {"params": params, "opt": opt_state}

        def start():
            params, opt_state, _ = train_snn.init_cell(cfg, tx, SEED,
                                                       device=dev)
            return {"params": params, "opt": opt_state}

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = start()
        for step in range(SUPERVISED["steps"]):
            plain = step_fn(plain, step)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        failed = []

        def flaky(state, step):
            if step == SUPERVISED["fail_at"] and not failed:
                failed.append(step)
                raise RuntimeError("injected failure")
            return step_fn(state, step)

        sup = TrainSupervisor(SupervisorConfig(
            checkpoint_dir=f"{root}/supervised",
            checkpoint_every=SUPERVISED["every"], async_save=True), start())
        t0 = time.perf_counter()
        final = sup.run(flaky, SUPERVISED["steps"])
        torch.cuda.synchronize()
        sup_s = time.perf_counter() - t0
        log(f"  {SUPERVISED['steps']} dvs-conv Adam steps: "
            f"{plain_s:.2f} s unsupervised, {sup_s:.2f} s supervised "
            f"(async saves every {SUPERVISED['every']}, a failure at step "
            f"{SUPERVISED['fail_at']}, {sup.restarts} restart)")
        pairs = list(zip(store.leaves(plain), store.leaves(final)))
        if sup.restarts != 1 or failed != [SUPERVISED["fail_at"]] or \
                int(final["opt"][0].count) != SUPERVISED["steps"] or \
                len(pairs) != len(store.leaves(start())) or not all(
                    b.device.type == dev.type and torch.equal(a, b)
                    for a, b in pairs):
            raise AssertionError("the supervised run differs from the "
                                 "unsupervised one")
        log("  the supervised run equals the unsupervised one bit for bit")
        out["supervisor"] = {"steps": SUPERVISED["steps"],
                             "plain_s": plain_s, "supervised_s": sup_s,
                             "restarts": sup.restarts}
    return out


def tree_paths(tree, prefix=()):
    """(key path, leaf) of every leaf of a param tree."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    return [pl for k, v in tree.items()
            for pl in tree_paths(v, prefix + (k,))]


def lm_decode_bound(cfg, params) -> tuple[float, str]:
    """One decode step at LM_BATCH: every weight the step reads, read
    once (the embedding only in its LM_BATCH gathered rows unless it
    is also the unembedding; no encoder, and no cross-attention K/V
    projection, which prefill ran), every expert of a MoE layer (each
    runs its capacity's slots); every KV and cross K/V cache read
    once; each Mamba2 state and conv history read and written; and 2
    operations a multiply-add of every weight product (an expert's
    with its capacity's rows, a hybrid's shared block once an
    application) and of attention against its cache, at bf16 peaks.
    ``params`` may live on the meta device."""
    from repro_torch.models import encdec, registry

    B = LM_BATCH
    uses = {"layers": B, "mamba": B, "decoder": B, "final_norm": B,
            "lm_head": B}
    if cfg.family == "hybrid":
        uses["shared"] = B * (cfg.num_layers // cfg.shared_attn_every)
    cap = 0
    if cfg.moe is not None:
        cap = max(int(cfg.moe.top_k * B / cfg.moe.num_experts
                      * cfg.moe.capacity_factor), 1)
    nbytes = macs = 0
    for part, tree in params.items():
        if part not in uses:
            continue
        for path, t in tree_paths(tree):
            if part == "decoder" and path[:1] == ("cross_attn",) and \
                    path[1] in ("wk", "wv"):
                continue
            nbytes += t.numel() * t.element_size()
            rows = cap if path[:1] == ("moe",) and path[1].startswith(
                "w_") else uses[part]
            macs += t.numel() * rows
    emb = params["embed"]["embedding"]
    nbytes += (emb.numel() if cfg.tie_embeddings
               else B * emb.shape[1]) * emb.element_size()
    if cfg.tie_embeddings:
        macs += emb.numel() * B
    cache = (encdec.init_cache(cfg, B, LM_MAX_LEN, enc_len=LM_FRAMES,
                               device="meta")
             if cfg.family == "encdec" else
             registry.init_cache(cfg, B, LM_MAX_LEN, device="meta"))
    for name, t in cache.items():
        if isinstance(t, int) or name == "slot_pos":
            continue
        size = t.numel() * t.element_size()
        nbytes += 2 * size if name in ("h", "conv") else size
        if name in ("k", "v", "cross_k", "cross_v"):
            # scores against k, then the weighted sum of v
            apps, _, slots, _, hd = t.shape
            macs += apps * B * cfg.n_heads * slots * hd
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = 2 * macs / PEAK_BF16_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def encoders_on_card(torch, dev) -> dict:
    """The SNN codes of the paper's Sec. II-A that ``encoding`` adds to the
    rate code (constant-current, time-to-first-spike, burst) and
    ``lif.lif_init_state``, on the card against the CPU, bit for bit, on
    DVS-sized intensities with x = 0, x = 1 and burst's half-way points
    among them."""
    from repro_torch.core import encoding, lif

    x = torch.rand((LM_BATCH, 32, 32, 2),
                   generator=torch.Generator().manual_seed(SEED))
    x[0, 0, :6, 0] = torch.tensor([0.0, 1.0, 0.125, 0.375, 0.625, 0.875])
    codes = {
        "constant_current": lambda x: encoding.constant_current_encode(x, 8),
        "ttfs": lambda x: encoding.ttfs_encode(x, 8),
        "burst": lambda x: encoding.burst_encode(
            torch.Generator(device=x.device), x, 8)}
    out = {}
    for name, code in codes.items():
        card, host = code(x.to(dev)).cpu(), code(x)
        if not torch.equal(card, host):
            raise AssertionError(f"the {name} code differs between the "
                                 "card and the CPU")
        out[name] = {"spikes": float(host.sum())}
    u, s = lif.lif_init_state(x.shape, device=dev)
    if u.device.type != dev.type or u.any() or s.any():
        raise AssertionError("lif_init_state is not zeros on the card")
    log(f"  SNN codes on the card equal the CPU's bit for bit: "
        f"{sorted(codes)}, and lif_init_state")
    return out


def lm_phase(torch, dev) -> dict:
    """Phase 8: the LM serving path (see the module docstring).  The seven
    kernels' counters are set to 0 before it and read after; the path
    launches none of them."""
    from repro_torch import convert
    from repro_torch.checkpoint import store
    from repro_torch.configs.base import ArchConfig, MoEConfig, SSMConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import encdec, layers, moe, registry
    from repro_torch.serve import engine

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def finite(t):
        return bool(torch.isfinite(t.float()).all())

    def timed(fn, sink, logits_of):
        """``fn`` with each call's wall time (ending in a synchronise)
        appended to ``sink``, and its logits checked finite."""
        def call(*args):
            sync()
            t0 = time.perf_counter()
            out = fn(*args)
            sync()
            sink.append(time.perf_counter() - t0)
            if not finite(logits_of(out)):
                raise AssertionError("a non-finite logit")
            return out
        return call

    def frames_for(cfg, n, d):
        """``n`` sequences of LM_FRAMES precomputed frames in the model's
        dtype, from a generator on ``d`` seeded SEED."""
        dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
        return torch.randn((n, LM_FRAMES, cfg.d_model), dtype=dtype,
                           device=d, generator=torch.Generator(device=d)
                           .manual_seed(SEED))

    def check_tokens(cfg, got, new_tokens):
        if [len(g) for g in got] != [new_tokens] * LM_REQUESTS or not all(
                0 <= t < cfg.vocab_padded for g in got for t in g):
            raise AssertionError(f"{cfg.name}: the requests got {got}")

    def serve(cfg, params, new_tokens):
        """One ServeLoop run of LM_REQUESTS requests: their tokens, the
        prefill's and each decode step's seconds, and the run's wall."""
        loop = engine.ServeLoop(cfg, params, batch_size=LM_BATCH,
                                max_len=LM_MAX_LEN)
        pre, dec = [], []
        loop._prefill = timed(loop._prefill, pre, lambda o: o[0])
        loop._decode = timed(loop._decode, dec, lambda o: o["logits"])
        reqs = make_requests(cfg, LM_REQUESTS, new_tokens)
        sync()
        t0 = time.perf_counter()
        loop.run(reqs)
        sync()
        wall = time.perf_counter() - t0
        got = [r.generated for r in reqs]
        check_tokens(cfg, got, new_tokens)
        return got, pre, dec, wall

    def serve_steps(cfg, params, new_tokens, frames=None):
        """An encoder-decoder, which the ServeLoop cannot serve (it passes
        tokens only): the same requests, left-padded, over LM_FRAMES
        frames each (``frames``, or drawn on the params' device), through
        the engine's prefill and decode steps, greedy.  Returns what
        ``serve`` does."""
        d = engine.params_device(params)
        if frames is None:
            frames = frames_for(cfg, LM_BATCH, d)
        reqs = make_requests(cfg, LM_REQUESTS, new_tokens)
        plen = max(len(r.prompt) for r in reqs)
        toks = np.zeros((LM_BATCH, plen), np.int32)
        for i, r in enumerate(reqs):
            toks[i, plen - len(r.prompt):] = r.prompt
        pre, dec = [], []
        prefill = timed(engine.build_prefill_step(cfg, LM_MAX_LEN), pre,
                        lambda o: o[0])
        decode = timed(engine.build_decode_step(cfg), dec,
                       lambda o: o["logits"])
        sync()
        t0 = time.perf_counter()
        with torch.inference_mode():
            batch = {"tokens": torch.from_numpy(toks).to(d),
                     "frames": frames}
            logits, cache = prefill(params, batch)
            token = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
            cols = [token[:, 0].tolist()]
            for _ in range(new_tokens - 1):
                out = decode(params, {"token": token, "cache": cache})
                token, cache = out["next_token"][:, None], out["cache"]
                cols.append(token[:, 0].tolist())
        sync()
        wall = time.perf_counter() - t0
        got = [list(g) for g in zip(*cols)][:LM_REQUESTS]
        check_tokens(cfg, got, new_tokens)
        return got, pre, dec, wall

    def run(cfg, params, new_tokens, frames=None):
        if cfg.family == "encdec":
            return serve_steps(cfg, params, new_tokens, frames)
        return serve(cfg, params, new_tokens)

    def extras(cfg, n, d):
        return ({"frames": frames_for(cfg, n, d)}
                if cfg.family == "encdec" else {})

    def busy_share(cfg, params) -> dict:
        """One decode step after a prefill and a warm-up step: its wall
        time and, from the profiler, the device's busy time."""
        step = engine.build_decode_step(cfg)
        toks = torch.randint(1, cfg.vocab, (LM_BATCH, 8), device=dev,
                             generator=torch.Generator(device=dev)
                             .manual_seed(SEED))
        with torch.inference_mode():
            _, cache = engine.build_prefill_step(cfg, LM_MAX_LEN)(
                params, dict(extras(cfg, LM_BATCH, dev), tokens=toks))
            state = {"token": toks[:, -1:].to(torch.int32), "cache": cache}

            def one():
                state["cache"] = step(params, state)["cache"]

            one()                                           # warm-up
            return step_profile(torch, one)

    def widened(tree):
        return ({k: widened(v) for k, v in tree.items()}
                if isinstance(tree, dict) else tree.float())

    def check_prompts(cfg):
        n, S = LM_CHECK
        return torch.randint(1, cfg.vocab, (n, S), device=dev,
                             generator=torch.Generator(device=dev)
                             .manual_seed(SEED + 1))

    def against_forward(cfg, params) -> float:
        """Prefill of LM_CHECK prompts' first S-1 tokens, then one decode
        step, against the full forward at positions S-2 and S-1, as max
        |difference| / max |logit| of the forward."""
        toks = check_prompts(cfg)
        S = toks.shape[1]
        with torch.inference_mode():
            extra = extras(cfg, toks.shape[0], dev)
            ref, _ = registry.forward(params, cfg, dict(extra, tokens=toks))
            pre, cache = registry.prefill(
                params, cfg, dict(extra, tokens=toks[:, :S - 1]), max_len=S)
            dec, _ = registry.decode_step(params, cfg, toks[:, S - 1:],
                                          cache)
            scale = float(ref[:, S - 2:].float().abs().max())
            err = max(float((pre[:, 0] - ref[:, S - 2]).float().abs().max()),
                      float((dec[:, 0] - ref[:, S - 1]).float().abs().max()))
            if not (finite(ref) and finite(pre) and finite(dec)):
                raise AssertionError(f"{cfg.name}: a non-finite logit")
        return err / scale

    def against_fp32(cfg, params) -> float:
        """The bf16 forward against one of the same weights widened to
        fp32 (TF32 off) at every position, as max |difference| / max
        |logit| of the fp32 forward."""
        toks = check_prompts(cfg)
        with torch.inference_mode():
            ref, _ = registry.forward(params, cfg, {"tokens": toks})
            wide, _ = registry.forward(
                widened(params), dataclasses.replace(cfg, dtype="float32"),
                {"tokens": toks})
            return float((ref.float() - wide).abs().max()) / float(
                wide.abs().max())

    out = {"configs": {}}
    ops.reset_launch_counts()
    for arch_id, new_tokens in LM_ARCHS.items():
        cfg = registry.load_arch(arch_id)
        if arch_id in LM_LAYERS:
            cfg = dataclasses.replace(cfg, num_layers=LM_LAYERS[arch_id])
        base = 0
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        sync()
        t0 = time.perf_counter()
        params = registry.init_params(
            torch.Generator(device=dev).manual_seed(SEED), cfg, device=dev)
        sync()
        init_s = time.perf_counter() - t0
        row = {"family": cfg.family, "layers": cfg.num_layers,
               "held_before_gib": base / 2 ** 30,
               "full_layers": registry.load_arch(arch_id).num_layers,
               "d_model": cfg.d_model, "heads": cfg.n_heads,
               "kv_heads": cfg.n_kv,
               "params": sum(t.numel() for t in store.leaves(params)),
               "weights_gib": sum(t.numel() * t.element_size()
                                  for t in store.leaves(params)) / 2 ** 30,
               "init_s": init_s}
        if dev.type == "cuda":
            # init draws each layer and copies it into the stacked leaves
            # (a single layer is not copied)
            row["init_peak_gib"] = (torch.cuda.max_memory_allocated()
                                    - base) / 2 ** 30
            torch.cuda.reset_peak_memory_stats()
        first, *_ = run(cfg, params, new_tokens)            # warm-up
        got, pre, dec, wall = run(cfg, params, new_tokens)
        if got != first:
            raise AssertionError(f"{cfg.name}: two runs gave other tokens")
        row.update({"prefill_ms": pre[0] * 1e3,
                    "decode_ms_median": statistics.median(dec) * 1e3,
                    "decode_steps": len(dec), "run_s": wall,
                    "tokens_per_s": LM_REQUESTS * new_tokens / wall,
                    "tokens": got})
        if dev.type == "cuda":
            # serving's peak: the weights and what the two runs allocate
            row["peak_gib"] = (torch.cuda.max_memory_allocated()
                               - base) / 2 ** 30
        row["decode_bound_ms"], row["decode_bound_by"] = lm_decode_bound(
            cfg, params)
        family = "transformer" if cfg.family == "moe" else cfg.family
        if cfg.moe is None and (family != "transformer"
                                or arch_id == "tinyllama_1_1b"):
            row["rel_err_vs_forward"] = against_forward(cfg, params)
            if row["rel_err_vs_forward"] > LM_BF16_TOL[family]:
                raise AssertionError(
                    f"{cfg.name}: prefill/decode against forward "
                    f"{row['rel_err_vs_forward']:.4g} > "
                    f"{LM_BF16_TOL[family]}")
        if arch_id == "tinyllama_1_1b":
            row["rel_err_vs_fp32"] = against_fp32(cfg, params)
            if row["rel_err_vs_fp32"] > LM_BF16_FP32_TOL:
                raise AssertionError(
                    f"{cfg.name}: the bf16 forward against the fp32 one "
                    f"{row['rel_err_vs_fp32']:.4g} > {LM_BF16_FP32_TOL}")
        if dev.type == "cuda":
            row["decode_step"] = busy_share(cfg, params)
        del params
        out["configs"][arch_id] = row
        cut = (f"{cfg.num_layers} of {row['full_layers']} layers"
               if arch_id in LM_LAYERS else f"{cfg.num_layers} layers")
        log(f"  {cfg.name} ({cut}, d_model {cfg.d_model}, "
            f"{row['params'] / 1e9:.3f} B params, bf16): prefill "
            f"{row['prefill_ms']:.2f} ms, decode {row['decode_ms_median']:.2f}"
            f" ms a step (median of {len(dec)}; bound "
            f"{row['decode_bound_ms']:.3f} ms, {row['decode_bound_by']}), "
            f"{row['tokens_per_s']:.1f} tokens/s, peak "
            f"{row.get('peak_gib', float('nan')):.2f} GiB (init "
            f"{row.get('init_peak_gib', float('nan')):.2f}; "
            f"{row['held_before_gib']:.2f} held before)")
        if "rel_err_vs_forward" in row:
            log(f"    prefill + decode against forward: "
                f"{row['rel_err_vs_forward']:.4g} of max |logit| "
                f"(tolerance {LM_BF16_TOL[family]})")
        if "rel_err_vs_fp32" in row:
            log(f"    bf16 forward against fp32 {row['rel_err_vs_fp32']:.4g}"
                f" (tolerance {LM_BF16_FP32_TOL})")
        if "decode_step" in row:
            st = row["decode_step"]
            log(f"    one decode step {st['wall_ms']:.2f} ms, device busy "
                f"{st['device_busy_ms']:.3f} ms, {st['kernels']} kernels")

    # the reduced fp32 configs: the same converted weights on the card and
    # on the CPU
    out["reduced_fp32"] = {}
    for kw in [LM_REDUCED] + list(LM_REDUCED_FAMILIES.values()):
        kw = dict(kw)
        if "moe" in kw:
            kw["moe"] = MoEConfig(**kw["moe"])
        if "ssm" in kw:
            kw["ssm"] = SSMConfig(**kw["ssm"])
        cfg = ArchConfig(**kw)
        tree = convert.lm_params_to_numpy(registry.init_params(
            torch.Generator().manual_seed(SEED), cfg, device="cpu"))
        on = {d: convert.lm_params_from_numpy(tree, cfg, device=d)
              for d in (dev, torch.device("cpu"))}
        rng = np.random.default_rng(SEED)
        toks = rng.integers(1, cfg.vocab, (LM_BATCH, 24))
        row = {}
        if cfg.moe is not None:
            # the routing first: layer 0's experts for the same tokens
            xs = rng.standard_normal((LM_BATCH * 24, cfg.d_model)).astype(
                np.float32)
            routes = {}
            for d, params in on.items():
                lp = layers.layer_params(params["layers"]["moe"], 0)
                probs = moe._router_probs(lp, torch.from_numpy(xs).to(d))
                routes[d.type] = moe._topk_routing(
                    probs, cfg.moe.top_k, LM_BATCH * 24)[0].cpu()
            if not torch.equal(routes[dev.type], routes["cpu"]):
                raise AssertionError(f"{cfg.name}: the routing differs "
                                     "between the card and the CPU")
            row["routing_equal"] = True
        logits, tokens = {}, {}
        # frames drawn on the CPU, so that both devices read the same
        host_extra = extras(cfg, LM_BATCH, torch.device("cpu"))
        for d, params in on.items():
            extra = {k: v.to(d) for k, v in host_extra.items()}
            with torch.inference_mode():
                logits[d.type], _ = registry.forward(params, cfg, dict(
                    extra, tokens=torch.from_numpy(toks).to(d)))
            tokens[d.type] = run(cfg, params, 16, extra.get("frames"))[0]
        card, host = logits[dev.type].cpu().numpy(), logits["cpu"].numpy()
        np.testing.assert_allclose(card, host, **LM_FP32_TOL,
                                   err_msg=cfg.name)
        if tokens[dev.type] != tokens["cpu"]:
            raise AssertionError(f"{cfg.name}: the tokens differ between "
                                 "the card and the CPU")
        row.update({"max_abs_logit_diff": float(np.abs(card - host).max()),
                    "tokens_equal": True})
        out["reduced_fp32"][cfg.name] = row
        log(f"  {cfg.name} fp32: card against CPU, max |logit difference| "
            f"{row['max_abs_logit_diff']:.3g}, tokens equal"
            + (", routing equal" if cfg.moe is not None else ""))

    out["encoders"] = encoders_on_card(torch, dev)
    out["launches"] = ops.launch_counts()
    if any(out["launches"].values()):
        raise AssertionError(f"the LM serving path launched SNN kernels: "
                             f"{out['launches']}")
    log(f"  the seven kernels' launches on the LM path: {out['launches']}")
    return out


def lm_train_bound(cfg, params, tokens: int, batch: int) -> dict:
    """The least time one AdamW step with remat could take on the card:
    its products, then its optimizer, which cannot start before the last
    gradient (clipping needs the norm of all of them), so the two add.
    Products: 8 operations a non-embedding parameter a token (forward 2,
    backward 4, remat's recompute 2), the unembedding's 6 (it is not
    recomputed), the attention scores' 16 a (query, key) pair a head
    dimension (forward 4: QK and PV), and a Mamba2 block's chunked SSD
    products 4 times over; at the bf16 or fp32 peak of ``cfg.dtype``.
    Optimizer: each parameter read and written, its gradient read, and two
    float32 moments read and written, over the memory rate.  ``params``
    may live on the meta device."""
    from repro_torch.models import ssm
    from repro_torch.tree import leaves

    peak = PEAK_BF16_FLOPS if cfg.dtype == "bfloat16" else PEAK_FP32_FLOPS
    n_all = sum(t.numel() for t in leaves(params))
    emb = params["embed"]["embedding"]
    head = emb if cfg.tie_embeddings else params["lm_head"]["w"]
    n_body = n_all - emb.numel() - (0 if cfg.tie_embeddings
                                    else head.numel())
    S = tokens // batch
    flops = 8 * n_body * tokens + 6 * head.numel() * tokens
    if cfg.family in ("transformer", "moe"):
        flops += 16 * cfg.num_layers * batch * S * S * cfg.n_heads \
            * cfg.resolved_head_dim
    if cfg.family == "ssm":
        d = ssm.dims(cfg)
        Q, H, N, P = min(d["Q"], S), d["n_heads"], d["N"], d["P"]
        flops += 4 * cfg.num_layers * 2 * tokens * (Q * N + Q * H * P
                                                    + 2 * H * N * P)
    opt_bytes = sum(t.numel() * (3 * t.element_size() + 16)
                    for t in leaves(params))
    t_ops, t_bytes = flops / peak, opt_bytes / PEAK_BYTES_PER_S
    return {"flops": flops, "optimizer_bytes": opt_bytes,
            "products_ms": t_ops * 1e3, "optimizer_ms": t_bytes * 1e3,
            "bound_ms": (t_ops + t_bytes) * 1e3}


def lm_train_phase(torch, dev) -> dict:
    """Phase 9: the LM training path (see the module docstring).  The
    seven kernels' counters are set to 0 before it and read after; the
    path launches none of them."""
    from repro_torch import convert
    from repro_torch.configs.base import ArchConfig, MoEConfig, SSMConfig
    from repro_torch.data import pipeline
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.models import registry
    from repro_torch.train import steps
    from repro_torch.tree import leaves, tree_map

    cpu = torch.device("cpu")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def fresh():
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            return torch.cuda.memory_allocated()
        return 0

    def peak_gib(base):
        return ((torch.cuda.max_memory_allocated() - base) / 2 ** 30
                if dev.type == "cuda" else None)

    class Recorder:
        """Wraps ``steps.build_train_step`` so that every step
        ``run_training`` takes is timed (ending in a synchronise), its loss
        and grad norm kept, and after its first step each parameter leaf
        compared with the one before."""

        def __init__(self):
            self.ms, self.loss, self.grad_norm = [], [], []
            self.unchanged = None
            self.orig = steps.build_train_step

        def __enter__(self):
            def build(cfg, settings, mesh=None):
                fn = self.orig(cfg, settings, mesh)

                def step(params, opt_state, batch):
                    sync()
                    t0 = time.perf_counter()
                    new = fn(params, opt_state, batch)
                    sync()
                    self.ms.append((time.perf_counter() - t0) * 1e3)
                    self.loss.append(float(new[2]["loss"]))
                    self.grad_norm.append(float(new[2]["grad_norm"]))
                    if self.unchanged is None:
                        self.unchanged = [
                            "/".join(path) for (path, a), (_, b) in
                            zip(tree_paths(params), tree_paths(new[0]))
                            if torch.equal(a, b)]
                    return new
                return step

            steps.build_train_step = build
            return self

        def __exit__(self, *exc):
            steps.build_train_step = self.orig

    out = {"full_width": {}}
    ops.reset_launch_counts()
    for arch_id, n_steps in LM_TRAIN.items():
        cfg = registry.load_arch(arch_id)
        base = fresh()
        tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
        with Recorder() as rec:
            t0 = time.perf_counter()
            res = launch_train.run_training(
                cfg, steps_n=n_steps, global_batch=LM_TRAIN_BATCH,
                seq_len=LM_TRAIN_SEQ, lr=3e-4, seed=SEED, log_every=1,
                device=dev)
            sync()
            wall = time.perf_counter() - t0
        params, opt = res["state"]["params"], res["state"]["opt"]
        if not all(math.isfinite(x) for x in rec.loss + rec.grad_norm) \
                or rec.loss != res["losses"]:
            raise AssertionError(f"{cfg.name}: losses {rec.loss}, grad "
                                 f"norms {rec.grad_norm}")
        # a bf16 leaf near 1 (a norm's scale) cannot take a step of about
        # lr: half its ulp is 0.002-0.004, so the update rounds away, in
        # the reference's apply_updates as here; every other leaf moves
        if any(not p.endswith("scale") or cfg.dtype != "bfloat16"
               for p in rec.unchanged):
            raise AssertionError(f"{cfg.name}: leaves unchanged by the "
                                 f"first step: {rec.unchanged}")
        like = registry.init_params(torch.Generator(), cfg, device="meta")
        if [t.dtype for t in leaves(params)] != [t.dtype
                                                 for t in leaves(like)]:
            raise AssertionError(f"{cfg.name}: a leaf changed its dtype")
        step_ms = statistics.median(rec.ms[1:5])
        row = {"steps": n_steps, "batch": LM_TRAIN_BATCH,
               "seq": LM_TRAIN_SEQ, "layers": cfg.num_layers,
               "d_model": cfg.d_model, "dtype": cfg.dtype,
               "params": sum(t.numel() for t in leaves(params)),
               "float32_leaves": sum(t.dtype == torch.float32
                                     for t in leaves(params)),
               "state_gib": sum(t.numel() * t.element_size() for t in
                                leaves((params, opt))) / 2 ** 30,
               "losses": rec.loss, "grad_norms": rec.grad_norm,
               "unchanged_by_step1": rec.unchanged,
               "step_ms": rec.ms, "step_ms_median": step_ms,
               "tokens_per_s": tokens / step_ms * 1e3, "run_s": wall,
               "peak_gib": peak_gib(base),
               **lm_train_bound(cfg, like, tokens, LM_TRAIN_BATCH)}
        if dev.type == "cuda":
            batch = pipeline.to_device(pipeline.synthetic_lm_batch(
                pipeline.DataConfig(cfg.vocab, LM_TRAIN_SEQ, LM_TRAIN_BATCH,
                                    SEED), n_steps), dev)
            fn = steps.build_train_step(cfg, steps.TrainSettings(
                learning_rate=3e-4, remat=True, z_loss=1e-4))
            row["profiled_step"] = step_profile(
                torch, lambda: fn(params, opt, batch), top=12)
        del params, opt, res
        out["full_width"][arch_id] = row
        log(f"  {cfg.name} ({cfg.num_layers} layers, d_model {cfg.d_model}, "
            f"{row['params'] / 1e9:.3f} B params, {cfg.dtype}, AdamW, remat,"
            f" {LM_TRAIN_BATCH} x {LM_TRAIN_SEQ}): {n_steps} steps, losses "
            f"{[round(x, 4) for x in rec.loss]}, grad norms "
            f"{[round(x, 3) for x in rec.grad_norm]}; step "
            f"{step_ms:.2f} ms (median of steps 2-5; bound "
            f"{row['bound_ms']:.2f} ms = products {row['products_ms']:.2f} + "
            f"optimizer {row['optimizer_ms']:.2f}), "
            f"{row['tokens_per_s']:.0f} tokens/s, peak "
            f"{row['peak_gib'] or float('nan'):.2f} GiB (state "
            f"{row['state_gib']:.2f} GiB); unchanged by step 1 (bf16 scales "
            f"near 1, whose half ulp exceeds the update): {rec.unchanged}")
        if "profiled_step" in row:
            st = row["profiled_step"]
            log(f"    one step {st['wall_ms']:.1f} ms, device busy "
                f"{st['device_busy_ms']:.1f} ms"
                + (f" ({st['busy_share']:.0%})" if st["kernels"] else
                   " (the profiler recorded no device time: not measured)")
                + f", {st['kernels']} kernels; top: "
                + "; ".join(f"{t['op']} {t['ms']:.2f} ms x{t['calls']}"
                            for t in st["top"][:8]))

    # the reduced fp32 configs: two steps on the card and on the CPU from
    # the same converted weights and batch
    tol = LM_TRAIN_FP32_TOL

    def hold(name, what, got, want, lr):
        """Each leaf of ``got`` against ``want``: at most a share
        tol["near_zero"] of its elements (at least one) beyond
        tol["param"] of its max, none beyond two learning rates.  Returns
        the worst max |difference| / max |value|."""
        worst = 0.0
        for a, b in zip(leaves(got), leaves(want)):
            a, b = a.detach().cpu().float(), b.detach().cpu().float()
            m = float(b.abs().max()) or 1.0
            d = (a - b).abs()
            far = int((d > tol["param"] * m).sum())
            if far > math.ceil(tol["near_zero"] * d.numel()) or \
                    float(d.max()) > 2 * lr + tol["param"] * m:
                raise AssertionError(
                    f"{name}: {what} differ: {float(d.max()) / m:.3g} of "
                    f"the max, {far} of {d.numel()} elements beyond "
                    f"{tol['param']}")
            worst = max(worst, float(d.max()) / m)
        return worst

    def hold_metrics(name, what, got, want):
        worst = 0.0
        for k, w in want.items():
            g, w = float(got[k]), float(w)
            err = abs(g - w) / max(abs(w), 1e-12)
            if abs(g - w) > 1e-12 and err > tol["rtol"]:
                raise AssertionError(f"{name}: {what} {k} {g} against {w}")
            worst = max(worst, err if abs(g - w) > 1e-12 else 0.0)
        return worst

    cases = [("dense", LM_REDUCED, {}),
             ("dense-adafactor", LM_REDUCED, {"optimizer": "adafactor"}),
             ("mixtral-r-microbatches", LM_REDUCED_FAMILIES["mixtral-r"],
              {"microbatches": 2}),
             ("mamba2-r", LM_REDUCED_FAMILIES["mamba2-r"], {}),
             ("zamba2-r", LM_REDUCED_FAMILIES["zamba2-r"], {}),
             ("seamless-r", LM_REDUCED_FAMILIES["seamless-r"], {})]
    out["reduced_fp32"] = {}
    for name, kw, over in cases:
        kw = dict(kw)
        if "moe" in kw:
            kw["moe"] = MoEConfig(**kw["moe"])
        if "ssm" in kw:
            kw["ssm"] = SSMConfig(**kw["ssm"])
        cfg = ArchConfig(**kw)
        tree = convert.lm_params_to_numpy(registry.init_params(
            torch.Generator().manual_seed(SEED), cfg, device="cpu"))
        host = pipeline.synthetic_lm_batch(pipeline.DataConfig(
            cfg.vocab, 32, LM_BATCH, SEED), 0)
        batch = {d: pipeline.to_device(host, d) for d in (dev, cpu)}
        if cfg.family == "encdec":
            frames = torch.randn(
                (LM_BATCH, LM_TRAIN_FRAMES, cfg.d_model), device=dev,
                generator=torch.Generator(device=dev).manual_seed(SEED))
            for d in (dev, cpu):
                batch[d]["frames"] = frames.to(d)
        settings = steps.TrainSettings(**over)
        tx = steps.make_optimizer(settings)
        lr = settings.learning_rate
        runs = {}
        for d in (cpu, dev):
            step = steps.build_train_step(cfg, settings)
            p0 = convert.lm_params_from_numpy(tree, cfg, device=d)
            first = step(p0, tx.init(p0), batch[d])
            if d == cpu:
                start = first
            # the second step of each from the CPU's first-step state
            moved = tree_map(lambda t: t.to(d), start[:2])
            runs[d.type] = (first, step(moved[0], moved[1], batch[d]))
        row = {"settings": over}
        for i in range(2):
            card, host_ = runs[dev.type][i], runs["cpu"][i]
            row[f"step{i + 1}_param_rel"] = hold(
                name, f"step {i + 1}'s params", card[0], host_[0], lr)
            row[f"step{i + 1}_metric_rel"] = hold_metrics(
                name, f"step {i + 1}'s", card[2], host_[2])
        if name == "dense":
            # remat off against on, both on the card
            off = steps.TrainSettings(remat=False)
            p0 = convert.lm_params_from_numpy(tree, cfg, device=dev)
            plain = steps.build_train_step(cfg, off)(p0, tx.init(p0),
                                                     batch[dev])
            row["remat_off_param_rel"] = hold(
                name, "remat off against on: params", plain[0],
                runs[dev.type][0][0], lr)
            row["remat_off_metric_rel"] = hold_metrics(
                name, "remat off against on:", plain[2],
                runs[dev.type][0][2])
        out["reduced_fp32"][name] = row
        log(f"  {cfg.name} fp32 {over or ''}: two train steps, card against "
            f"CPU: params {row['step1_param_rel']:.3g} / "
            f"{row['step2_param_rel']:.3g} of the max, metrics "
            f"{row['step1_metric_rel']:.3g} / {row['step2_metric_rel']:.3g}"
            + (f"; remat off against on {row['remat_off_param_rel']:.3g} / "
               f"{row['remat_off_metric_rel']:.3g}"
               if "remat_off_param_rel" in row else ""))

    # the 100M example's training (examples/torch_train_lm_100m.py)
    c = LM_100M
    cfg = launch_train.small_config(registry.load_arch("llama3_2_3b"),
                                    c["d_model"], c["layers"], c["vocab"])
    base = fresh()
    with Recorder() as rec:
        t0 = time.perf_counter()
        res = launch_train.run_training(
            cfg, steps_n=c["steps"], global_batch=c["batch"],
            seq_len=c["seq"], lr=c["lr"], data_vocab=c["data_vocab"],
            log_every=50, device=dev)
        sync()
        wall = time.perf_counter() - t0
    losses = res["losses"]
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    like = registry.init_params(torch.Generator(), cfg, device="meta")
    row = {"params": sum(t.numel() for t in leaves(like)),
           "first10": first, "last10": last, "run_s": wall,
           "step_ms_median": statistics.median(rec.ms[1:]),
           "peak_gib": peak_gib(base),
           **lm_train_bound(cfg, like, c["batch"] * c["seq"], c["batch"])}
    del res
    if not last < first - 0.5:
        raise AssertionError(f"the 100M run's loss went {first:.3f} -> "
                             f"{last:.3f}, not down by 0.5")
    out["lm_100m"] = row
    log(f"  100M example ({row['params'] / 1e6:.1f}M params, fp32, "
        f"{c['steps']} steps of {c['batch']} x {c['seq']}): loss "
        f"{first:.3f} -> {last:.3f}; step {row['step_ms_median']:.2f} ms "
        f"(median; bound {row['bound_ms']:.3f} ms), {wall:.1f} s")

    out["launches"] = ops.launch_counts()
    if any(out["launches"].values()):
        raise AssertionError(f"the LM training path launched SNN kernels: "
                             f"{out['launches']}")
    log(f"  the seven kernels' launches on the LM training path: "
        f"{out['launches']}")
    return out


def mesh_phase(torch, dev) -> dict:
    """Phase 10: the mesh path (see the module docstring).  A world-size-1
    process group (NCCL on the card, gloo on the CPU) and a 1x1 ("data",
    "model") DeviceMesh; on it every op dispatches through DTensor, so the
    difference from mesh=None is DTensor's host work per op.  The group is
    destroyed before the phase returns."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import pipeline
    from repro_torch.distributed import sharding
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train as launch_train
    from repro_torch.models import registry
    from repro_torch.serve import engine
    from repro_torch.train import steps
    from repro_torch.tree import leaves

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def fresh():
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            return torch.cuda.memory_allocated()
        return 0

    def peak_gib(base):
        return ((torch.cuda.max_memory_allocated() - base) / 2 ** 30
                if dev.type == "cuda" else None)

    def local(x):
        return x.to_local() if isinstance(x, DTensor) else x

    tol = LM_TRAIN_FP32_TOL
    out = {"train": {}, "serve": {}}
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = mesh_lib.make_test_mesh((1, 1), ("data", "model"),
                                       device_type=dev.type)
        cfg = registry.load_arch(MESH_ARCH)
        ops.reset_launch_counts()

        # (a) training through run_training, mesh=None then the mesh
        orig = steps.build_train_step
        for tag, m in (("none", None), ("mesh", mesh)):
            rec = {"ms": [], "loss": [], "grad_norm": [], "first": None}

            def build(cfg_, settings, mesh_=None, rec=rec):
                fn = orig(cfg_, settings, mesh_)

                def step(params, opt_state, batch):
                    sync()
                    t0 = time.perf_counter()
                    new = fn(params, opt_state, batch)
                    sync()
                    rec["ms"].append((time.perf_counter() - t0) * 1e3)
                    rec["loss"].append(float(new[2]["loss"]))
                    rec["grad_norm"].append(float(new[2]["grad_norm"]))
                    if rec["first"] is None:
                        rec["first"] = new[0]
                    return new
                return step

            base = fresh()
            steps.build_train_step = build
            try:
                res = launch_train.run_training(
                    cfg, steps_n=MESH_TRAIN_STEPS,
                    global_batch=LM_TRAIN_BATCH, seq_len=LM_TRAIN_SEQ,
                    lr=3e-4, seed=SEED, log_every=1, mesh=m,
                    device=dev if m is None else None)
            finally:
                steps.build_train_step = orig
            sync()
            state = res["state"]
            if m is not None:
                bad = [type(x).__name__ + (f" on {local(x).device}"
                                           if isinstance(x, DTensor) else "")
                       for x in leaves(state)
                       if not (isinstance(x, DTensor)
                               and local(x).device.type == dev.type)]
                if bad:
                    raise AssertionError(f"mesh state leaves off the mesh: "
                                         f"{bad[:5]}")
            # MESH_TIMED more steps from the final state, for a warm median
            settings = steps.TrainSettings(learning_rate=3e-4, remat=True,
                                           z_loss=1e-4)
            fn = orig(cfg, settings, m)
            batch = pipeline.to_device(pipeline.synthetic_lm_batch(
                pipeline.DataConfig(cfg.vocab, LM_TRAIN_SEQ, LM_TRAIN_BATCH,
                                    SEED), MESH_TRAIN_STEPS), dev)
            if m is not None:
                batch = sharding.place_tree(batch, sharding.to_named(
                    sharding.batch_specs(cfg, batch, m), m))
            warm = []
            for _ in range(MESH_TIMED):
                sync()
                t0 = time.perf_counter()
                fn(state["params"], state["opt"], batch)
                sync()
                warm.append((time.perf_counter() - t0) * 1e3)
            out["train"][tag] = {
                "step_ms": rec["ms"], "warm_step_ms": warm,
                "warm_step_ms_median": statistics.median(warm),
                "losses": rec["loss"], "grad_norms": rec["grad_norm"],
                "peak_gib": peak_gib(base), "first": rec["first"]}
            del res, state, fn
        a, b = out["train"]["mesh"], out["train"]["none"]
        for k in ("losses", "grad_norms"):
            for g, w in zip(a[k], b[k]):
                if not (math.isfinite(g) and
                        abs(g - w) <= tol["rtol"] * max(abs(w), 1e-12)):
                    raise AssertionError(f"mesh {k} {a[k]} against {b[k]}")
        worst, far_total = 0.0, 0
        for x, y in zip(leaves(a.pop("first")), leaves(b.pop("first"))):
            x, y = local(x).float(), y.float()
            mx = float(y.abs().max()) or 1.0
            d = (x - y).abs()
            far = int((d > tol["param"] * mx).sum())
            if far > math.ceil(tol["near_zero"] * d.numel()) or \
                    float(d.max()) > 2 * 3e-4 + tol["param"] * mx:
                raise AssertionError(f"mesh params after step 1 differ: "
                                     f"{float(d.max()) / mx:.3g} of the max, "
                                     f"{far} of {d.numel()}")
            worst, far_total = max(worst, float(d.max()) / mx), \
                far_total + far
        out["train"]["step1_param_rel"] = worst
        out["train"]["step1_far_elements"] = far_total
        out["train"]["dispatch_ms"] = (a["warm_step_ms_median"]
                                       - b["warm_step_ms_median"])
        log(f"  {cfg.name} ({cfg.num_layers} layers, d_model {cfg.d_model}, "
            f"bf16, AdamW, remat, {LM_TRAIN_BATCH} x {LM_TRAIN_SEQ}) through "
            f"run_training: mesh=None steps "
            f"{[round(x, 2) for x in b['step_ms']]} ms, warm median "
            f"{b['warm_step_ms_median']:.2f} ms, peak "
            f"{b['peak_gib'] or float('nan'):.2f} GiB; 1x1 mesh steps "
            f"{[round(x, 2) for x in a['step_ms']]} ms, warm median "
            f"{a['warm_step_ms_median']:.2f} ms, peak "
            f"{a['peak_gib'] or float('nan'):.2f} GiB; DTensor's dispatch "
            f"{out['train']['dispatch_ms']:+.2f} ms a step; losses "
            f"{[round(x, 4) for x in a['losses']]} (mesh=None "
            f"{[round(x, 4) for x in b['losses']]}); params after step 1 "
            f"within {worst:.3g} of the max ({far_total} elements beyond "
            f"{tol['param']})")

        # (b) serving through the engine's steps
        shape = ShapeConfig("mesh-serve", LM_MAX_LEN, LM_REQUESTS, "decode")
        params = registry.init_params(
            torch.Generator(device=dev).manual_seed(SEED), cfg, device=dev)
        prompts = torch.from_numpy(np.random.default_rng(SEED).integers(
            1, cfg.vocab, (LM_REQUESTS, MESH_PROMPT)).astype(np.int32)).to(
                dev)
        runs = {}
        for tag, m in (("none", None), ("mesh", mesh)):
            base = fresh()
            p = params
            if m is not None:
                p, b_sh = engine.place_for_serving(cfg, params, m, shape,
                                                   mode="prefill")
            prefill = engine.build_prefill_step(cfg, LM_MAX_LEN)
            decode = engine.build_decode_step(cfg)
            with torch.no_grad():
                sync()
                t0 = time.perf_counter()
                logits, cache = prefill(p, {"tokens": prompts})
                sync()
                prefill_ms = (time.perf_counter() - t0) * 1e3
                if m is not None:
                    p, _ = engine.place_for_serving(cfg, params, m, shape,
                                                    mode="decode")
                    # prefill builds the cache in serve_shardings' layout
                    bad = [k for k, v in cache.items() if k != "length"
                           and not (isinstance(v, DTensor)
                                    and local(v).device.type == dev.type
                                    and tuple(v.placements)
                                    == b_sh["cache"][k].placements)]
                    if bad:
                        raise AssertionError(f"cache leaves off the mesh: "
                                             f"{bad}")
                token = torch.argmax(local(logits)[:, -1], -1).to(
                    torch.int32)[:, None]
                toks, ms, last = [token[:, 0].tolist()], [], None
                for _ in range(MESH_DECODE):
                    sync()
                    t0 = time.perf_counter()
                    o = decode(p, {"token": token, "cache": cache})
                    sync()
                    ms.append((time.perf_counter() - t0) * 1e3)
                    cache, token = o["cache"], o["next_token"][:, None]
                    toks.append(token[:, 0].tolist())
                    last = local(o["logits"]).float()
            runs[tag] = {"tokens": toks, "prefill_ms": prefill_ms,
                         "decode_ms": ms,
                         "decode_ms_median": statistics.median(ms[1:]),
                         "peak_gib": peak_gib(base), "last": last}
            del cache, p, prefill, decode
        a, b = runs["mesh"], runs["none"]
        if a["tokens"] != b["tokens"]:
            raise AssertionError(f"mesh tokens {a['tokens']} against "
                                 f"{b['tokens']}")
        diff = float((a.pop("last") - b.pop("last")).abs().max())
        if not math.isfinite(diff):
            raise AssertionError("mesh decode logits not finite")
        out["serve"] = {**runs, "last_logits_max_diff": diff}
        del params
        log(f"  {cfg.name} serving {LM_REQUESTS} requests ({MESH_PROMPT}-"
            f"token prompts, {MESH_DECODE} decode steps): mesh=None prefill "
            f"{b['prefill_ms']:.2f} ms, decode {b['decode_ms_median']:.2f} ms"
            f" (median of steps 2-{MESH_DECODE}); 1x1 mesh prefill "
            f"{a['prefill_ms']:.2f} ms, decode {a['decode_ms_median']:.2f} ms"
            f"; tokens equal; last logits within {diff:.3g}; peak "
            f"{b['peak_gib'] or float('nan'):.2f} / "
            f"{a['peak_gib'] or float('nan'):.2f} GiB")
        out["launches"] = ops.launch_counts()
        if any(out["launches"].values()):
            raise AssertionError(f"the mesh path launched SNN kernels: "
                                 f"{out['launches']}")
        log(f"  the seven kernels' launches on the mesh path: "
            f"{out['launches']}")
    finally:
        dist.destroy_process_group()
    return out


def start_dryruns(dev_type: str) -> list:
    """Phase 11 (a): ``ROOFLINE_GROUPS`` through ``python -m
    repro_torch.launch.dryrun --mesh single`` on ``dev_type``, each group
    in its own process (its own fake group), all started at once; records
    and logs go to ``chiprun_out/dryrun/``.  Returns the processes."""
    out_dir = OUT.parent / "dryrun"
    out_dir.mkdir(parents=True, exist_ok=True)
    for old in list(out_dir.glob("*.json")) + list(out_dir.glob("*.log")):
        old.unlink()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = []
    for i, group in enumerate(ROOFLINE_GROUPS):
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", *group,
               "--mesh", "single", "--device", dev_type, "--out",
               str(out_dir)]
        with open(out_dir / f"group{i}.log", "w") as logf:
            procs.append(subprocess.Popen(cmd, cwd=ROOT, env=env,
                                          stdout=logf,
                                          stderr=subprocess.STDOUT))
    return procs


def finish_dryruns(procs: list) -> dict:
    """Wait for ``start_dryruns``' processes (``ROOFLINE_TIMEOUT_S`` in
    all) and read their records: by (arch, shape)."""
    out_dir = OUT.parent / "dryrun"
    deadline = time.monotonic() + ROOFLINE_TIMEOUT_S
    for i, proc in enumerate(procs):
        proc.wait(timeout=max(1.0, deadline - time.monotonic()))
        text = (out_dir / f"group{i}.log").read_text()
        for line in text.splitlines():
            if line.startswith(("[     ok]", "[skipped]", "[ failed]")):
                log(f"  {line}")
        if proc.returncode != 0:
            raise AssertionError(f"the dry run {ROOFLINE_GROUPS[i]} exited "
                                 f"{proc.returncode}:\n{text[-3000:]}")
    return {(r["arch"], r["shape"]): r for r in
            (json.loads(p.read_text()) for p in sorted(
                out_dir.glob("*__single.json")))}


# The conv epilogue's timing phase: net-5's two conv layers' maps (B, H,
# W, F), each followed by a 2 x 2 OR-pool, the subtract reset.
EPILOGUE_LAYERS = {"conv1": (BATCH, 128, 128, 32), "conv2": (BATCH, 64, 64,
                                                            32)}


def epilogue_bytes(shape, window: int) -> dict:
    """Bytes each way of the conv epilogue at the subtract reset, pooled:
    forward reads cur, u_prev, s_prev and writes u, s, the pooled map and
    the first maxima; backward reads gu, gs, u, the pooled cotangent and
    the first maxima and writes d_cur, d_u_prev, d_s_prev (the bias and
    its per-block partial sums are under 0.1% and left out)."""
    n = math.prod(shape)
    pooled = n // (window * window)
    return {"forward": 4 * 5 * n + 5 * pooled,
            "backward": 4 * 6 * n + 5 * pooled}


def epilogue_phase(torch, dev) -> list:
    """The two conv-epilogue kernels alone, L2 flushed, at net-5's conv
    layers, each against its byte bound and against the unfused chain of
    PyTorch ops (its plain version) on the card: a row a kernel a layer."""
    epilogue_kernel = importlib.import_module(
        "repro_torch.kernels.conv_epilogue")
    from repro_torch.kernels import ref
    gen = torch.Generator(device=dev).manual_seed(SEED)
    flush = l2_flush(torch, dev)
    kw = dict(beta=0.95, threshold=1.0, reset_mechanism="subtract")
    rows = []
    for name, shape in EPILOGUE_LAYERS.items():
        b, h, w, f = shape
        pshape = (b, h // 2, w // 2, f)
        cur, u_prev, gu, gs = (torch.randn(shape, generator=gen, device=dev)
                               for _ in range(4))
        s_prev = (torch.rand(shape, generator=gen, device=dev) < 0.1).float()
        gp = torch.randn(pshape, generator=gen, device=dev)
        bias = torch.randn(f, generator=gen, device=dev) * 0.1
        u, _, _, first = epilogue_kernel.conv_epilogue_fwd_cuda(
            cur, bias, u_prev, s_prev, window=2, **kw)
        needs = (True, True, True, True)
        calls = {
            "forward": (
                lambda: epilogue_kernel.conv_epilogue_fwd_cuda(
                    cur, bias, u_prev, s_prev, window=2, **kw),
                lambda: ref.conv_lif_ref(cur, bias, u_prev, s_prev, window=2,
                                         **kw)),
            "backward": (
                lambda: epilogue_kernel.conv_epilogue_bwd_cuda(
                    gu, gs, gp, first, u, None, None, needs, slope=25.0,
                    window=2, **kw),
                lambda: ref.conv_lif_bwd_ref(
                    gu, gs, gp, first, u, None, None, slope=25.0, window=2,
                    **kw)[0].sum_to_size(f))}
        nbytes = epilogue_bytes(shape, 2)
        for way, (fused, plain) in calls.items():
            row = {"kernel": f"conv_epilogue {way}", "layer": name,
                   "shape": list(shape),
                   "kernel_device_ms": device_ms(torch, fused, flush=flush),
                   "plain_device_ms": device_ms(torch, plain, flush=flush),
                   "ms": median_ms(torch, fused),
                   "plain_ms": median_ms(torch, plain),
                   "bound_ms": bound_ms(nbytes[way], 0)[0]}
            if row["kernel_device_ms"]:
                row["bound_share"] = row["bound_ms"] / row["kernel_device_ms"]
            rows.append(row)
            log(f"  {name} {way}: kernel {row['kernel_device_ms']} ms "
                f"(device, flushed), bound {row['bound_ms']:.4f} ms "
                f"({row.get('bound_share', 0):.1%}); unfused chain "
                f"{row['plain_device_ms']} ms; event-timed {row['ms']:.4f} "
                f"/ {row['plain_ms']:.4f} ms")
        del cur, u_prev, gu, gs, s_prev, gp, u, first
    return rows


def counted_step(torch, dev) -> dict:
    """Phase 11 (b): one AdamW step of tinyllama-1.1b at full width on the
    card, timed without the counter and run once under
    ``roofline.counting.count``: the counted step's loss and new state must
    equal the uncounted one's bit for bit, its FLOPs those of the same step
    counted on fake tensors, and lm_train_bound's less what the bound
    counts that the step does not run.  The seven kernels' counters are
    set to 0 before it and read after; it launches none of them."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.data import pipeline
    from repro_torch.kernels import ops
    from repro_torch.models import registry
    from repro_torch.roofline import analysis, counting
    from repro_torch.train import steps
    from repro_torch.tree import leaves, tree_map

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    cfg = registry.load_arch(MESH_ARCH)
    settings = steps.TrainSettings(learning_rate=3e-4, remat=True,
                                   z_loss=1e-4)
    step = steps.build_train_step(cfg, settings)
    params = registry.init_params(
        torch.Generator(device=dev).manual_seed(SEED), cfg, device=dev)
    opt = steps.make_optimizer(settings).init(params)
    batch = pipeline.to_device(pipeline.synthetic_lm_batch(
        pipeline.DataConfig(cfg.vocab, LM_TRAIN_SEQ, LM_TRAIN_BATCH, SEED),
        0), dev)
    ops.reset_launch_counts()
    plain = step(params, opt, batch)                 # the first call
    sync()
    ms = []
    for _ in range(ROOFLINE_TIMED):
        t0 = time.perf_counter()
        step(params, opt, batch)
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    counted, st = counting.count(step, params, opt, batch)
    sync()
    counted_ms = (time.perf_counter() - t0) * 1e3
    launches = ops.launch_counts()
    if any(launches.values()):
        raise AssertionError(f"the counted step launched SNN kernels: "
                             f"{launches}")
    if not torch.equal(counted[2]["loss"], plain[2]["loss"]):
        raise AssertionError(f"the counted step's loss "
                             f"{float(counted[2]['loss'])} against "
                             f"{float(plain[2]['loss'])}")
    unequal = sum(not torch.equal(a, b) for a, b in
                  zip(leaves(counted[:2]), leaves(plain[:2])))
    if unequal:
        raise AssertionError(f"{unequal} leaves of the counted step's new "
                             f"params and optimizer state differ from the "
                             f"uncounted step's")
    loss = float(plain[2]["loss"])
    del counted, plain

    # the same step on fake tensors of the same shapes: no device work
    def fake(tree):
        return tree_map(lambda x: torch.empty(tuple(x.shape), dtype=x.dtype,
                                              device=dev)
                        if isinstance(x, torch.Tensor) else x, tree)

    with FakeTensorMode():
        _, fake_st = counting.count(step, fake(params), fake(opt),
                                    fake(batch))
    if fake_st.flops != st.flops:
        raise AssertionError(f"the card's count {st.flops} against the fake "
                             f"tensors' {fake_st.flops}")
    tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    bound = lm_train_bound(cfg, params, tokens, LM_TRAIN_BATCH)
    w_down = params["layers"]["mlp"]["w_down"]["w"].numel()
    scales = sum(t.numel() for path, t in tree_paths(params)
                 if path[-1] == "scale")
    explained = bound["flops"] - 2 * w_down * tokens - 8 * scales * tokens
    gap = 1 - st.flops / bound["flops"]
    if st.flops != explained or not 0 <= gap <= ROOFLINE_BOUND_GAP:
        raise AssertionError(f"counted {st.flops} FLOPs against the bound's "
                             f"{bound['flops']} ({gap:.4%} fewer), "
                             f"{explained} explained")
    del params, opt, batch
    compute_s = st.flops / analysis.PEAK_FLOPS
    memory_s = st.bytes_accessed / analysis.HBM_BW
    step_ms = statistics.median(ms)
    card = smi_line()
    log(f"  {cfg.name} AdamW step ({LM_TRAIN_BATCH} x {LM_TRAIN_SEQ}, bf16, "
        f"remat) under counting.count: loss and new state bit for bit the "
        f"uncounted step's; {st.flops:.6g} FLOPs (the fake tensors' count "
        f"equal; lm_train_bound's {bound['flops']:.6g} is {gap:.4%} more, "
        f"all of it the down projections' recompute and the norm scales), "
        f"{st.bytes_accessed:.6g} bytes, peak {st.peak_bytes / 2 ** 30:.2f} "
        f"GiB counted; terms at the data sheet's peaks: compute "
        f"{compute_s * 1e3:.3f} ms, memory {memory_s * 1e3:.3f} ms, against "
        f"a measured {step_ms:.2f} ms (median of "
        f"{[round(x, 2) for x in ms]}): {compute_s * 1e3 / step_ms:.1%} and "
        f"{memory_s * 1e3 / step_ms:.1%} of it; card {card}")
    return {"launches": launches, "card": card, "step": {
        "arch": MESH_ARCH, "batch": LM_TRAIN_BATCH, "seq": LM_TRAIN_SEQ,
        "loss": loss, "step_ms": ms, "step_ms_median": step_ms,
        "counted_step_ms": counted_ms, "flops": st.flops,
        "bytes_accessed": st.bytes_accessed, "dots": st.dots,
        "peak_gib": st.peak_bytes / 2 ** 30,
        "argument_gib": st.argument_bytes / 2 ** 30,
        "bound_flops": bound["flops"], "bound_gap": gap,
        "compute_ms": compute_s * 1e3, "memory_ms": memory_s * 1e3,
        "compute_share": compute_s * 1e3 / step_ms,
        "memory_share": memory_s * 1e3 / step_ms}}


def roofline_phase(torch, dev) -> dict:
    """Phase 11: the roofline and the dry run (see the module docstring):
    the dry runs' processes run while the counted step runs here, and are
    all stopped before this returns."""
    from repro_torch.roofline import report as rreport

    procs = start_dryruns(dev.type)
    try:
        out = counted_step(torch, dev)
        recs = finish_dryruns(procs)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    out["cells"] = {}
    for arch, shape, want in ROOFLINE_CELLS:
        rec = recs.get((arch, shape))
        if rec is None or rec["status"] != want:
            raise AssertionError(f"dry run {arch} x {shape}: "
                                 f"{rec and rec['status']} (want {want}): "
                                 f"{rec and rec.get('error')}")
        if want != "ok":
            log(f"  dry run {arch} x {shape} x 16x16: {rec['status']} "
                f"({rec['reason']})")
            out["cells"][f"{arch}__{shape}"] = {"status": rec["status"]}
            continue
        row = rreport.roofline_rows([rec], "single")[0]
        if not 0 < row["useful_ratio"] <= 1:
            raise AssertionError(f"dry run {arch} x {shape}: useful ratio "
                                 f"{row['useful_ratio']}")
        cell = {"status": "ok", "device_type": rec["device_type"],
                "lower_s": rec["lower_s"], "compile_s": rec["compile_s"],
                "flops": rec["cost"]["flops"],
                "bytes_accessed": rec["cost"]["bytes_accessed"],
                "collectives": rec["collectives"]["bytes_by_kind"],
                "wire_bytes": rec["collectives"]["total_wire_bytes"],
                "memory_gb": rec["memory"]["total_bytes_per_device"] / 1e9,
                **{k: row[k] for k in ("compute_s", "memory_s",
                                       "collective_s", "bottleneck",
                                       "useful_ratio", "roofline_fraction")}}
        out["cells"][f"{arch}__{shape}"] = cell
        log(f"  dry run {arch} x {shape} x 16x16 ({rec['device_type']}, "
            f"{rec['compile_s']} s): per rank {cell['flops']:.4g} FLOPs, "
            f"{cell['bytes_accessed']:.4g} bytes, collectives "
            f"{cell['collectives']}, memory {cell['memory_gb']:.2f} GB; "
            f"compute {rreport.fmt_s(row['compute_s'])}, memory "
            f"{rreport.fmt_s(row['memory_s'])}, collective "
            f"{rreport.fmt_s(row['collective_s'])}: {row['bottleneck']}; "
            f"useful ratio {row['useful_ratio']:.4f}")
    return out


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
    from repro_torch.distributed import cellfarm, cellstack
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
        # phase 8's bf16 products sum in fp32, as the reference's do
        matmul = torch.backends.cuda.matmul
        matmul.allow_bf16_reduced_precision_reduction = False
        log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
            f"matmul.allow_tf32={matmul.allow_tf32} "
            f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
            f"matmul.allow_bf16_reduced_precision_reduction="
            f"{matmul.allow_bf16_reduced_precision_reduction}")
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

    def cell_stack(make):
        """A slab of CELLS cells: ``make(density)`` for each cell's
        density (its own weights, where ``make`` ignores the density)."""
        return torch.stack([make(d) for d in CELL_DENSITIES])

    def one_launch(kernel, call, what):
        """``call()``, which must launch ``kernel`` once for the slab."""
        before = ops.launch_counts()[kernel]
        got = call()
        torch.cuda.synchronize()
        launched = ops.launch_counts()[kernel] - before
        if launched != 1:
            raise AssertionError(f"{what}: {launched} launches for one slab,"
                                 " expected 1")
        return got

    def hold_cells(name, got, solo, plain, what):
        """Each cell of the slab outputs ``got`` equal to its solo launch
        ``solo(c)`` and to the plain version ``plain(c)`` bit for bit."""
        for c in range(CELLS):
            mine = [g[c] for g in got]
            hold(name, mine, solo(c), f"{what}, cell {c} against its solo "
                                      f"launch")
            hold(name, mine, plain(c), f"{what}, cell {c} against the plain "
                                       f"version")

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
        n_cases = 0
        for m, k, n in CELL_DENSE:
            w = cell_stack(lambda _: on_grid(torch.randn(
                k, n, generator=gen, device=dev) / math.sqrt(k) * 2))
            b = cell_stack(lambda _: on_grid(torch.randn(
                n, generator=gen, device=dev) * 0.1))
            u0 = torch.randn(CELLS, m, n, generator=gen, device=dev)
            s0 = spikes((CELLS, m, n), 0.3)
            s = cell_stack(lambda d: spikes((m, k), d))
            what = f"{CELLS} cells of S{(m, k)} W{(k, n)}"
            got = one_launch("spike_gemm",
                             lambda: ops.spike_gemm(s, w), what)
            hold_cells("spike_gemm", [got], lambda c: [
                ops.spike_gemm(s[c], w[c])], lambda c: [
                ref.spike_gemm_ref(s[c], w[c])], what)
            for reset in ("subtract", "zero"):
                kw = dict(beta=0.95, threshold=1.0, reset_mechanism=reset)
                got = one_launch("spike_gemm_lif",
                                 lambda: ops.spike_gemm_lif_step(
                                     s, w, b, u0, s0, **kw), what)
                hold_cells("spike_gemm_lif", got, lambda c: list(
                    ops.spike_gemm_lif_step(s[c], w[c], b[c], u0[c], s0[c],
                                            **kw)), lambda c: list(
                    ref.spike_gemm_lif_ref(s[c], w[c], b[c], u0[c], s0[c],
                                           **kw)), f"{what} {reset}")
            n_cases += 3
        for shape, feats, k, stride, padding in CONV_CASES[:-2]:
            conv = dict(stride=stride, padding=padding)
            w = cell_stack(lambda _: on_grid(torch.randn(
                k, k, shape[-1], feats, generator=gen, device=dev)
                / math.sqrt(k * k * shape[-1]) * 2))
            x = cell_stack(lambda d: spikes(shape, d))
            what = f"{CELLS} cells of x{shape} {k}x{k}x{feats} {conv}"
            got = one_launch("spike_conv",
                             lambda: ops.spike_conv(x, w, **conv), what)
            hold_cells("spike_conv", [got], lambda c: [
                ops.spike_conv(x[c], w[c], **conv)], lambda c: [
                ref.spike_conv_ref(x[c], w[c], **conv)], what)
            n_cases += 1
        torch.cuda.synchronize()
        log(f"{n_cases} slabs of {CELLS} cells (densities {CELL_DENSITIES}, "
            f"each cell its own weights), one launch each: every cell "
            f"equal to its solo launch and to the plain version")
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
        n_cases = 0
        for m, k, n in CELL_DENSE + [net5_bwd["fc1"], (5, 33, 7)]:
            w = cell_stack(lambda _: on_grid(torch.randn(
                k, n, generator=gen, device=dev) / math.sqrt(k) * 2))
            s = cell_stack(lambda d: spikes((m, k), d))
            g = cell_stack(lambda d: cotangent((m, n), 1.0 - d))
            what = f"{CELLS} cells of S{(m, k)} g{(m, n)} W{(k, n)}"
            dw = one_launch("spike_gemm_dw",
                            lambda: ops.spike_gemm_bwd_dw(s, g), what)
            ds = one_launch("spike_gemm_ds",
                            lambda: ops.spike_gemm_bwd_ds(g, w), what)
            hold_cells("spike_gemm_dw", [dw], lambda c: [
                ops.spike_gemm_bwd_dw(s[c], g[c])], lambda c: [
                ref.spike_gemm_dw_ref(s[c], g[c])], what)
            hold_cells("spike_gemm_ds", [ds], lambda c: [
                ops.spike_gemm_bwd_ds(g[c], w[c])], lambda c: [
                ref.spike_gemm_ds_ref(g[c], w[c])], what)
            n_cases += 2
        for shape, feats, k, stride, padding in CONV_CASES[:-2]:
            conv = dict(stride=stride, padding=padding)
            w = cell_stack(lambda _: on_grid(torch.randn(
                k, k, shape[-1], feats, generator=gen, device=dev)
                / math.sqrt(k * k) * 2))
            x = cell_stack(lambda d: spikes(shape, d))
            oh, ow = ref.spike_conv_ref(
                x[0, ..., :1], torch.zeros(k, k, 1, 1, device=dev),
                **conv).shape[1:3]
            g = cell_stack(lambda d: cotangent((shape[0], oh, ow, feats),
                                               1.0 - d))
            xs = (CELLS,) + tuple(shape)
            what = f"{CELLS} cells of x{shape} {k}x{k}x{feats} {conv}"
            dw = one_launch("spike_gemm_dw",
                            lambda: ops.spike_conv_bwd_dw(
                                x, g, kernel_size=(k, k), **conv), what)
            ds = one_launch("spike_gemm_ds",
                            lambda: ops.spike_conv_bwd_ds(g, w, xs, **conv),
                            what)
            hold_cells("spike_gemm_dw", [dw], lambda c: [
                ops.spike_conv_bwd_dw(x[c], g[c], kernel_size=(k, k),
                                      **conv)], lambda c: [
                ref.spike_conv_dw_ref(x[c], g[c], k, k, **conv)],
                f"conv dW {what}")
            hold_cells("spike_gemm_ds", [ds], lambda c: [
                ops.spike_conv_bwd_ds(g[c], w[c], tuple(shape), **conv)],
                lambda c: [ref.spike_conv_ds_ref(g[c], w[c], tuple(shape),
                                                 **conv)],
                f"conv dS {what}")
            n_cases += 2
        torch.cuda.synchronize()
        log(f"{n_cases} backward slabs of {CELLS} cells, one launch each: "
            f"every cell equal to its solo launch and to the plain version")
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
        # rows of one tile (one launch) and of several, the last ragged
        tile = penc_kernel.ROUND
        for shape in [(70, 1000), (5, 33), (3, 1), (64, 4099),
                      (5, 3 * tile + 7), (BATCH, 64 * 64 * 32)]:
            for d in DENSITIES:
                x = spikes(shape, d)
                ragged = shape[1] in (4099, 3 * tile + 7)
                for xx in [x, unaligned(x)] if ragged else [x]:
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

    def graph_nodes(loss):
        """The backward nodes of ``loss``'s graph, by class name."""
        seen, todo = set(), [loss.grad_fn]
        while todo:
            node = todo.pop()
            if node is not None and node not in seen:
                seen.add(node)
                todo.extend(n for n, _ in node.next_functions)
        return collections.Counter(type(n).__name__ for n in seen)

    def timed_step(ps, backend, nodes=None):
        """Loss and gradients of one training step, with the seconds of its
        forward and of its backward (host clock, synchronised); ``nodes``,
        if given, takes the graph's ``graph_nodes``."""
        leaves = leaves_of(ps)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = train_snn.loss_fn(cfg, leaves, enc, xb, yb,
                                 matmul_backend=backend)
        torch.cuda.synchronize()
        if nodes is not None:
            nodes.update(graph_nodes(loss))
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
            nodes = collections.Counter()
            try:
                loss, grads, fwd_s, bwd_s = timed_step(params, backend,
                                                       nodes)
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
            # on the kernel backends the conv epilogue pools: no OR-pool
            # node of its own, one epilogue node a conv layer a time step
            fused_pool = backend != "torch"
            graph = (nodes["_OrPoolBackward"], nodes["_ConvLifStepBackward"])
            log(f"  {backend}: graph nodes _OrPoolBackward {graph[0]}, "
                f"_ConvLifStepBackward {graph[1]}")
            if graph != ((0, 2 * NUM_STEPS) if fused_pool
                         else (2 * NUM_STEPS, 0)):
                raise AssertionError(f"the {backend} step's graph holds "
                                     f"{graph} OR-pool and epilogue nodes")
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

    # ---- 6c. many cells at once: a slab, the farm, a stacked study -------
    with Phase(f"{SLAB_CELLS} dvs-conv cells as one slab, the farm, and a "
               f"stacked coexplore"):
        slab = {}
        dvs = workloads.get("dvs-conv")
        asn = {"num_steps": CELL_STEPS, "population": 1.0}
        slab_seeds = list(range(SLAB_CELLS))
        farm_seeds = [SLAB_CELLS, SLAB_CELLS + 1]
        with tempfile.TemporaryDirectory() as root:
            stack_cache = workloads.TraceCache(root=f"{root}/slab")
            solo_cache = workloads.TraceCache(root=f"{root}/solo")
            jobs = [cellfarm.CellJob(dvs, asn, seed=s, quant_bits=(8,))
                    for s in slab_seeds]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            parts = {}
            outcomes = cellstack.resolve_stacked(jobs, stack_cache.root,
                                                 cache=stack_cache,
                                                 stats=parts)
            torch.cuda.synchronize()
            slab_s = time.perf_counter() - t0
            slab_launches = ops.launch_counts()
            peak = torch.cuda.max_memory_allocated()
            want = dvs_cell_launches(dvs, CELL_STEPS)
            log(f"  slab of {SLAB_CELLS}: {slab_s:.2f} s "
                f"({SLAB_CELLS / slab_s * 60:.1f} cells a minute), peak "
                f"memory {peak / 2**30:.2f} GiB; launches {slab_launches}")
            log("  where the slab's time goes (host clock, s): "
                + ", ".join(f"{k} {v:.2f}" for k, v in parts.items()
                            if k.endswith("seconds")))
            if not all(o.trained and o.error is None for o in outcomes):
                raise AssertionError(f"the slab did not train every cell: "
                                     f"{outcomes}")
            if slab_launches != want:
                raise AssertionError(f"the slab launched {slab_launches}, "
                                     f"expected one solo cell's {want}")
            solo_s, solos = [], {}
            for seed in slab_seeds[:2] + farm_seeds:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                solo = solo_cache.resolve(dvs, asn, seed=seed,
                                          quant_bits=(8,))
                torch.cuda.synchronize()
                solo_s.append(time.perf_counter() - t0)
                if solo.cache_hit:
                    raise AssertionError("the solo root already held it")
                solos[seed] = solo
                if seed in slab_seeds:
                    same_cell(stack_cache.resolve(dvs, asn, seed=seed,
                                                  quant_bits=(8,)),
                              solo, f"slab cell {seed} against solo")
            solo_miss = statistics.median(solo_s)
            t0 = time.perf_counter()
            dvs.make_data(CELL_STEPS)
            slab["make_data_s"] = time.perf_counter() - t0
            log(f"  dvs-conv's make_data: {slab['make_data_s']:.2f} s (a "
                f"solo miss makes it twice: training, then the fixed-point "
                f"accuracy)")
            log(f"  solo misses {[round(s, 2) for s in solo_s]} s (median "
                f"{solo_miss:.2f} s, {60 / solo_miss:.1f} cells a minute); "
                f"slab cells 0 and 1 equal their solo runs bit for bit")
            t0 = time.perf_counter()
            try:
                farmed = cellfarm.resolve_cells(
                    [cellfarm.CellJob(dvs, asn, seed=s, quant_bits=(8,))
                     for s in farm_seeds], f"{root}/farm", workers=2)
            finally:
                cellfarm.shutdown_pool()
            farm_s = time.perf_counter() - t0
            if not all(o.trained and o.error is None for o in farmed):
                raise AssertionError(f"the farm failed: {farmed}")
            farm_cache = workloads.TraceCache(root=f"{root}/farm")
            for seed in farm_seeds:
                same_cell(farm_cache.resolve(dvs, asn, seed=seed),
                          solo_cache.resolve(dvs, asn, seed=seed),
                          f"farmed cell {seed} against solo")
            log(f"  resolve_cells(workers=2) of seeds {farm_seeds}: "
                f"{farm_s:.2f} s, spawn included; equal to solo bit for "
                f"bit")
            slab.update(cells=SLAB_CELLS, slab_s=slab_s,
                        slab_cells_per_minute=SLAB_CELLS / slab_s * 60,
                        solo_miss_s=solo_s,
                        solo_cells_per_minute=60 / solo_miss,
                        peak_bytes=peak, launches=slab_launches,
                        slab_parts=parts,
                        farm_s=farm_s)

            shard = dataclasses.replace(dvs, name="dvs-conv-shard17",
                                        data_seed=17)
            kw = dict(datasets=(dvs, shard), num_steps=(8,),
                      population=(1.0,))
            fronts = {}
            for mode, extra in (("serial", {}), ("stacked", {"stack": True})):
                cache = workloads.TraceCache(root=f"{root}/co-{mode}")
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = dse.coexplore(cache=cache, **kw, **extra)
                secs = time.perf_counter() - t0
                fronts[mode] = res
                log(f"  coexplore of dvs-conv and its data_seed=17 shard, "
                    f"{mode}: {secs:.2f} s, {cache.misses} misses, "
                    f"{cache.hits} hits, farmed {res.study.farmed_misses}")
                slab[f"coexplore_{mode}_s"] = secs
            if fronts["stacked"].study.farmed_misses != 2 or \
                    fronts["stacked"].cache.misses != 0:
                raise AssertionError("the stacked coexplore did not farm "
                                     "both cells")
            a, b = (fronts[m].frontier.columns for m in ("serial", "stacked"))
            if a.keys() != b.keys() or not all(
                    np.array_equal(a[k], b[k]) for k in a):
                raise AssertionError("the stacked coexplore's frontier "
                                     "differs from the serial one")
            log(f"  equal frontiers ({len(fronts['serial'].frontier)} "
                f"designs)")

        # one training step of the slab against one solo step: device busy
        # share and kernels a step, from the profiler
        cfg_c = dvs.build(CELL_STEPS, 1.0)
        tx = optim.adam(dvs.lr)
        data_c = dvs.make_data(CELL_STEPS)
        xb = torch.as_tensor(data_c.x_train[:dvs.batch_size], device=dev)
        yb = torch.as_tensor(data_c.y_train[:dvs.batch_size], device=dev)
        inits = [train_snn.init_cell(cfg_c, tx, s) for s in slab_seeds]
        slab_p = cellstack.stack_params([i[0] for i in inits])
        steps = {
            "solo": (train_snn.make_train_step(cfg_c, tx), inits[0][0],
                     inits[0][1], inits[0][2], xb, yb),
            "slab": (train_snn.make_stacked_train_step(cfg_c, tx), slab_p,
                     tx.init(slab_p), [i[2] for i in inits],
                     xb.expand((SLAB_CELLS,) + tuple(xb.shape)).contiguous(),
                     yb.expand(SLAB_CELLS, -1).contiguous())}
        for name, (fn, p, st, g, x, y) in steps.items():
            # the eager warm-up, profiled, then the capture; a replay must
            # launch the eager step's kernels, as the profiler lists them,
            # and count them
            ops.reset_launch_counts()
            eager_names = profiled_names(torch, lambda: fn(p, st, g, x, y))
            eager_launches = ops.launch_counts()
            fn(p, st, g, x, y)
            ops.reset_launch_counts()
            replay_names = profiled_names(torch, lambda: fn(p, st, g, x, y))
            replay_launches = ops.launch_counts()
            st_ = slab[f"{name}_step"] = step_profile(
                torch, lambda: fn(p, st, g, x, y))
            log(f"  one {name} training step: {st_['wall_ms']:.1f} ms "
                f"unprofiled, device busy {st_['device_busy_ms']:.1f} ms "
                + (f"({st_['busy_share']:.0%})" if st_["kernels"] else
                   "(the profiler recorded no device time: not measured)")
                + f", {st_['kernels']} device kernels; a replay's "
                f"{sum(replay_names.values())} other than copies and "
                f"fills, by name, against the eager step's "
                f"{sum(eager_names.values())}")
            if not (eager_names and replay_names):
                log(f"  the profiler recorded no kernel of the eager or the "
                    f"replayed {name} step: their kernels not compared")
            elif replay_names != eager_names:
                raise AssertionError(
                    f"a replayed {name} step launched other kernels than "
                    f"the eager one: {(replay_names - eager_names) or {}} "
                    f"more, {(eager_names - replay_names) or {}} fewer")
            if replay_launches != eager_launches:
                raise AssertionError(
                    f"a replayed {name} step counted {replay_launches}, "
                    f"the eager step {eager_launches}")
        del steps, inits, slab_p
        report["slab"] = slab

    # ---- 6d. the DSE service over the fleet, a killed worker, the
    # supervisor
    with Phase("the DSE service over the fleet, a worker killed mid-cell, "
               "the training supervisor"):
        report["fleet"] = fleet_phase(torch, dev, miss, solos[1])

    # ---- 8. the LM serving path (run before the timing, so that its
    # numbers come from a card no timing loop has just heated) -----------
    with Phase("the LM serving path: every family at full width"):
        report["lm"] = lm_phase(torch, dev)

    # ---- 9. the LM training path ----------------------------------------
    with Phase("the LM training path: tinyllama-1.1b and mamba2-780m at "
               "full width, the reduced configs card against CPU, the 100M "
               "example"):
        report["lm_train"] = lm_train_phase(torch, dev)

    # ---- 10. the mesh path ----------------------------------------------
    with Phase("the mesh path: tinyllama-1.1b at full width trains and "
               "serves on a 1x1 DeviceMesh over NCCL"):
        report["mesh"] = mesh_phase(torch, dev)

    # ---- 11. the roofline and the dry run ------------------------------
    with Phase("the roofline and the dry run: tinyllama-1.1b and "
               "mixtral-8x7b cells on a fake 16x16 group, a counted "
               "tinyllama-1.1b step on the card"):
        report["roofline"] = roofline_phase(torch, dev)

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
        # Their device time is also read with the L2 flushed before each
        # call: a repeated call would find the call before's bytes there.
        flush = l2_flush(torch, dev)
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
                       "library_ms": None,
                       "kernel_device_ms": device_ms(
                           torch, lambda: lif_kernel.lif_step_cuda(
                               *args, **kw)),
                       "kernel_device_flushed_ms": device_ms(
                           torch, lambda: lif_kernel.lif_step_cuda(
                               *args, **kw), flush=flush)}
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
                       "library_ms": None,
                       "kernel_device_ms": device_ms(
                           torch, lambda: penc_kernel.penc_compact_cuda(
                               rows, cap)),
                       "kernel_device_flushed_ms": device_ms(
                           torch, lambda: penc_kernel.penc_compact_cuda(
                               rows, cap), flush=flush)}
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
    with Phase("the conv epilogue's two kernels alone"):
        report["epilogue"] = epilogue_phase(torch, dev)

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
            "lm_serving_launches": report["lm"]["launches"][name],
            "lm_training_launches": report["lm_train"]["launches"][name],
            "mesh_path_launches": report["mesh"]["launches"][name],
            "roofline_path_launches": report["roofline"]["launches"][name],
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
