#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repo root on a machine with one CUDA card (an H100):

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and exits non-zero:

1. device  — card name and count, torch and CUDA versions, power limit;
2. build   — nvcc builds every kernel of the paths for sm_90a from the
             sources in the checkout, all at once; the -Xptxas -v report
             is printed, and a spill or "serialized" warning in a wgmma
             kernel (head dims 64, 128 and 256 of flash) fails the run;
3. kernel  — each kernel against its plain PyTorch version on the card, at
             the reference's sweep shapes and at the path's shape, timed
             with CUDA events beside the plain version and the library call
             (flash_attention on both routes, fp32 on the CUDA cores and
             bf16 on the tensor cores, with bf16 head_dim-64, -128 and -256
             cases at ragged lengths (1500 among them), GQA groups (7 and
             16 among them) and a window, gemma3-12b's serving attention
             shape, causal and with its 1024-token window, and the other
             paths' serving shapes: whisper-medium's non-causal encoder at
             1500 frames and its decoder, pixtral-12b, chatglm3-6b (group
             16), deepseek-coder-33b (group 7), dbrx-132b (group 6) and
             jamba-1.5-large-398b (64/8 heads), each beside SDPA; then
             ssd_scan on both routes, fp32 x on the CUDA cores and bf16 x on
             the tensor cores, over the sweep and at the serving shape and
             one long prompt's and at jamba's Mamba layers' (256 heads),
             where the whole ``ops.ssd_scan`` call of
             each route is timed too, and bf16 x the tensor cores cannot
             take (P 80, P 12, N 256, fp32 B/C) routed to the CUDA cores;
             then skewed_bucket, held exactly to the plain version and to
             numpy's ``bucket_of``, also at 4096 capacities and on int64
             hashes, and timed with a cold L2);
4. serve   — full-width, full-depth granite-3-8b, gemma3-12b (48 layers, 5:1
             local:global, head_dim 256) on 2048-token prompts, so its local
             layers' 1024-slot rings wrap in prefill and decode,
             granite-moe-1b-a400m (24 layers, 32 experts, top-8),
             whisper-medium (24 encoder and 24 decoder layers; 256-token
             prompts over 1500 stub audio frames: ``prefill_step(params,
             tokens, enc_feats)``, one ``encode`` per batch, then
             ``serve_step(..., enc_out)``), pixtral-12b (prompts of 1024
             stub patch embeddings through ``model.prefill``), chatglm3-6b,
             then mamba2-2.7b, with random weights from a seed, each served
             for 3 HeMT-dispatched rounds over replicas 1.0,1.0,0.4 through
             ``make_prefill_step(impl="pallas")`` and ``make_serve_step``;
             deepseek-coder-33b (62 layers, 66.7 GB of weights) serves one
             prefill of 2 x 1024 tokens and 16 decode steps and no round,
             which would not fit beside its weights; dbrx-132b at 8 of its
             40 layers (54.6 GB), then after mamba2 jamba-1.5-large-398b's
             hybrid stack at one group of 8 layers and 8 of its 16 experts
             (51.6 GB; each cut and its reason in the ``serve_init`` line).
             Every kernel's count is set to 0 just before a model's rounds
             and read just after: each kernel launched per batch as the
             layer kinds say (flash once per attention layer, whisper's
             encoder layers twice, the SSD scan once per SSM layer: jamba
             1 + 7), the bucket kernel never, all on the wgmma
             (tensor-core) routes. Then pallas against xla prefill logits on
             the same bf16 weights (granite-moe and dbrx also: the MoE sort
             dispatch against the dense oracle on the first MoE layer's
             real FFN input, in fp32 and bf16; mamba2 and jamba at 1024
             tokens and on one 8192-token prompt: the bf16 pallas logits
             held to twice the bf16 xla path's distance from the xla logits
             of the weights cast up to fp32 one layer at a time, and pallas
             vs xla under the same streaming in fp32, which runs the
             CUDA-core routes; jamba also the MoE dispatch on layer 1,
             behind an SSM mixer); between the MoE and mamba2 models, fleet serving:
             ``repro_torch.launch.serve --simulate``'s ``main()`` in this
             process for the hemt, even and oracle batching modes, p50/p99,
             attainment and goodput per mode, no kernel launched; then the
             scheduler core: ``pull_scan_torch`` in float64 on the card at
             1000 x 8 x 256 against the numpy ``pull_scan`` (1e-9, equal
             counts) with a finite makespan gradient, and Fig 7's adaptive
             sequence through the copied ``AdaptiveHeMTScheduler``, whose
             history must hash as the CPU's, no kernel launched;
5. pagerank — paper Fig 18's PageRank on a 4,847,571-vertex graph with 14
             out-edges per vertex (soc-LiveJournal1's vertex count), 100
             iterations in each of the four modes of the demo, then a
             10-iteration job, run under ``torch.profiler`` (device time by
             kernel), against a float64 numpy oracle. Counts are set
             to 0 before the phase: skewed_bucket launches once per job, the
             other kernels never. The card's ownership map must equal
             ``bucket_of`` on the host, HeMT's bucket share 1/1.4, and HeMT
             must finish first (Fig 18's ordering);
6. kmeans   — paper Fig 17's K-means on 20 M points x 8 dims, k = 8, 30
             iterations in each of the bench's four modes; every mode's
             centroids against the plain single-node K-means, HeMT must
             finish before even; 3 iterations under the profiler. No
             kernel may launch;
7. train    — HeMT-DP on full-size mamba2-2.7b (64 layers, bf16 params,
             fp32 moments, remat "full"): 3 steps of 4 grains of 8 x 1024
             tokens in each of ``hemt`` and ``static-even`` from the same
             params; finite losses and grad norms, changed params, equal
             step-0 losses, and the schedule the copied engine gives on the
             CPU; then one grain step under the profiler. No kernel may
             launch;
8. train_window — OA-HeMT on full-size mamba2-2.7b: one ``run_window`` of 4
             steps of 12 grains of 1 x 1024 tokens (``mode="oa-hemt"``)
             with a permanent crash of rep1 inside step 1 and a
             ``FleetMonitor`` that declares it dead; every step's
             schedule, the monitor's events and the surviving slices equal
             the same window's on the CPU, rep1 gets no grain after, step
             0's loss equals the plain loss over its 12 sequences within
             1e-4, the params change and losses stay finite. No kernel
             may launch;
9. checkpoint — mamba2-2.7b at full width and 4 layers: one step, then
             ``CheckpointManager`` save and save_async (the same arrays
             and digest), ``restore_latest`` into a fresh state on the
             card with every leaf equal bit for bit, and the next step from
             both within 1e-5; then ``repro_torch.launch.train``'s
             ``main()``, in this process, on the card for 4 steps and again
             to 6, which must resume from step 4. No kernel may launch;
10. serve_placed — full-width, full-depth granite-3-8b in bf16 served one
             HeMT round (replicas 1.0,1.0,0.4) from weights placed on a
             (1, 1) ("data", "model") DeviceMesh on cuda:0 under a
             one-process NCCL group: ``runtime.sharding.param_shardings``
             + ``place`` for the params, the prompts by
             ``batch_shardings``, each decode state by
             ``cache_shardings``, ``make_prefill_step(impl="pallas")`` and
             ``make_serve_step`` as users call them. On one rank every
             local shard is the whole tensor, so every token and every
             decode step's logits must equal, bit for bit, the same
             seed's round on unplaced weights run just before; flash
             launches once per layer per batch, all on wgmma, counted with
             the unplaced round's launches excluded; the group is
             destroyed at the end;
11. dryrun — ``repro_torch.launch.dryrun``'s full sweep (10 archs x 4
             shapes x the 256- and 512-rank meshes on one-process fake
             groups, meta-device inputs, CPU only), run in worker
             processes while phase 10 serves; any cell in error fails the
             run. Prints the per-device argument bytes of the train and
             prefill cells of full jamba-1.5-large-398b and dbrx-132b;
12. the ``{"kernels": [...]}`` line, the nvidia-smi line, and last
   ``{"ok": true, "device": {...}}``.

Without a card, or run where ``src/repro_torch`` is missing, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 0
# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12      # tensor cores on fp32 operands
PEAK_FP32_FLOPS = 67e12       # CUDA cores, outside the tensor cores
PEAK_HBM_BYTES = 3.35e12

KERNELS = ("flash_attention", "ssd_scan", "skewed_bucket")
ARCH = "granite-3-8b"
SSM_ARCH = "mamba2-2.7b"
REPLICAS = (1.0, 1.0, 0.4)
ROUNDS = 3
REQUESTS = 24
PROMPT_LEN = 1024
GEN_LEN = 16
MAX_LEN = PROMPT_LEN + GEN_LEN
LONG_PROMPT_LEN = 8192        # one long prompt: mamba2's xla side scans chunks there
# gemma3-12b serves prompts of twice its 1024-token window, so the 40 local
# layers' 1024-slot rings wrap in prefill and again in decode, and the
# window mask cuts every row past the first 1024
GEMMA_ARCH = "gemma3-12b"
GEMMA_PROMPT_LEN = 2048
MOE_ARCH = "granite-moe-1b-a400m"
# the MoE sort dispatch against moe_apply_dense_fallback on the first MoE
# layer's real FFN input for MOE_CHECK_BATCH prompts, with the least
# capacity factor that drops no pair: in fp32 the two differ in summation
# order only; in bf16 the dispatch rounds each of a token's top-k weighted
# expert rows and their sum to bf16 (as the reference), the oracle sums
# them in fp32
MOE_CHECK_BATCH = 2
MOE_FP32_REL_TOL = 1e-5
MOE_BF16_REL_TOL = 2e-2
# fleet serving: launch/serve.py's docstring example, every batching mode
FLEET_ARGV = ("--simulate", "--replicas", "2.0,1.5,1.0,0.5", "--trace", "poisson",
              "--rate", "2.5", "--horizon", "120", "--window", "2", "--slo", "4")
FLEET_MODES = ("hemt", "even", "oracle")
BASE_TOKEN_RATE = 100.0       # virtual decode tokens/s of a speed-1.0 replica
# whisper-medium: 256-token decoder prompts (its max_seq_len is 448) over
# max_source_positions (1500) stub audio frames of 128 features; the
# encoder runs non-causal through the flash kernel at Sk 1500 = 11 x 128 + 92
WHISPER_ARCH = "whisper-medium"
WHISPER_PROMPT_LEN = 256
# pixtral-12b: prompts of 1024 stub patch embeddings (1024 features) through
# the vision adapter; decode runs on tokens
PIXTRAL_ARCH = "pixtral-12b"
CHATGLM_ARCH = "chatglm3-6b"        # GQA group 16, half rope
# deepseek-coder-33b: 66.7 GB of bf16 weights leave no room for a HeMT
# round's replica batches, so one prefill of 2 x 1024 tokens and GEN_LEN
# decode steps
DEEPSEEK_ARCH = "deepseek-coder-33b"
DEEPSEEK_BATCH = 2
# dbrx-132b at full width: 8 of its 40 layers (27.31 B parameters, 54.6 GB
# of bf16; all 40 would be 263 GB), 48/8 heads (GQA group 6), 16 experts
# of d_ff 10752, top-4, in every layer
DBRX_ARCH = "dbrx-132b"
DBRX_LAYERS = 8
# jamba-1.5-large-398b at full width: one group of 8 layers (attention at
# index 4, Mamba2 at the other 7, MoE at the odd ones), the least the
# reference stacks; at its 16 experts that group alone is 45.1 B
# parameters, 90.3 GB of bf16, more than the card holds, so the expert
# pool is cut to 8 with top-2 kept: every width, every layer kind and each
# token's work stay (25.82 B parameters, 51.6 GB)
JAMBA_ARCH = "jamba-1.5-large-398b"
JAMBA_LAYERS = 8
JAMBA_EXPERTS = 8
# the scheduler core: pull_scan_torch at benchmarks/bench_batched.py's sizes
# (rows, nodes, tasks) in float64 against the numpy scan, as
# tests/test_batched.py holds the JAX twin
SCAN_SHAPE = (1000, 8, 256)
SCAN_TOL = 1e-9
# paper Fig 7 through the copied AdaptiveHeMTScheduler: node b slows from
# 1.0 to 0.3 at job 10 of 20 (tests/test_simulator_scheduler.py); the
# sha256 of its history's JSON as the CPU gives it
FIG7_JOBS = 20
FIG7_WORK = 130.0
FIG7_SHA256 = "1356d26421d4f206be8b0d13b2272dafcabe2b63a5d4a57845b03dd99d11b386"

# the reference sweep (tests/test_kernels.py) and the serving shape
SWEEP_SHAPES = [(1, 2, 2, 64, 64, 16), (2, 4, 2, 96, 96, 32),
                (1, 8, 1, 128, 256, 64), (1, 2, 2, 33, 65, 16),
                (1, 4, 2, 130, 130, 256)]    # head_dim 256 on both routes
SWEEP_MASKS = [(True, 0), (True, 24), (False, 0)]
SERVE_SHAPE = (10, 32, 8, 1024, 128)    # B, Hq, Hkv, S, D: the largest share
# bf16 at the serving head_dim, model layout: ragged lengths around the
# 128-row tiles, GQA groups 1, 4 and 8 (Hq 8), causal, causal + window, full
WGMMA_LENGTHS = (1, 127, 129, 1000)
# chatglm3's, deepseek's and dbrx's groups (16, 7, 6)
WGMMA_HEADS = ((8, 8), (8, 2), (8, 1), (16, 1), (7, 1), (6, 1))
# bf16 at whisper-medium's head_dim 64, MHA: its encoder's 1500 frames
# (a ragged 92-key last tile) among the ragged lengths
WGMMA_64_LENGTHS = (1, 127, 129, 1500)
WGMMA_64_HEADS = ((4, 4),)
WGMMA_MASKS = ((True, 0), (True, 100), (False, 0))
# bf16 at head_dim 256 (64-key tiles): ragged lengths around them
WGMMA_256_LENGTHS = (1, 63, 65, 129, 1000)
WGMMA_256_HEADS = ((4, 4), (4, 1))
# gemma3-12b's attention (src/repro/configs/gemma3_12b.py: 16 query heads,
# 8 kv heads, head_dim 256; local layers slide a 1024-token window) at its
# serving shape: the largest replica batch of 2048-token prompts, model layout
GEMMA_SHAPE = (10, 16, 8, 2048, 256)
GEMMA_MASKS = (("causal", True, 0), ("window 1024", True, 1024))
# the new serving paths' attention at their serving shapes (the largest
# replica batch; deepseek's one batch): name, (B, Hq, Hkv, S, D), causal
PATH_SHAPES = (("whisper-medium encoder", (10, 16, 16, 1500, 64), False),
               ("whisper-medium decoder", (10, 16, 16, WHISPER_PROMPT_LEN, 64), True),
               ("pixtral-12b", (10, 32, 8, PROMPT_LEN, 128), True),
               ("chatglm3-6b", (10, 32, 2, PROMPT_LEN, 128), True),
               ("deepseek-coder-33b", (DEEPSEEK_BATCH, 56, 8, PROMPT_LEN, 128), True),
               ("dbrx-132b", (10, 48, 8, PROMPT_LEN, 128), True),
               ("jamba-1.5-large-398b", (10, 64, 8, PROMPT_LEN, 128), True))
HEAD_DIMS = (16, 32, 64, 128, 256)
SMEM_LIMIT = 232_448               # dynamic shared memory a block may use
# kernel vs plain version, both fp32 inside: bf16 output rounding dominates
ATOL = {"float32": 2e-5, "bfloat16": 2e-2}
RTOL = 1e-2
# pallas vs xla prefill logits, relative L2 over the real vocab: the xla
# path rounds probabilities to bf16 before PV, the kernel keeps them fp32;
# a 40-layer bf16 CPU probe at reduced width showed 2.0e-2
PREFILL_REL_TOL = 5e-2

# ssd_scan: (batch, S, H, P, G, N); the reference sweep's shapes
# (tests/test_kernels.py), then B/C in bf16 over G in {1, 2, 4}, the
# serving head and state sizes at a ragged S, and 640 (batch, head) items at
# a short S: more than twice the wgmma route's 2 x 132 consumer slots on an
# H100, so every consumer warpgroup runs several items and frees a stage
# across an item boundary
SSD_SWEEP = [((1, 64, 2, 16, 1, 8), "float32"), ((2, 96, 4, 8, 2, 16), "float32"),
             ((1, 50, 4, 16, 4, 8), "float32")]
SSD_SWEEP += [((2, 96, 8, 16, g, 16), "bfloat16") for g in (1, 2, 4)]
SSD_SWEEP += [((2, 200, 8, 64, g, 128), "bfloat16") for g in (1, 4)]
SSD_SWEEP += [((8, 130, 80, 64, 1, 128), "bfloat16")]
# bf16 x the tensor-core route cannot take (P 80 and P 12, N 256, B/C in
# fp32): routed to the CUDA cores before the launch and held there
SSD_NARROW = [("P 80", (2, 200, 8, 80, 1, 64), "bfloat16"),
              ("N 256", (2, 200, 8, 64, 1, 256), "bfloat16"),
              ("P 12", (2, 200, 8, 12, 1, 16), "bfloat16"),
              ("fp32 B/C", (2, 200, 8, 64, 1, 128), "float32")]
SSD_SERVE_SHAPE = (10, 1024, 80, 64, 1, 128)   # the largest share's prefill
SSD_LONG_SHAPE = (1, 8192, 80, 64, 1, 128)     # one long prompt
# jamba's Mamba layers at the largest share's prefill: 256 heads of 64
# (d_inner 16384), state 128, one group
JAMBA_SSD_SHAPE = (10, 1024, 256, 64, 1, 128)
# the reference sweep's tolerance: chunked against sequential sums in fp32
SSD_ATOL = 2e-3
SSD_NO_LIBRARY = "no single PyTorch call computes a chunked SSD scan"
# mamba2 pallas vs xla prefill logits: checked on an fp32 copy of the same
# random weights (the bf16 weights cast up exactly), where the two paths
# differ only in summation order. In bf16 the paths round y at different
# places and random weights amplify that with depth, as much in the JAX
# package's own two paths
# (tests/test_torch_ssm.py::test_bf16_path_gap_is_the_references_own). So
# the served bf16 pallas logits are held to the reference path's own bf16
# spread on the same weights: rel L2 to the fp32 xla logits at most
# SSM_BF16_SPREAD times that of the bf16 xla logits.
SSM_PREFILL_REL_TOL = 5e-2
SSM_BF16_SPREAD = 2.0

# skewed_bucket: the reference sweep (tests/test_kernels.py) at its
# resolution, and the path's shape: PageRank's vertex ownership
BUCKET_WEIGHTS = [[1.0, 0.4], [1.0, 1.0, 1.0], [3, 4, 4], [0.5, 0.3, 0.1, 0.1]]
BUCKET_LENGTHS = [17, 1024, 5000]
BUCKET_RESOLUTION = 997
BUCKET_LIBRARY = ("torch.bucketize(torch.remainder(h, total), cum, right=True, "
                  "out_int32=True)")
L2_SCRUB_BYTES = 128 << 20     # written between timed calls: > the 50 MB L2
# more capacities than one 1024-entry shared-memory tile of the kernel
# (some zero), and int64 hashes past the int32 range, which wrap to int32
# as the reference's astype(jnp.int32) does
BUCKET_WIDE_E = 4096
BUCKET_INT64_SPAN = 1 << 40

# PageRank (paper Fig 18) at soc-LiveJournal1's vertex count (SNAP: 4,847,571
# vertices, 68,993,773 edges) with uniform random out-edges, 14 per vertex
PR_VERTICES = 4_847_571
PR_AVG_DEG = 14
PR_ITERS = 100
PR_CHECK_ITERS = 10
PR_MODES = (("hemt", {"weights": [1.0, 0.4]}), ("even", {}),
            ("homt-16", {"n_tasks": 16}), ("homt-64", {"n_tasks": 64}))
PR_SPEEDS = (("full-core", 1.0), ("0.4-core", 0.4))
PR_OVERHEAD = 0.15
PR_OWNER_RESOLUTION = 1 << 12
# float32 ranks (atomic sums on the card) against the float64 oracle: the
# CPU port measures 1.4e-7 at 500 vertices and 1.7e-7 at 200,000, flat in n
# (tests/test_torch_pagerank.py::test_pagerank_accepts_tensors_and_matches_float64_oracle)
PR_REL_L2_TOL = 1e-5
PR_SHARE_TOL = 0.02            # tests/test_workloads.py: hemt share vs 1/1.4
PR_SUM_TOL = 0.2               # tests/test_workloads.py: ranks sum to ~1

# K-means (paper Fig 17) at 20 M points x 8 dims in fp32 (640 MB on the
# card), k = 8, 30 iterations, with the bench's two executors and modes
# (benchmarks/bench_fig17_kmeans.py); work_per_point scales the bench's
# 2e-3 s per point at 2,000 points, so an iteration carries its virtual work
KM_POINTS = 20_000_000
KM_DIM = 8
KM_K = 8
KM_ITERS = 30
KM_SPEEDS = (("a", 1.0), ("b", 0.4))
KM_OVERHEAD = 0.2
KM_WORK_PER_POINT = 2e-3 * 2000 / KM_POINTS
KM_MODES = (("hemt", {"weights": [1.0, 0.4]}), ("even", {}),
            ("homt-8", {"n_tasks": 8}), ("homt-32", {"n_tasks": 32}))
# the issue's bound on every mode's centroids against the plain version
KM_ATOL = 1e-4
KM_PROFILE_ITERS = 3

# HeMT-DP training of full-size mamba2-2.7b (64 layers, d_model 2560): bf16
# params from seed 0, fp32 moments, its own remat="full"; three slices as
# in serving, 4 grains of 8 x 1024 tokens a step
TRAIN_ARCH = SSM_ARCH
TRAIN_SLICES = (("rep0", 1.0), ("rep1", 1.0), ("rep2", 0.4))
TRAIN_GRAIN_BATCH = 8
TRAIN_GLOBAL_BATCH = 32
TRAIN_SEQ = 1024
TRAIN_STEPS = 3
TRAIN_MODES = ("hemt", "static-even")
TRAIN_LOSS_RTOL = 1e-3         # step 0's loss across modes: same params, same grains
# OA-HeMT windowed training: one run_window of WINDOW_STEPS steps of 12
# grains of 1 x 1024 tokens over TRAIN_SLICES, with rep1 crashed for good
# at a virtual time inside step 1 and a fleet monitor that declares it dead
# at the next barrier. The crash time and the timeout were read off a CPU
# rehearsal with the reduced model: the window's barriers fall at 10.05,
# 20.15, 29.2 and 38.25 virtual seconds, and rep1's last heartbeat is at
# 10.05, so it is declared dead at 20.15 (10.1 s > 4.0 s).
WINDOW_GRAIN_BATCH = 1
WINDOW_GLOBAL_BATCH = 12
WINDOW_STEPS = 4
WINDOW_GRAIN_COST = 1.0
WINDOW_CRASH = ("rep1", 12.0)
WINDOW_TIMEOUT = 4.0
# the CPU rehearsal's sequence length: the schedule is the host's arithmetic
# on grain counts and speeds, whatever a grain holds
WINDOW_REHEARSAL_SEQ = 16
# step 0's loss against the plain loss_fn over its 12 sequences from the
# same params: the same bf16 forward, only the fold's order of summing
# differs; a dropped grain moves the mean by a twelfth
WINDOW_LOSS_RTOL = 1e-4
# checkpoints: mamba2-2.7b at full width and 4 layers, one hemt step of 4
# grains of 1 x 1024 tokens, then save, save_async and restore; the CLI's
# main(), in this process, trains its reduced config on the card for 4
# steps, then resumes to 6
CKPT_LAYERS = 4
CKPT_GLOBAL_BATCH = 4
CKPT_LOSS_RTOL = 1e-5
CLI_STEPS = (4, 6)
CLI_CKPT_EVERY = 2

# dryrun: the sweep's records, and the cells whose per-device bytes are printed
DRYRUN_OUT = ROOT / "artifacts" / "dryrun_torch"
DRYRUN_WORKERS = 6
DRYRUN_CELLS = 80                  # 10 archs x 4 shapes x 2 meshes
DRYRUN_BYTES = (("jamba-1.5-large-398b", "train_4k"), ("jamba-1.5-large-398b", "prefill_32k"),
                ("dbrx-132b", "train_4k"), ("dbrx-132b", "prefill_32k"))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def cuda_ms_cold(torch, fn, iters: int, scrub) -> float:
    """Mean device time of ``fn`` with the L2 cache scrubbed before each call
    (the scrub is outside the timed window)."""
    fn()
    pairs = []
    for _ in range(iters):
        scrub.add_(1)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def visible_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask leaves visible: the work this input needs."""
    import numpy as np
    r = np.arange(sq)
    hi = np.minimum(r, sk - 1) if causal else np.full(sq, sk - 1)
    lo = np.maximum(r - window + 1, 0) if window > 0 else np.zeros(sq, np.int64)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def ptxas_entries(log: str, entry: str) -> list:
    """Registers, spill bytes and warnings that ``ptxas -v`` reports for each
    instantiation of the kernel whose (mangled) name contains ``entry``."""
    out, cur = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            cur = {"entry": ln.split("'")[1], "warnings": []} if entry in ln else None
            if cur is not None:
                out.append(cur)
        elif cur is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
            if m:
                cur["spill_bytes"] = int(m.group(1)) + int(m.group(2))
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                cur["registers"] = int(m.group(1))
            if "arning" in ln:
                cur["warnings"].append(ln.strip())
    return out


def check_close(torch, got, want, atol: float, rtol: float, what: str) -> float:
    diff = (got.float() - want.float()).abs()
    bad = diff > atol + rtol * want.float().abs()
    if bool(bad.any()):
        raise AssertionError(f"{what}: {int(bad.sum())} elements out of tolerance, "
                             f"max abs err {float(diff.max())}")
    return float(diff.max())


def phase_flash_kernel(torch, F, ops, fa, ref):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def run_case(q, k, v, causal, window, name, what):
        route = fa.route_for(q.dtype)
        before = dict(fa.launches_by_route)
        got = fa.flash_attention(q, k, v, causal=causal, window=window)
        if fa.launches_by_route != {**before, route: before[route] + 1}:
            raise AssertionError(f"{what}: not launched once on the {route} route")
        want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        return route, check_close(torch, got, want, ATOL[name], RTOL, what)

    errs = {"simt": 0.0, "wgmma": 0.0}
    cases = {"simt": 0, "wgmma": 0}
    for (b, hq, hkv, sq, sk, d) in SWEEP_SHAPES:
        for causal, window in SWEEP_MASKS:
            for name, dt in dtypes.items():
                q, k, v = (randn((b, hq, sq, d), dt), randn((b, hkv, sk, d), dt),
                           randn((b, hkv, sk, d), dt))
                route, err = run_case(q, k, v, causal, window, name,
                                      f"sweep {(b, hq, hkv, sq, sk, d)} "
                                      f"causal={causal} window={window} {name}")
                errs[route] = max(errs[route], err)
                cases[route] += 1
    torch.cuda.synchronize()
    emit({"phase": "kernel_sweep", "kernel": "flash_attention", "cases": cases,
          "max_abs_err": errs, "atol": ATOL, "rtol": RTOL})

    wg_err, wg_cases = 0.0, 0
    for s in WGMMA_LENGTHS:
        for hq, hkv in WGMMA_HEADS:
            for causal, window in WGMMA_MASKS:
                q, k, v = (randn((2, s, h, 128), torch.bfloat16).transpose(1, 2)
                           for h in (hq, hkv, hkv))
                _, err = run_case(q, k, v, causal, window, "bfloat16",
                                  f"head_dim 128 sq=sk={s} heads {hq}/{hkv} "
                                  f"causal={causal} window={window}")
                wg_err = max(wg_err, err)
                wg_cases += 1
    torch.cuda.synchronize()
    emit({"phase": "kernel_sweep", "kernel": "flash_attention", "route": "wgmma",
          "head_dim": 128, "lengths": WGMMA_LENGTHS, "heads": WGMMA_HEADS,
          "masks": WGMMA_MASKS, "layout": "(B, S, H, D) viewed head-major",
          "cases": wg_cases, "max_abs_err": wg_err, "atol": ATOL["bfloat16"], "rtol": RTOL})

    wg_err, wg_cases = 0.0, 0
    for s in WGMMA_256_LENGTHS:
        for hq, hkv in WGMMA_256_HEADS:
            for causal, window in WGMMA_MASKS:
                q, k, v = (randn((2, s, h, 256), torch.bfloat16).transpose(1, 2)
                           for h in (hq, hkv, hkv))
                _, err = run_case(q, k, v, causal, window, "bfloat16",
                                  f"head_dim 256 sq=sk={s} heads {hq}/{hkv} "
                                  f"causal={causal} window={window}")
                wg_err = max(wg_err, err)
                wg_cases += 1
    torch.cuda.synchronize()
    emit({"phase": "kernel_sweep", "kernel": "flash_attention", "route": "wgmma",
          "head_dim": 256, "block_k": fa.wgmma_block_k(256), "lengths": WGMMA_256_LENGTHS,
          "heads": WGMMA_256_HEADS, "masks": WGMMA_MASKS,
          "layout": "(B, S, H, D) viewed head-major",
          "cases": wg_cases, "max_abs_err": wg_err, "atol": ATOL["bfloat16"], "rtol": RTOL})

    wg_err, wg_cases = 0.0, 0
    for s in WGMMA_64_LENGTHS:
        for hq, hkv in WGMMA_64_HEADS:
            for causal, window in WGMMA_MASKS:
                q, k, v = (randn((2, s, h, 64), torch.bfloat16).transpose(1, 2)
                           for h in (hq, hkv, hkv))
                _, err = run_case(q, k, v, causal, window, "bfloat16",
                                  f"head_dim 64 sq=sk={s} heads {hq}/{hkv} "
                                  f"causal={causal} window={window}")
                wg_err = max(wg_err, err)
                wg_cases += 1
    torch.cuda.synchronize()
    emit({"phase": "kernel_sweep", "kernel": "flash_attention", "route": "wgmma",
          "head_dim": 64, "lengths": WGMMA_64_LENGTHS, "heads": WGMMA_64_HEADS,
          "masks": WGMMA_MASKS, "layout": "(B, S, H, D) viewed head-major",
          "cases": wg_cases, "max_abs_err": wg_err, "atol": ATOL["bfloat16"], "rtol": RTOL})

    # the serving shape, in model layout as the prefill calls it
    b, hq, hkv, s, d = SERVE_SHAPE
    q = randn((b, s, hq, d), torch.bfloat16)
    k = randn((b, s, hkv, d), torch.bfloat16)
    v = randn((b, s, hkv, d), torch.bfloat16)
    scale = d ** -0.5
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    got = ops.flash_attention(q, k, v, causal=True, scale=scale)
    want = ref.flash_attention_ref(qt, kt, vt, causal=True, scale=scale).transpose(1, 2)
    err = check_close(torch, got, want, ATOL["bfloat16"], RTOL, "serving shape")
    del got, want

    ms = cuda_ms(torch, lambda: ops.flash_attention(q, k, v, causal=True, scale=scale),
                 iters=20)
    plain_ms = cuda_ms(torch, lambda: ref.flash_attention_ref(qt, kt, vt, causal=True,
                                                              scale=scale),
                       iters=5, warmup=1)
    library_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, scale=scale, enable_gqa=True), iters=20)

    pairs = visible_pairs(s, s, True, 0)
    flops = 4 * d * pairs * b * hq                       # QK^T and PV
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())  # bf16 in + out
    flops_ms = flops / PEAK_BF16_FLOPS * 1e3
    bytes_ms = nbytes / PEAK_HBM_BYTES * 1e3
    bound_ms = max(flops_ms, bytes_ms)
    row = {"name": "flash_attention", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
           "replaces": "src/repro/kernels/flash_attention.py:90",
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms,
           "bound_by": "operations" if flops_ms >= bytes_ms else "bytes",
           "library_ms": library_ms}
    emit({"phase": "kernel_serving_shape", "shape": {"q": [b, s, hq, d],
                                                      "kv": [b, s, hkv, d]},
          "dtype": "bfloat16", "kernel_route": fa.route_for(q.dtype), "causal": True,
          "flops": flops, "bytes": nbytes,
          "flops_bound_ms": flops_ms, "bytes_bound_ms": bytes_ms,
          "fp32_core_bound_ms": flops / PEAK_FP32_FLOPS * 1e3,
          "achieved_tflops": flops / (ms * 1e-3) / 1e12,
          "roofline_share": bound_ms / ms, **row})
    del q, k, v, qt, kt, vt
    phase_flash_gemma(torch, F, ops, fa, ref, randn)
    for name, shape, causal in PATH_SHAPES:
        flash_shape_line(torch, F, ops, fa, ref, randn, name, shape, causal)
    return row


def phase_flash_gemma(torch, F, ops, fa, ref, randn):
    """gemma3-12b's attention shape (head_dim 256) on the wgmma route,
    causal and with its local layers' 1024-token window: held against the
    plain version, timed beside it, SDPA and the bound."""
    b, hq, hkv, s, d = GEMMA_SHAPE
    q = randn((b, s, hq, d), torch.bfloat16)
    k = randn((b, s, hkv, d), torch.bfloat16)
    v = randn((b, s, hkv, d), torch.bfloat16)
    scale = d ** -0.5
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    pos = torch.arange(s, device=q.device)
    for name, causal, window in GEMMA_MASKS:
        before = dict(fa.launches_by_route)
        got = ops.flash_attention(q, k, v, causal=causal, window=window, scale=scale)
        if fa.launches_by_route != {**before, "wgmma": before["wgmma"] + 1}:
            raise AssertionError(f"gemma3 shape {name}: not launched once on wgmma")
        want = ref.flash_attention_ref(qt, kt, vt, causal=causal, window=window,
                                       scale=scale).transpose(1, 2)
        err = check_close(torch, got, want, ATOL["bfloat16"], RTOL, f"gemma3 shape {name}")
        del got, want
        ms = cuda_ms(torch, lambda: ops.flash_attention(q, k, v, causal=causal,
                                                        window=window, scale=scale), iters=20)
        plain_ms = cuda_ms(torch, lambda: ref.flash_attention_ref(
            qt, kt, vt, causal=causal, window=window, scale=scale), iters=3, warmup=1)
        # SDPA: its causal flag, or the window as a boolean mask (the flag
        # has no window)
        if window > 0:
            rel = pos[:, None] - pos[None, :]
            sdpa_kw = {"attn_mask": (rel >= 0) & (rel < window)}
        else:
            sdpa_kw = {"is_causal": True}
        library_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, scale=scale, enable_gqa=True, **sdpa_kw), iters=20)
        flops = 4 * d * visible_pairs(s, s, causal, window) * b * hq
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
        flops_ms = flops / PEAK_BF16_FLOPS * 1e3
        bytes_ms = nbytes / PEAK_HBM_BYTES * 1e3
        bound_ms = max(flops_ms, bytes_ms)
        emit({"phase": "kernel_gemma3_shape", "kernel": "flash_attention", "mask": name,
              "shape": {"q": [b, s, hq, d], "kv": [b, s, hkv, d]}, "dtype": "bfloat16",
              "kernel_route": fa.route_for(q.dtype), "block_k": fa.wgmma_block_k(d),
              "max_abs_err": err, "atol": ATOL["bfloat16"], "rtol": RTOL,
              "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
              "library": "scaled_dot_product_attention, " + next(iter(sdpa_kw)),
              "flops": flops, "bytes": nbytes, "bound_ms": bound_ms,
              "bound_by": "operations" if flops_ms >= bytes_ms else "bytes",
              "achieved_tflops": flops / (ms * 1e-3) / 1e12,
              "roofline_share": bound_ms / ms, "launches": 1})


def flash_shape_line(torch, F, ops, fa, ref, randn, name, shape, causal):
    """The flash kernel at one serving path's attention shape, in model
    layout, on the wgmma route: held against the plain version, timed beside
    it and SDPA (its causal flag as the path's), with the bound of the
    visible pairs' products."""
    b, hq, hkv, s, d = shape
    q = randn((b, s, hq, d), torch.bfloat16)
    k = randn((b, s, hkv, d), torch.bfloat16)
    v = randn((b, s, hkv, d), torch.bfloat16)
    scale = d ** -0.5
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    before = dict(fa.launches_by_route)
    got = ops.flash_attention(q, k, v, causal=causal, scale=scale)
    if fa.launches_by_route != {**before, "wgmma": before["wgmma"] + 1}:
        raise AssertionError(f"{name} shape: not launched once on wgmma")
    want = ref.flash_attention_ref(qt, kt, vt, causal=causal, scale=scale).transpose(1, 2)
    err = check_close(torch, got, want, ATOL["bfloat16"], RTOL, f"{name} shape")
    del got, want
    ms = cuda_ms(torch, lambda: ops.flash_attention(q, k, v, causal=causal, scale=scale),
                 iters=20)
    plain_ms = cuda_ms(torch, lambda: ref.flash_attention_ref(qt, kt, vt, causal=causal,
                                                              scale=scale),
                       iters=3, warmup=1)
    library_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, scale=scale, enable_gqa=True), iters=20)
    flops = 4 * d * visible_pairs(s, s, causal, 0) * b * hq
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    flops_ms = flops / PEAK_BF16_FLOPS * 1e3
    bytes_ms = nbytes / PEAK_HBM_BYTES * 1e3
    bound_ms = max(flops_ms, bytes_ms)
    emit({"phase": "kernel_path_shape", "kernel": "flash_attention", "path": name,
          "shape": {"q": [b, s, hq, d], "kv": [b, s, hkv, d]}, "dtype": "bfloat16",
          "causal": causal, "group": hq // hkv, "kernel_route": fa.route_for(q.dtype),
          "kv_tiles_per_row": len(fa.kv_tile_range(0, s, False, 0,
                                                   block_k=fa.wgmma_block_k(d))),
          "max_abs_err": err, "atol": ATOL["bfloat16"], "rtol": RTOL,
          "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
          "library": "scaled_dot_product_attention, is_causal=" + str(causal),
          "flops": flops, "bytes": nbytes, "bound_ms": bound_ms,
          "bound_by": "operations" if flops_ms >= bytes_ms else "bytes",
          "achieved_tflops": flops / (ms * 1e-3) / 1e12,
          "roofline_share": bound_ms / ms, "launches": 1})


def ssd_inputs(torch, gen, shape, bc_dtype, with_init, a_max):
    """x, dt, a_log, B, C, init on the card, scaled as the reference sweep
    draws them; x and B/C in ``bc_dtype``."""
    bsz, s, h, p, g, n = shape
    dev = torch.device("cuda")

    def randn(*size):
        return torch.randn(size, generator=gen, device=dev)

    x = (randn(bsz, s, h, p) * 0.5).to(bc_dtype)
    dt = torch.nn.functional.softplus(randn(bsz, s, h))
    a_log = torch.log(torch.linspace(1.0, a_max, h, device=dev))
    B = (randn(bsz, s, g, n) * 0.3).to(bc_dtype)
    C = (randn(bsz, s, g, n) * 0.3).to(bc_dtype)
    init = randn(bsz, h, p, n) * 0.1 if with_init else None
    return x, dt, a_log, B, C, init


def ssd_plan(ssd, route, shape):
    bsz, _, h, p, _, n = shape
    return ssd.plan(route, bsz, h, p, n)


def ssd_work(shape, chunk):
    """Operations one call needs at ``shape`` (the causal half of the
    intra-chunk products at the kernels' chunk length and the state
    products), the operations the wgmma route issues (its seven dense
    64 x 64-row products a chunk), and the bytes of the whole
    ``ops.ssd_scan`` call on each route, each input read and each output
    written once: on the wgmma route x and y in bf16, dt and the state in
    fp32; on the simt route xdt and y in fp32 and dta in fp32, the
    wrapper's x, dt and y casts not counted."""
    bsz, s, h, p, g, n = shape
    nc = -(-s // chunk)
    per_chunk = chunk * (chunk + 1) // 2 * (n + p) * 2 + 2 * chunk * p * n * 2
    flops = bsz * h * nc * per_chunk
    issued = bsz * h * nc * 2 * chunk * (chunk * n + 2 * chunk * n + 2 * chunk * p + 2 * p * n)
    bc = 2 * bsz * s * g * n * 2                # B, C in bf16
    state = 4 * bsz * h * p * n                 # final state
    wgmma_bytes = 2 * bsz * s * h * p * 2 + 4 * bsz * s * h + bc + state
    simt_bytes = 4 * bsz * s * h * p * 2 + 4 * bsz * s * h + bc + state
    return flops, issued, wgmma_bytes, simt_bytes


def phase_ssd_kernel(torch, ops, ssd, ref):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 2)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def launched_once(route, before, what):
        if ssd.launches_by_route != {**before, route: before[route] + 1}:
            raise AssertionError(f"{what}: not launched once on the {route} route")

    # the simt route: fp32 x, B/C as the sweep gives them
    err, cases = 0.0, 0
    for shape, bc_name in SSD_SWEEP:
        for with_init in (False, True):
            x, dt, a_log, B, C, init = ssd_inputs(torch, gen, shape, dtypes[bc_name],
                                                  with_init, 8.0)
            x = x.float()
            what = f"ssd simt sweep {shape} B/C {bc_name} init={with_init}"
            before = dict(ssd.launches_by_route)
            got_y, got_f = ops.ssd_scan(x, dt, a_log, B, C, chunk=16, init_state=init)
            launched_once("simt", before, what)
            want_y, want_f = ref.ssd_scan_ref(x, dt, a_log, B, C, init_state=init)
            err = max(err, check_close(torch, got_y, want_y, SSD_ATOL, 0.0, what + " y"),
                      check_close(torch, got_f, want_f, SSD_ATOL, 0.0, what + " state"))
            cases += 1
    torch.cuda.synchronize()
    emit({"phase": "kernel_sweep", "kernel": "ssd_scan", "route": "simt", "cases": cases,
          "max_abs_err": err, "atol": SSD_ATOL})

    # the wgmma route: the same shapes with x, B and C in bf16; y in fp32 and
    # the state against the plain version at the sweep's tolerance, y in bf16
    # (the model's call) against the plain y rounded to bf16
    err, err16, cases = 0.0, 0.0, 0
    for shape, _ in SSD_SWEEP:
        for with_init in (False, True):
            x, dt, a_log, B, C, init = ssd_inputs(torch, gen, shape, torch.bfloat16,
                                                  with_init, 8.0)
            what = f"ssd wgmma sweep {shape} init={with_init}"
            before = dict(ssd.launches_by_route)
            y32, f32 = ssd.ssd_scan(x, dt, a_log, B, C, init_state=init,
                                    y_dtype=torch.float32)
            launched_once("wgmma", before, what)
            before = dict(ssd.launches_by_route)
            y16, f16 = ops.ssd_scan(x, dt, a_log, B, C, chunk=16, init_state=init)
            launched_once("wgmma", before, what)
            want_y, want_f = ref.ssd_scan_ref(x.float(), dt, a_log, B, C, init_state=init)
            err = max(err, check_close(torch, y32, want_y, SSD_ATOL, 0.0, what + " y"),
                      check_close(torch, f32, want_f, SSD_ATOL, 0.0, what + " state"),
                      check_close(torch, f16, want_f, SSD_ATOL, 0.0, what + " state (bf16 y)"))
            if y16.dtype != torch.bfloat16:
                raise AssertionError(f"{what}: y is {y16.dtype}, not x's bfloat16")
            err16 = max(err16, check_close(torch, y16, want_y.bfloat16(), ATOL["bfloat16"],
                                           RTOL, what + " bf16 y"))
            cases += 1
    torch.cuda.synchronize()
    emit({"phase": "kernel_sweep", "kernel": "ssd_scan", "route": "wgmma", "cases": cases,
          "max_abs_err": err, "atol": SSD_ATOL, "max_abs_err_bf16_y": err16,
          "atol_bf16_y": ATOL["bfloat16"], "rtol_bf16_y": RTOL})

    # bf16 x that the tensor-core route cannot take: route_for sends it to
    # the CUDA cores, held at the fp32 route's tolerance
    for name, shape, bc_name in SSD_NARROW:
        err, ms = 0.0, 0.0
        for with_init in (False, True):
            x, dt, a_log, B, C, init = ssd_inputs(torch, gen, shape, torch.bfloat16,
                                                  with_init, 8.0)
            B, C = B.to(dtypes[bc_name]), C.to(dtypes[bc_name])
            what = f"ssd narrow {name} {shape} B/C {bc_name} init={with_init}"
            route = ssd.route_for(x, dt, a_log, B, C)
            if route != "simt":
                raise AssertionError(f"{what}: routed to {route}, want simt")
            before = dict(ssd.launches_by_route)
            got_y, got_f = ssd.ssd_scan(x, dt, a_log, B, C, init_state=init,
                                        y_dtype=torch.float32)
            launched_once("simt", before, what)
            want_y, want_f = ref.ssd_scan_ref(x.float(), dt, a_log, B, C, init_state=init)
            err = max(err, check_close(torch, got_y, want_y, SSD_ATOL, 0.0, what + " y"),
                      check_close(torch, got_f, want_f, SSD_ATOL, 0.0, what + " state"))
            ms = cuda_ms(torch, lambda: ops.ssd_scan(x, dt, a_log, B, C, init_state=init),
                         iters=5)
        emit({"phase": "kernel_narrow", "kernel": "ssd_scan", "case": name,
              "shape": {"x": list(shape[:4]), "B": [*shape[:2], *shape[4:]]},
              "x_dtype": "bfloat16", "bc_dtype": bc_name, "route": "simt",
              "why_not_wgmma": ssd.wgmma_layout_error(x, dt, a_log, B, C),
              "cases": 2, "max_abs_err": err, "atol": SSD_ATOL, "op_ms": ms})

    # the serving shape and one long prompt, as the model calls the kernel:
    # x and B/C in bf16, a_log = log(linspace(1, 16, H)); the fp32 y and the
    # state against the fp32 plain version on the same values, and the call
    # timed as op_ms (bf16 y, the mode the model runs) against the plain y
    # rounded to bf16 and the plain state
    rows = {}
    for name, shape in (("serving", SSD_SERVE_SHAPE), ("long", SSD_LONG_SHAPE),
                        ("jamba_serving", JAMBA_SSD_SHAPE)):
        bsz, s, h, p, g, n = shape
        x, dt, a_log, B, C, _ = ssd_inputs(torch, gen, shape, torch.bfloat16, False, 16.0)
        want_y, want_f = ref.ssd_scan_ref(x.float(), dt, a_log, B, C)
        before = dict(ssd.launches_by_route)
        got_y, got_f = ssd.ssd_scan(x, dt, a_log, B, C, y_dtype=torch.float32)
        launched_once("wgmma", before, f"ssd {name} fp32 y")
        err = max(check_close(torch, got_y, want_y, SSD_ATOL, 0.0, f"ssd {name} y"),
                  check_close(torch, got_f, want_f, SSD_ATOL, 0.0, f"ssd {name} state"))
        del got_y, got_f
        before = dict(ssd.launches_by_route)
        got_y, got_f = ops.ssd_scan(x, dt, a_log, B, C)
        launched_once("wgmma", before, f"ssd {name} bf16 y")
        if got_y.dtype != torch.bfloat16:
            raise AssertionError(f"ssd {name}: y is {got_y.dtype}, not x's bfloat16")
        err16 = check_close(torch, got_y, want_y.bfloat16(), ATOL["bfloat16"], RTOL,
                            f"ssd {name} bf16 y")
        err = max(err, check_close(torch, got_f, want_f, SSD_ATOL, 0.0,
                                   f"ssd {name} state (bf16 y)"))
        del got_y, got_f, want_y, want_f
        xdt = (x.float() * dt[..., None]).contiguous()
        dta = (dt * -a_log.exp()).contiguous()
        # ms: the tensor-core kernel alone (its wrapper's checks and
        # allocations included, as the prep is inside it); op_ms: the whole
        # ops.ssd_scan call the model makes; simt_*: the CUDA-core route on
        # the same inputs, its kernel alone and its whole call with the prep
        ms = cuda_ms(torch, lambda: ssd.wgmma(x, dt, a_log, B, C), iters=20)
        op_ms = cuda_ms(torch, lambda: ops.ssd_scan(x, dt, a_log, B, C), iters=20)
        simt_ms = cuda_ms(torch, lambda: ssd.simt(xdt, dta, B, C), iters=5)
        simt_op_ms = cuda_ms(torch, lambda: ssd.ssd_scan(x.float(), dt, a_log, B, C,
                                                         y_dtype=torch.bfloat16), iters=5)
        plain_ms = cuda_ms(torch, lambda: ref.ssd_scan_ref(x.float(), dt, a_log, B, C),
                           iters=2, warmup=1)
        chunk = ssd_plan(ssd, "wgmma", shape)["chunk"]
        flops, issued, nbytes, simt_bytes = ssd_work(shape, chunk)
        flops_ms = flops / PEAK_BF16_FLOPS * 1e3
        bytes_ms = nbytes / PEAK_HBM_BYTES * 1e3
        bound_ms = max(flops_ms, bytes_ms)
        simt_bound_ms = max(flops / PEAK_TF32_FLOPS, simt_bytes / PEAK_HBM_BYTES) * 1e3
        rows[name] = {"name": "ssd_scan", "route": "cuda",
                      "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
                      "replaces": "src/repro/kernels/ssd_scan.py:75",
                      "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": bound_ms,
                      "bound_by": "operations" if flops_ms >= bytes_ms else "bytes",
                      "library_ms": None}
        emit({"phase": f"kernel_{name}_shape", "kernel": "ssd_scan",
              "shape": {"x": [bsz, s, h, p], "B": [bsz, s, g, n]}, "dtype": "bfloat16",
              "kernel_route": ssd.route_for(x, dt, a_log, B, C),
              "plan": ssd_plan(ssd, "wgmma", shape),
              "simt_plan": ssd_plan(ssd, "simt", shape),
              "max_abs_err_bf16_y": err16, "atol_bf16_y": ATOL["bfloat16"],
              "rtol_bf16_y": RTOL,
              "op_ms": op_ms, "simt_ms": simt_ms, "simt_op_ms": simt_op_ms,
              "flops_needed": flops, "flops_issued": issued, "bytes": nbytes,
              "flops_bound_ms_bf16": flops_ms, "bytes_bound_ms": bytes_ms,
              "bound_ms_whole_call_bf16_io": bound_ms,
              "simt_bytes": simt_bytes,
              "bound_ms_xdt_y_fp32_io_tf32": simt_bound_ms,
              "achieved_tb_per_s": nbytes / (ms * 1e-3) / 1e12,
              "achieved_tflops_issued": issued / (ms * 1e-3) / 1e12,
              "roofline_share": bound_ms / ms, "op_roofline_share": bound_ms / op_ms,
              "simt_op_roofline_share": bound_ms / simt_op_ms,
              "library": SSD_NO_LIBRARY, **rows[name]})
        del x, dt, B, C, xdt, dta
    return rows["serving"]


def prompt_shape(batch) -> tuple:
    """(batch, prompt length) of a prefill batch: ``tokens`` (B, S), or
    ``input_embeds`` (B, S, F) where the prompts are embeddings."""
    x = batch["tokens"] if batch["tokens"] is not None else batch["input_embeds"]
    return int(x.shape[0]), int(x.shape[1])


def prefill_gap(torch, prefill, params, batch, cfg, max_len):
    """Relative L2 and top-1 agreement of pallas against xla prefill logits
    over the real vocab (these launches are not counted). ``batch``: the
    prefill's ``tokens`` and any ``enc_feats`` or ``input_embeds``."""
    kw = {k: v for k, v in batch.items() if k != "tokens"}
    with torch.no_grad():
        lp, _ = prefill(params, batch["tokens"], cfg, max_len, impl="pallas", **kw)
        lx, _ = prefill(params, batch["tokens"], cfg, max_len, impl="xla", **kw)
    lp, lx = lp[:, :cfg.vocab_size].float(), lx[:, :cfg.vocab_size].float()
    if not (bool(torch.isfinite(lp).all()) and bool(torch.isfinite(lx).all())):
        raise AssertionError("non-finite prefill logits")
    b, s = prompt_shape(batch)
    return {"rel_l2": float((lp - lx).norm() / lx.norm()),
            "max_abs": float((lp - lx).abs().max()),
            "top1_agree": float((lp.argmax(-1) == lx.argmax(-1)).float().mean()),
            "batch": b, "prompt_len": s}


def compare_granite(torch, cfg, params, batch, dev):
    from repro_torch.models.model import prefill

    gap = prefill_gap(torch, prefill, params, batch, cfg, prompt_shape(batch)[1] + GEN_LEN)
    if gap["rel_l2"] > PREFILL_REL_TOL:
        raise AssertionError(f"pallas vs xla prefill logits: rel L2 {gap['rel_l2']} > "
                             f"{PREFILL_REL_TOL}")
    return {"pallas_vs_xla_rel_l2": gap["rel_l2"], "pallas_vs_xla_max_abs": gap["max_abs"],
            "pallas_vs_xla_top1_agree": gap["top1_agree"], "rel_tol": PREFILL_REL_TOL,
            "compare_batch": gap["batch"]}


class fp32_weights:
    """Inside the block, the parameters of ``modules`` hold their values in
    fp32, exactly (every bf16 is an fp32), and their own bf16 tensors are
    freed; on leaving, the fp32 values are cast back, again exactly, so the
    weights come out bit for bit as they went in. One layer in fp32 at a
    time is what lets a model whose fp32 copy would not fit beside it (or
    whose layer would not fit beside its bf16 self) be held to one."""

    def __init__(self, *modules):
        self.params = list({id(p): p for m in modules for p in m.parameters()}.values())

    def __enter__(self):
        self.dtypes = [p.dtype for p in self.params]
        for p in self.params:
            p.data = p.data.float()

    def __exit__(self, *exc):
        for p, dtype in zip(self.params, self.dtypes):
            p.data = p.data.to(dtype)


def streamed_logits(torch, params, toks, cfg, impl):
    """Last-position prefill logits over the real vocab of the weights cast
    up to fp32, one layer's copy at a time: the embedding, each layer of the
    stack (``transformer._layer_apply``, the mixer prefill runs without its
    cache), then the final norm and the head."""
    from repro_torch.models import transformer
    from repro_torch.models.layers import embed, rmsnorm, unembed
    from repro_torch.models.model import mask_pad_logits

    head = params["unembed"] if "unembed" in params else params["embed"]
    b, s = toks.shape
    pos = torch.arange(s, device=toks.device)[None].expand(b, s)
    with torch.no_grad():
        with fp32_weights(params["embed"]):
            x = embed(params["embed"], toks).float()
        for i, layer in enumerate(params["stack"]):
            with fp32_weights(layer):
                x, _ = transformer._layer_apply(layer, x, cfg, i, pos, impl=impl)
        with fp32_weights(params["final_norm"], head):
            x = rmsnorm(params["final_norm"], x[:, -1:, :], cfg.norm_eps)
            logits = mask_pad_logits(unembed(head, x)[:, 0, :], cfg)
    logits = logits[:, :cfg.vocab_size].float()
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"non-finite fp32 {impl} logits")
    return logits


def compare_mamba(torch, cfg, params, batch, dev):
    """At 1024 tokens (one replica's batch) and on one 8192-token prompt,
    whose xla side scans chunks (S >= SSD_SCAN_THRESHOLD), against the xla
    logits of the bf16 weights cast up to fp32: the served bf16 pallas path
    (e_p) held to twice the bf16 xla path's spread (e_x); and pallas vs xla
    on the fp32 weights (the CUDA-core routes) held to SSM_PREFILL_REL_TOL.
    The fp32 passes stream the weights one layer at a time
    (``streamed_logits``), so a model whose fp32 copy would not fit beside
    its bf16 weights (jamba's 103 GB) is held the same way."""
    from repro_torch.models.model import prefill

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 3)
    long_prompt = torch.randint(0, cfg.vocab_size, (1, LONG_PROMPT_LEN), generator=gen,
                                device=dev)
    prompts = batch["tokens"]
    out = {"rel_tol_fp32": SSM_PREFILL_REL_TOL, "bf16_spread_factor": SSM_BF16_SPREAD,
           "fp32_reference": "bf16 weights cast up to fp32 one layer at a time"}
    cases = (("1024", prompts, MAX_LEN), ("8192", long_prompt, LONG_PROMPT_LEN))

    def logits(toks, max_len, impl):
        with torch.no_grad():
            lg, _ = prefill(params, toks, cfg, max_len, impl=impl)
        lg = lg[:, :cfg.vocab_size].float()
        if not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"non-finite {impl} prefill logits")
        return lg

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    def top1(a, b):
        return float((a.argmax(-1) == b.argmax(-1)).float().mean())

    for name, toks, max_len in cases:
        want = streamed_logits(torch, params, toks, cfg, "xla")
        xla16 = logits(toks, max_len, "xla")
        pal16 = logits(toks, max_len, "pallas")
        e_x, e_p = rel(xla16, want), rel(pal16, want)
        out[f"bf16_{name}"] = {"e_x": e_x, "e_p": e_p, "e_p_over_e_x": e_p / e_x,
                               "top1_xla_bf16_vs_fp32": top1(xla16, want),
                               "top1_pallas_bf16_vs_fp32": top1(pal16, want),
                               "pallas_vs_xla_bf16_rel_l2": rel(pal16, xla16),
                               "batch": int(toks.shape[0]), "prompt_len": int(toks.shape[1])}
        if not e_p <= SSM_BF16_SPREAD * e_x:
            raise AssertionError(f"bf16 pallas logits at {name} tokens: rel L2 {e_p} to "
                                 f"the fp32 xla logits > {SSM_BF16_SPREAD} x the bf16 "
                                 f"xla path's {e_x}")
        pal32 = streamed_logits(torch, params, toks, cfg, "pallas")
        gap = rel(pal32, want)
        out[f"fp32_{name}"] = {"rel_l2": gap, "max_abs": float((pal32 - want).abs().max()),
                               "top1_agree": top1(pal32, want),
                               "batch": int(toks.shape[0]), "prompt_len": int(toks.shape[1])}
        if gap > SSM_PREFILL_REL_TOL:
            raise AssertionError(f"fp32 pallas vs xla prefill logits at {name} tokens: "
                                 f"rel L2 {gap} > {SSM_PREFILL_REL_TOL}")
        del want, xla16, pal16, pal32
    return out


def no_drop_moe(torch, moe, cfg_moe, ffn, h):
    """``cfg_moe`` with the least capacity factor that keeps every (token,
    choice) pair of ``h``: its fullest expert's count per row."""
    _, top_i, _ = moe.route(ffn, h, cfg_moe)
    e, k = cfg_moe.n_experts, cfg_moe.top_k
    fullest = int(torch.nn.functional.one_hot(top_i, e).sum(dim=(1, 2)).max())
    return dataclasses.replace(cfg_moe, capacity_factor=fullest * e / (h.shape[1] * k))


def moe_dispatch_check(torch, cfg, params, prompts):
    """The sort dispatch against the dense oracle on the first MoE layer's
    real FFN input (the layers before it and that layer's mixer run on the
    xla path), with room for every (token, choice) pair; and the share of
    pairs the served capacity factor drops on the same input."""
    from repro_torch.models import moe
    from repro_torch.models import transformer
    from repro_torch.models.layers import embed, rmsnorm

    first = next(i for i in range(cfg.n_layers) if cfg.layer_is_moe(i))
    p = params["stack"][first]
    b, s = prompts.shape
    with torch.no_grad():
        x = embed(params["embed"], prompts)
        pos = torch.arange(s, device=x.device)[None].expand(b, s)
        for i in range(first):
            x, _ = transformer._layer_apply(params["stack"][i], x, cfg, i, pos, impl="xla")
        mixer_only = {k: v for k, v in p.items() if k != "ffn"}
        x, _ = transformer._layer_apply(mixer_only, x, cfg, first, pos, impl="xla")
        h = rmsnorm(p["norm2"], x, cfg.norm_eps)
        no_drop = no_drop_moe(torch, moe, cfg.moe, p["ffn"], h)
        out = {"batch": b, "prompt_len": s, "layer": first,
               "mixer": cfg.layer_kind(first),
               "no_drop_capacity_factor": no_drop.capacity_factor}
        # the fp32 case casts the layer's experts in place (jamba's are
        # 19.3 GB in fp32, which would not fit beside their bf16 selves)
        for name, weights, hin, tol in (
                ("fp32", fp32_weights(p["ffn"]), h.float(), MOE_FP32_REL_TOL),
                ("bf16", contextlib.nullcontext(), h, MOE_BF16_REL_TOL)):
            with weights:
                got, aux = moe.moe_apply(p["ffn"], hin, no_drop, cfg.act)
                want, aux_w = moe.moe_apply_dense_fallback(p["ffn"], hin, no_drop, cfg.act)
            got, want = got.float(), want.float()
            if not (bool(torch.isfinite(got).all()) and bool(torch.isfinite(want).all())):
                raise AssertionError(f"moe dispatch {name}: non-finite output")
            rel = float((got - want).norm() / want.norm())
            out[name] = {"rel_l2": rel, "max_abs": float((got - want).abs().max()),
                         "rel_tol": tol, "aux": float(aux), "aux_dense": float(aux_w)}
            if rel > tol or abs(float(aux) - float(aux_w)) > 1e-6 * abs(float(aux_w)):
                raise AssertionError(f"moe sort dispatch vs dense oracle ({name}): "
                                     f"rel L2 {rel} > {tol} or aux {float(aux)} != "
                                     f"{float(aux_w)}")
            del got, want
        caps = moe.expert_capacities(cfg.moe, s)
        _, top_i, _ = moe.route(p["ffn"], h, cfg.moe)
        _, keep, _, _ = moe.dispatch_slots(top_i, torch.as_tensor(caps, device=h.device).long(),
                                           int(caps.max()))
    out["served_capacity_factor"] = cfg.moe.capacity_factor
    out["served_drop_share"] = float((~keep).float().mean())
    return out


def compare_moe(torch, cfg, params, batch, dev):
    out = compare_granite(torch, cfg, params, batch, dev)
    out["moe_dispatch"] = moe_dispatch_check(torch, cfg, params,
                                             batch["tokens"][:MOE_CHECK_BATCH])
    return out


def compare_hybrid(torch, cfg, params, batch, dev):
    """A hybrid attention/SSM/MoE stack: its logits held as mamba2's are,
    and the MoE dispatch on its first MoE layer (behind an SSM mixer)."""
    out = compare_mamba(torch, cfg, params, batch, dev)
    out["moe_dispatch"] = moe_dispatch_check(torch, cfg, params,
                                             batch["tokens"][:MOE_CHECK_BATCH])
    return out


def serve_batch(torch, cfg, gen, dev, b, prompt_len):
    """One replica batch of prompts from ``gen``: the prefill's ``tokens``,
    and its ``enc_feats`` (stub audio frames over max_source_positions) or
    ``input_embeds`` (stub patch embeddings, no tokens) per the arch."""
    from repro_torch.models.frontends import frontend_feature_dim

    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, prompt_len), generator=gen,
                                     device=dev)}
    if cfg.encoder_layers > 0:
        batch["enc_feats"] = torch.randn((b, cfg.max_source_positions,
                                          frontend_feature_dim(cfg)), generator=gen,
                                         device=dev)
    elif cfg.frontend == "vision":
        batch["tokens"] = None
        batch["input_embeds"] = torch.randn((b, prompt_len, frontend_feature_dim(cfg)),
                                            generator=gen, device=dev)
    return batch


def launches_per_batch(cfg) -> dict:
    """Each kernel's launches per replica batch, by layer kind: flash once
    per attention layer of the decoder in the prefill, and per encoder
    layer twice, inside the prefill and in the batch's one ``encode`` that
    decode attends to; the SSD scan once per SSM layer; the bucket kernel
    never."""
    attn = sum(cfg.layer_kind(i) == "attn" for i in range(cfg.n_layers))
    return {"flash_attention": attn + 2 * cfg.encoder_layers,
            "ssd_scan": cfg.n_layers - attn, "skewed_bucket": 0}


def cut_config(torch, cfg, n_layers=None, n_experts=None):
    """``cfg`` cut to ``n_layers`` and ``n_experts`` where given, and the
    ``serve_init`` fields that state each cut and its reason: the published
    model's and the cut model's parameters and bf16 bytes
    (``param_count``), and the card's memory."""
    from repro_torch.configs import param_count

    card = torch.cuda.get_device_properties(0).total_memory
    cut = cfg
    fields = {"depth_cut": None, "expert_cut": None}
    if n_layers is not None:
        cut = dataclasses.replace(cut, n_layers=n_layers)
        fields["depth_cut"] = {
            "n_layers": n_layers, "published": cfg.n_layers,
            "published_params": param_count(cfg), "published_bf16_bytes": 2 * param_count(cfg),
            "why": "the published depth's bf16 weights are more than the card holds"}
    if n_experts is not None:
        group = dataclasses.replace(cfg, n_layers=cut.n_layers)
        cut = dataclasses.replace(cut, moe=dataclasses.replace(cfg.moe, n_experts=n_experts))
        fields["expert_cut"] = {
            "n_experts": n_experts, "published": cfg.moe.n_experts, "top_k": cfg.moe.top_k,
            "uncut_params_at_this_depth": param_count(group),
            "uncut_bf16_bytes_at_this_depth": 2 * param_count(group),
            "why": "more than the card holds at the least depth the reference stacks "
                   f"(one group of {cfg.layer_period}); top-k kept, so each token's "
                   "work is unchanged"}
    fields["cut_params"] = param_count(cut)
    fields["cut_bf16_bytes"] = 2 * param_count(cut)
    fields["card_bytes"] = card
    return cut, fields


def phase_serve(torch, counters, cfg, dev, compare, prompt_len=PROMPT_LEN, cuts=None):
    """Serve ``cfg`` for ROUNDS rounds of ``prompt_len``-token prompts;
    each kernel must launch ``launches_per_batch(cfg)`` times per replica
    batch (a hybrid stack interleaves flash and the SSD scan), all on the
    wgmma routes. ``cuts``: the ``serve_init`` fields of ``cut_config``.
    An enc-dec arch prefills with the batch's stub audio frames, encodes
    them once, and decodes against that ``enc_out``; a vision arch
    prefills on stub patch embeddings through ``model.prefill``."""
    from repro_torch.configs import padded_vocab_size
    from repro_torch.models.model import encode, init_params, prefill
    from repro_torch.runtime.serve_loop import (HeMTBatcher, make_prefill_step,
                                                make_serve_step)

    max_len = prompt_len + GEN_LEN
    t0 = time.perf_counter()
    params = init_params(cfg, SEED, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    emit({"phase": "serve_init", "arch": cfg.name, "n_layers": cfg.n_layers,
          "encoder_layers": cfg.encoder_layers, "frontend": cfg.frontend,
          "d_model": cfg.d_model, "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
          "padded_vocab": padded_vocab_size(cfg), "params": n_params,
          "ssm": None if cfg.ssm is None else dataclasses.asdict(cfg.ssm),
          "moe": None if cfg.moe is None else dataclasses.asdict(cfg.moe),
          "attention": None if cfg.attention is None else dataclasses.asdict(cfg.attention),
          "prompt_len": prompt_len, "max_len": max_len,
          "dtype": cfg.dtype, "init_s": time.perf_counter() - t0,
          **(cuts or {"depth_cut": None})})

    prefill_step = make_prefill_step(cfg, max_len, impl="pallas")
    serve_step = make_serve_step(cfg)
    names = [f"rep{i}" for i in range(len(REPLICAS))]
    batcher = HeMTBatcher(names, mode="hemt", min_share=1)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    torch.cuda.reset_peak_memory_stats()
    per_batch = launches_per_batch(cfg)

    zero_counts(counters)
    prefill_calls = 0
    compare_batch = None
    for rnd in range(ROUNDS):
        shares = batcher.dispatch(REQUESTS)
        finish, measured = {}, {}
        for name, speed in zip(names, REPLICAS):
            b = shares[name]
            if b == 0:
                finish[name] = 0.0
                continue
            batch = serve_batch(torch, cfg, gen, dev, b, prompt_len)
            before = {k: module.launches for k, module in counters.items()}
            torch.cuda.synchronize()
            t = time.perf_counter()
            if "input_embeds" in batch:
                with torch.no_grad():
                    logits, state = prefill(params, None, cfg, max_len, impl="pallas",
                                            input_embeds=batch["input_embeds"])
                tok = torch.argmax(logits, dim=-1).to(torch.int32)
            else:
                tok, state = prefill_step(params, batch["tokens"], batch.get("enc_feats"))
            prefill_host_ms = (time.perf_counter() - t) * 1e3
            torch.cuda.synchronize()
            prefill_ms = (time.perf_counter() - t) * 1e3
            prefill_calls += 1
            enc_out, encode_ms = None, None
            if cfg.encoder_layers > 0:
                t = time.perf_counter()
                with torch.no_grad():
                    enc_out = encode(params, batch["enc_feats"], cfg, impl="pallas")
                torch.cuda.synchronize()
                encode_ms = (time.perf_counter() - t) * 1e3
            got = {k: module.launches - before[k] for k, module in counters.items()}
            if got != per_batch:
                raise AssertionError(f"a batch launched {got}, want {per_batch}")
            tokens = [tok]
            finite = torch.ones((), dtype=torch.bool, device=dev)
            t = time.perf_counter()
            for _ in range(GEN_LEN):
                tok, logits, state = serve_step(params, state, tok, enc_out)
                tokens.append(tok)
                finite &= torch.isfinite(logits).all()
            decode_host_ms = (time.perf_counter() - t) * 1e3 / GEN_LEN
            torch.cuda.synchronize()
            decode_ms = (time.perf_counter() - t) * 1e3 / GEN_LEN
            toks = torch.stack(tokens)
            if not bool(finite):
                raise AssertionError(f"round {rnd} {name}: non-finite logits")
            if int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
                raise AssertionError(f"round {rnd} {name}: token out of "
                                     f"[0, {cfg.vocab_size})")
            if state["length"] != max_len:
                raise AssertionError(f"decode length {state['length']} != {max_len}")
            n_tok = b * GEN_LEN
            finish[name] = n_tok / (speed * BASE_TOKEN_RATE)
            batcher.observe(name, n_tok, finish[name])
            # *_host_ms: time until the host has issued the work; close to
            # the synchronized time means the host, not the card, sets the pace
            measured[name] = {"batch": b, "prefill_ms": prefill_ms,
                              "prefill_host_ms": prefill_host_ms,
                              **({"encode_ms": encode_ms} if encode_ms is not None else {}),
                              "decode_ms_per_token": decode_ms,
                              "decode_host_ms_per_token": decode_host_ms}
            compare_batch = batch
            del state, logits, enc_out
        makespan = max(finish.values())
        idle = makespan - min(v for v in finish.values() if v > 0)
        emit({"phase": "serve_round", "round": rnd, "arch": cfg.name, "shares": shares,
              "virtual_makespan_s": makespan, "virtual_idle_s": idle,
              "card": measured})
    launches = {name: module.launches for name, module in counters.items()}
    want = {name: n * prefill_calls for name, n in per_batch.items()}
    by_route = launches_on_wgmma(counters, launches, want, cfg.name)
    peak = torch.cuda.max_memory_allocated()
    serve_s = time.perf_counter() - t0
    checks = compare(torch, cfg, params, compare_batch, dev)
    emit({"phase": "serve_check", "arch": cfg.name, "prefill_calls": prefill_calls,
          "launches": launches, "launches_by_route": by_route,
          "launches_per_batch": per_batch,
          "max_memory_allocated_bytes": peak,
          "max_memory_allocated_bytes_with_checks": torch.cuda.max_memory_allocated(),
          "phase_s": serve_s, "checks_s": time.perf_counter() - t0 - serve_s, **checks})
    return launches


def launches_on_wgmma(counters, launches, want, what) -> dict:
    """Check the launches against ``want`` and that every launch of a
    routed kernel went to its wgmma (tensor-core) route; returns the routed
    kernels' counts by route."""
    if launches != want:
        raise AssertionError(f"{what}: launches {launches}, want {want}")
    by_route = {name: dict(module.launches_by_route) for name, module in counters.items()
                if launches[name] and hasattr(module, "launches_by_route")}
    for name, routes in by_route.items():
        if routes.get("wgmma") != launches[name]:
            raise AssertionError(f"{what}: {name} launches by route {routes}, "
                                 f"want all {launches[name]} on wgmma")
    return by_route


def phase_serve_once(torch, counters, cfg, dev, batch_size=DEEPSEEK_BATCH,
                     prompt_len=PROMPT_LEN):
    """One prefill of ``batch_size`` x ``prompt_len`` tokens and GEN_LEN
    decode steps of full-size ``cfg``, for a model whose weights leave no
    room for a HeMT round's batches: each kernel launches
    ``launches_per_batch(cfg)`` times, all on wgmma, then pallas against
    xla on the same batch."""
    from repro_torch.configs import padded_vocab_size
    from repro_torch.models.model import init_params
    from repro_torch.runtime.serve_loop import make_prefill_step, make_serve_step

    max_len = prompt_len + GEN_LEN
    t0 = time.perf_counter()
    params = init_params(cfg, SEED, device=dev)
    torch.cuda.synchronize()
    weight_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    emit({"phase": "serve_init", "arch": cfg.name, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
          "padded_vocab": padded_vocab_size(cfg),
          "params": sum(p.numel() for p in params.parameters()),
          "weight_bytes": weight_bytes,
          "attention": dataclasses.asdict(cfg.attention), "prompt_len": prompt_len,
          "max_len": max_len, "dtype": cfg.dtype, "init_s": time.perf_counter() - t0,
          "depth_cut": None})
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    batch = serve_batch(torch, cfg, gen, dev, batch_size, prompt_len)
    prefill_step = make_prefill_step(cfg, max_len, impl="pallas")
    serve_step = make_serve_step(cfg)
    torch.cuda.reset_peak_memory_stats()
    zero_counts(counters)
    torch.cuda.synchronize()
    t = time.perf_counter()
    tok, state = prefill_step(params, batch["tokens"])
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t) * 1e3
    tokens = [tok]
    finite = torch.ones((), dtype=torch.bool, device=dev)
    t = time.perf_counter()
    for _ in range(GEN_LEN):
        tok, logits, state = serve_step(params, state, tok)
        tokens.append(tok)
        finite &= torch.isfinite(logits).all()
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t) * 1e3 / GEN_LEN
    launches = {name: module.launches for name, module in counters.items()}
    by_route = launches_on_wgmma(counters, launches, launches_per_batch(cfg), cfg.name)
    toks = torch.stack(tokens)
    if not bool(finite) or int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
        raise AssertionError(f"{cfg.name}: non-finite logits or a token out of range")
    if state["length"] != max_len:
        raise AssertionError(f"decode length {state['length']} != {max_len}")
    del state, logits
    peak = torch.cuda.max_memory_allocated()
    emit({"phase": "serve_once", "arch": cfg.name, "batch": batch_size,
          "prompt_len": prompt_len, "gen_len": GEN_LEN, "prefill_ms": prefill_ms,
          "decode_ms_per_token": decode_ms, "launches": launches,
          "launches_by_route": by_route,
          "max_memory_allocated_bytes": peak, "hemt_rounds": 0,
          "why_no_rounds": "the bf16 weights leave too little of the card for a HeMT "
                           "round's replica batches",
          **compare_granite(torch, cfg, params, batch, dev),
          "phase_s": time.perf_counter() - t0})
    return launches


def phase_bucket_kernel(torch, np, ops, sb, ref, pr, skewed_hash):
    """skewed_bucket against the plain version on the card and numpy's
    bucket_of, for exact equality; then timed at PageRank's shape."""
    dev = torch.device("cuda")
    bucket_of = skewed_hash.bucket_of
    rng = np.random.default_rng(SEED + 4)

    def check(hashes, caps, what):
        h = torch.from_numpy(hashes).to(dev)
        c = torch.from_numpy(np.asarray(caps, np.int32)).to(dev)
        before = sb.launches
        got = ops.skewed_bucket(h, c)
        if sb.launches != before + 1:
            raise AssertionError(f"skewed_bucket {what}: not launched once")
        want = ref.skewed_bucket_ref(h, c)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"skewed_bucket {what}: "
                                 f"{int((got != want).sum())} buckets differ "
                                 "from the plain version")
        # bucket_of takes the hash mod the total in int64: hand it the
        # hashes wrapped to int32, as the kernel's wrapper casts them
        if not np.array_equal(got.cpu().numpy(), bucket_of(hashes.astype(np.int32), caps)):
            raise AssertionError(f"skewed_bucket {what}: differs from bucket_of")
        return int((got - want).abs().max()) if got.numel() else 0

    err, cases = 0, 0
    for weights in BUCKET_WEIGHTS:
        caps = skewed_hash.integer_capacities(weights, resolution=BUCKET_RESOLUTION)
        for t in BUCKET_LENGTHS:
            hashes = rng.integers(0, 2**30, t).astype(np.int32)
            err = max(err, check(hashes, caps, f"sweep {weights} T={t}"))
            cases += 1
    i32 = np.iinfo(np.int32)
    extreme = np.concatenate([
        np.asarray([i32.min, i32.min + 1, i32.max, i32.max - 1, -1, 0, 1,
                    -BUCKET_RESOLUTION, BUCKET_RESOLUTION], np.int32),
        rng.integers(i32.min, i32.max, 5000, endpoint=True).astype(np.int32)])
    for caps in ([700, 297], [0, 500, 0, 497], [997, 0]):   # zero-capacity buckets
        err = max(err, check(extreme, np.asarray(caps), f"extreme hashes caps={caps}"))
        cases += 1
    wide = rng.integers(0, 1000, BUCKET_WIDE_E)
    wide[rng.random(BUCKET_WIDE_E) < 0.1] = 0                  # zero capacities
    for t in BUCKET_LENGTHS:
        err = max(err, check(rng.integers(-2**31, 2**31, t).astype(np.int32), wide,
                             f"E={BUCKET_WIDE_E} T={t}"))
        err = max(err, check(rng.integers(-BUCKET_INT64_SPAN, BUCKET_INT64_SPAN, t),
                             wide, f"int64 hashes E={BUCKET_WIDE_E} T={t}"))
        err = max(err, check(rng.integers(2**31, BUCKET_INT64_SPAN, t),
                             np.asarray([700, 297]), f"int64 hashes >= 2**31 E=2 T={t}"))
        cases += 3
    emit({"phase": "kernel_sweep", "kernel": "skewed_bucket", "cases": cases,
          "max_abs_err": err, "tolerance": "exact", "wide_e": BUCKET_WIDE_E,
          "int64_span": BUCKET_INT64_SPAN})

    # the path's shape: PageRank's vertex hashes, HeMT capacities [1.0, 0.4]
    hashes = pr.vertex_hashes(PR_VERTICES)
    caps = skewed_hash.integer_capacities([1.0, 0.4], PR_OWNER_RESOLUTION)
    err = max(err, check(hashes, caps, "path shape"))
    h = torch.from_numpy(hashes).to(dev)
    c = torch.from_numpy(caps.astype(np.int32)).to(dev)
    cum = torch.cumsum(c, 0, dtype=torch.int32)
    total = cum[-1]
    scrub = torch.empty(L2_SCRUB_BYTES // 4, dtype=torch.float32, device=dev)
    # ms: the kernel's launch on ready prefix sums; wrapper_ms adds the
    # host-side check of the total (a read-back of the E capacities)
    ms = cuda_ms_cold(torch, lambda: sb.launch(h, cum), 20, scrub)
    warm_ms = cuda_ms(torch, lambda: sb.launch(h, cum), iters=20)
    wrapper_ms = cuda_ms_cold(torch, lambda: sb.skewed_bucket(h, c), 20, scrub)
    plain_ms = cuda_ms_cold(torch, lambda: ref.skewed_bucket_ref(h, c), 20, scrub)

    def library():
        return torch.bucketize(torch.remainder(h, total), cum, right=True, out_int32=True)

    library_ms = cuda_ms_cold(torch, library, 20, scrub)
    lib_out = library()
    if not torch.equal(lib_out, sb.launch(h, cum)):
        raise AssertionError("skewed_bucket: the library call disagrees")
    del scrub, lib_out
    t, e = h.numel(), c.numel()
    nbytes = 4 * t + 4 * e + 4 * t          # hashes and cum in, buckets out
    bytes_ms = nbytes / PEAK_HBM_BYTES * 1e3
    row = {"name": "skewed_bucket", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/skewed_bucket.cu",
           "replaces": "src/repro/kernels/skewed_bucket.py:29",
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bytes_ms, "bound_by": "bytes", "library_ms": library_ms}
    emit({"phase": "kernel_path_shape", "kernel": "skewed_bucket",
          "shape": {"hashes": [t], "capacities": [e]}, "capacities": caps.tolist(),
          "bytes": nbytes, "compares": t * e, "timing": "L2 scrubbed before each call",
          "warm_l2_ms": warm_ms, "wrapper_ms": wrapper_ms,
          "achieved_tb_per_s": nbytes / (ms * 1e-3) / 1e12,
          "roofline_share": bytes_ms / ms, "library": BUCKET_LIBRARY, **row})

    # the same hashes over BUCKET_WIDE_E capacities: four shared-memory
    # tiles of prefix sums, t * E compares
    cw = torch.from_numpy(wide.astype(np.int32)).to(dev)
    cum_w = torch.cumsum(cw, 0, dtype=torch.int32)
    wide_ms = cuda_ms_cold(torch, lambda: sb.launch(h, cum_w), 5, scrub_like(torch, dev))
    wide_lib_ms = cuda_ms_cold(torch, lambda: torch.bucketize(
        torch.remainder(h, cum_w[-1]), cum_w, right=True, out_int32=True), 5,
        scrub_like(torch, dev))
    wide_bytes = 8 * t + 4 * BUCKET_WIDE_E
    emit({"phase": "kernel_wide_e", "kernel": "skewed_bucket",
          "shape": {"hashes": [t], "capacities": [BUCKET_WIDE_E]},
          "ms": wide_ms, "library_ms": wide_lib_ms, "library": BUCKET_LIBRARY,
          "bytes": wide_bytes, "bytes_bound_ms": wide_bytes / PEAK_HBM_BYTES * 1e3,
          "compares": t * BUCKET_WIDE_E,
          "note": "the count over E compares every prefix sum: t * E compares; "
                  "bucketize binary-searches"})
    return row


def scrub_like(torch, dev):
    return torch.empty(L2_SCRUB_BYTES // 4, dtype=torch.float32, device=dev)


def device_profile(torch, fn, what: str, top: int = 0):
    """Runs ``fn`` under ``torch.profiler``; returns its result and the
    device time by kernel name (the ``top`` largest, or all)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms, n = kernels.get(e.name, (0.0, 0))
            kernels[e.name] = (ms + (e.time_range.end - e.time_range.start) / 1e3, n + 1)
    if not kernels:
        raise AssertionError(f"{what}: the profiler recorded no device activity")
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    return out, {"device_ms": sum(ms for ms, _ in kernels.values()),
                 "device_events": sum(n for _, n in kernels.values()),
                 "by_kernel": [[name[:100], ms, n] for name, (ms, n) in
                               (ranked[:top] if top else ranked)]}


def phase_pagerank(torch, np, counters, pr, skewed_hash, sim):
    """Fig 18 at scale on the card: the four modes of the demo, 100
    iterations each, then a 10-iteration job against a float64 oracle."""
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    src, dst = pr.random_graph(PR_VERTICES, PR_AVG_DEG, seed=SEED)
    gen_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    src_d, dst_d = torch.from_numpy(src).to(dev), torch.from_numpy(dst).to(dev)
    torch.cuda.synchronize()
    emit({"phase": "pagerank_graph", "vertices": PR_VERTICES, "edges": int(src.size),
          "avg_out_degree": PR_AVG_DEG, "seed": SEED, "generate_s": gen_s,
          "edge_bytes_on_card": src_d.numel() * 8 * 2,
          "source": "soc-LiveJournal1's vertex count (SNAP); uniform random "
                    "out-edges, not its degree distribution"})
    hashes = pr.vertex_hashes(PR_VERTICES)
    want_owner = {
        "hemt": skewed_hash.bucket_of(hashes, skewed_hash.integer_capacities(
            [1.0, 0.4], PR_OWNER_RESOLUTION)),
        "even": skewed_hash.bucket_of(hashes, skewed_hash.integer_capacities(
            [1.0, 1.0], PR_OWNER_RESOLUTION))}

    def nodes():
        return [sim.SimNode.constant(name, speed, overhead=PR_OVERHEAD)
                for name, speed in PR_SPEEDS]

    oracle = pr.pagerank_reference(src_d, dst_d, PR_VERTICES, PR_ITERS, device=dev)
    for module in counters.values():
        module.launches = 0
    finish, ms_iter = {}, {}
    for mode, kw in PR_MODES:
        kind = mode.split("-")[0]
        before = counters["skewed_bucket"].launches
        job = pr.PageRankJob(src_d, dst_d, PR_VERTICES, nodes(), mode=kind, device=dev, **kw)
        job_launches = counters["skewed_bucket"].launches - before
        if job_launches != 1:
            raise AssertionError(f"pagerank {mode}: skewed_bucket launched "
                                 f"{job_launches} times, want 1")
        if not np.array_equal(job.owner, want_owner["hemt" if kind == "hemt" else "even"]):
            raise AssertionError(f"pagerank {mode}: the card's owner differs from bucket_of")
        events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        t0 = time.perf_counter()
        ranks = job.run(PR_ITERS, events=events)
        run_s = time.perf_counter() - t0
        ms_iter[mode] = events[0].elapsed_time(events[1]) / PR_ITERS
        finish[mode] = job.total_time()
        owned = np.bincount(job.owner, minlength=len(PR_SPEEDS))
        share = float(owned[0] / owned.sum())
        if kind == "hemt" and abs(share - 1.0 / 1.4) > PR_SHARE_TOL:
            raise AssertionError(f"pagerank hemt: bucket share {share} not within "
                                 f"{PR_SHARE_TOL} of 1/1.4")
        if not np.isfinite(ranks).all() or abs(float(ranks.sum()) - 1.0) > PR_SUM_TOL:
            raise AssertionError(f"pagerank {mode}: ranks not finite or sum "
                                 f"{float(ranks.sum())} not within {PR_SUM_TOL} of 1")
        rel = float(np.linalg.norm(ranks - oracle) / np.linalg.norm(oracle))
        if rel > PR_REL_L2_TOL:
            raise AssertionError(f"pagerank {mode}: ranks vs pagerank_reference "
                                 f"rel L2 {rel} > {PR_REL_L2_TOL}")
        emit({"phase": "pagerank_mode", "mode": mode, "iters": PR_ITERS,
              "card_ms_per_iter": ms_iter[mode], "run_s": run_s,
              "finish_s": finish[mode], "owned_vertices": owned.tolist(),
              "bucket_share": share, "skewed_bucket_launches": job_launches,
              "rank_err": float(np.max(np.abs(ranks - oracle))),
              "rank_rel_l2_vs_reference": rel})
        del job

    # a separate short job against a float64 numpy oracle on the host,
    # run under the profiler: device time by kernel
    job = pr.PageRankJob(src_d, dst_d, PR_VERTICES, nodes(), mode="hemt",
                         weights=[1.0, 0.4], device=dev)
    got, prof = device_profile(torch, lambda: job.run(PR_CHECK_ITERS), "pagerank")
    del job
    emit({"phase": "pagerank_profile", "iters": PR_CHECK_ITERS, **prof})
    t0 = time.perf_counter()
    deg = np.maximum(np.bincount(src, minlength=PR_VERTICES), 1).astype(np.float64)
    want = np.full(PR_VERTICES, 1.0 / PR_VERTICES)
    for _ in range(PR_CHECK_ITERS):
        want = (0.15 / PR_VERTICES
                + 0.85 * np.bincount(dst, weights=(want / deg)[src], minlength=PR_VERTICES))
    oracle_s = time.perf_counter() - t0
    rel_l2 = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    if rel_l2 > PR_REL_L2_TOL:
        raise AssertionError(f"pagerank: float32 ranks vs float64 oracle rel L2 "
                             f"{rel_l2} > {PR_REL_L2_TOL}")

    launches = {name: module.launches for name, module in counters.items()}
    want_launches = {name: len(PR_MODES) + 1 if name == "skewed_bucket" else 0
                     for name in counters}
    if launches != want_launches:
        raise AssertionError(f"pagerank: launches {launches}, want {want_launches}")
    later = [m for m in finish if m != "hemt" and finish[m] <= finish["hemt"]]
    if later:
        raise AssertionError(f"pagerank: hemt ({finish['hemt']}) does not finish "
                             f"before {later} ({[finish[m] for m in later]})")
    best_homt = min(finish["homt-16"], finish["homt-64"])
    emit({"phase": "pagerank_check", "check_iters": PR_CHECK_ITERS,
          "rel_l2_vs_float64": rel_l2, "rel_tol": PR_REL_L2_TOL, "oracle_s": oracle_s,
          "hemt_vs_even_pct": (finish["even"] - finish["hemt"]) / finish["even"] * 100,
          "hemt_vs_best_homt_pct": (best_homt - finish["hemt"]) / best_homt * 100,
          "card_ms_per_iter": ms_iter, "launches": launches,
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()})
    return launches["skewed_bucket"]


def zero_counts(counters) -> None:
    for module in counters.values():
        module.launches = 0
        for name in getattr(module, "launches_by_route", {}):
            module.launches_by_route[name] = 0


def no_launches(counters, what: str) -> dict:
    launches = {name: module.launches for name, module in counters.items()}
    if any(launches.values()):
        raise AssertionError(f"{what}: launched {launches}, a phase with no kernel")
    return launches


def phase_kmeans(torch, np, counters, km, sim):
    """Fig 17 at scale on the card: the bench's four modes, 30 iterations
    each, every mode's centroids against the plain single-node K-means."""
    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 5)
    # K blobs around normal(0, 6) centers plus unit noise, made on the card
    centers = torch.randn((KM_K, KM_DIM), generator=gen, device=dev) * 6.0
    label = torch.randint(0, KM_K, (KM_POINTS,), generator=gen, device=dev)
    points = centers[label] + torch.randn((KM_POINTS, KM_DIM), generator=gen, device=dev)
    del label
    emit({"phase": "kmeans_data", "points": KM_POINTS, "dim": KM_DIM, "k": KM_K,
          "bytes_on_card": points.numel() * 4, "iters": KM_ITERS,
          "work_per_point_s": KM_WORK_PER_POINT,
          "source": "benchmarks/bench_fig17_kmeans.py's executors and modes; blobs of "
                    "launch/kmeans.py at 20 M points"})
    zero_counts(counters)
    t0 = time.perf_counter()
    want = km.kmeans_reference(points, KM_K, KM_ITERS, seed=SEED, device=dev)
    ref_s = time.perf_counter() - t0
    # the plain version against itself: the atomics' order varies per run
    ref_spread = float(np.max(np.abs(
        km.kmeans_reference(points, KM_K, KM_ITERS, seed=SEED, device=dev) - want)))
    finish, ms_iter, errs = {}, {}, {}
    for mode, kw in KM_MODES:
        nodes = [sim.SimNode.constant(name, speed, overhead=KM_OVERHEAD)
                 for name, speed in KM_SPEEDS]
        job = km.KMeansJob(points, KM_K, nodes, mode=mode.split("-")[0], seed=SEED,
                           work_per_point=KM_WORK_PER_POINT, device=dev, **kw)
        events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        got = job.run(KM_ITERS, events=events).cpu().numpy()
        ms_iter[mode] = events[0].elapsed_time(events[1]) / KM_ITERS
        finish[mode] = job.total_time()
        err = errs[mode] = float(np.max(np.abs(got - want)))
        emit({"phase": "kmeans_mode", "mode": mode, "iters": KM_ITERS,
              "card_ms_per_iter": ms_iter[mode], "finish_s": finish[mode],
              "mean_idle_s": float(np.mean([r.idle for r in job.reports])),
              "split": job.reports[0].split, "centroid_err": err, "atol": KM_ATOL})
        del job
    nodes = [sim.SimNode.constant(name, speed, overhead=KM_OVERHEAD)
             for name, speed in KM_SPEEDS]
    job = km.KMeansJob(points, KM_K, nodes, mode="hemt", weights=[1.0, 0.4], seed=SEED,
                       work_per_point=KM_WORK_PER_POINT, device=dev)
    _, prof = device_profile(torch, lambda: job.run(KM_PROFILE_ITERS), "kmeans")
    emit({"phase": "kmeans_profile", "mode": "hemt", "iters": KM_PROFILE_ITERS, **prof})
    del job
    launches = no_launches(counters, "kmeans")
    bad = {m: e for m, e in errs.items() if not e <= KM_ATOL}
    if bad:
        raise AssertionError(f"kmeans: centroids differ from kmeans_reference by {bad} > "
                             f"{KM_ATOL} (the plain version against itself: {ref_spread})")
    if not finish["hemt"] < finish["even"]:
        raise AssertionError(f"kmeans: hemt ({finish['hemt']}) does not finish before even "
                             f"({finish['even']})")
    best_homt = min(finish["homt-8"], finish["homt-32"])
    emit({"phase": "kmeans_check", "reference_s": ref_s,
          "reference_vs_itself_max_abs": ref_spread, "sum_block": km.SUM_BLOCK,
          "hemt_vs_even_pct": (finish["even"] - finish["hemt"]) / finish["even"] * 100,
          "hemt_vs_best_homt_pct": (best_homt - finish["hemt"]) / best_homt * 100,
          "card_ms_per_iter": ms_iter, "launches": launches,
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()})
    del points


def time_trainer(torch, tr):
    """Wraps the trainer's grain fold and barrier update: each appends
    (what, CUDA events, grains, host seconds at its start and end) to
    ``timing``; the update's metrics go to ``metrics``."""
    acc_inner, apply_inner = tr.grain_accumulate, tr.apply_step
    timing, metrics = [], []

    def accumulate(params, acc, grains):
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        t0 = time.perf_counter()
        ev[0].record()
        acc = acc_inner(params, acc, grains)
        ev[1].record()
        timing.append(("fold", ev, int(grains["tokens"].shape[0]), t0, None))
        return acc

    def apply(state, acc, total):
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        state, m = apply_inner(state, acc, total)
        ev[1].record()
        metrics.append({k: float(v) for k, v in m.items()})    # waits for the update
        timing.append(("apply", ev, 0, None, time.perf_counter()))
        return state, m

    tr.grain_accumulate, tr.apply_step = accumulate, apply
    return timing, metrics


def phase_train(torch, np, counters):
    """HeMT-DP on full-size mamba2-2.7b: TRAIN_STEPS steps of each mode from
    the same seed-0 params, against the schedule the copied engine gives on
    the CPU for the same slices."""
    import dataclasses as dc

    from repro_torch.configs import get_bundle, get_config, get_reduced
    from repro_torch.data.pipeline import SyntheticCorpus
    from repro_torch.runtime.hemt_driver import HeMTTrainer, SliceSpec
    from repro_torch.runtime.train_loop import (grain_acc_init, make_grain_step,
                                                train_state_init)

    dev = torch.device("cuda")
    cfg, bundle = get_config(TRAIN_ARCH), get_bundle(TRAIN_ARCH)
    slices = [SliceSpec(name, ((0.0, speed),)) for name, speed in TRAIN_SLICES]
    kw = dict(grain_batch=TRAIN_GRAIN_BATCH, global_batch=TRAIN_GLOBAL_BATCH,
              seq_len=TRAIN_SEQ)
    # the schedule alone: the same slices and grains driven through the
    # copied engine with a reduced model on the CPU (it sets no count)
    small = get_reduced(TRAIN_ARCH)
    expect = {}
    for mode in TRAIN_MODES:
        cpu = HeMTTrainer(small, dc.replace(bundle, model=small), slices, mode=mode,
                          device="cpu", **{**kw, "seq_len": 8})
        cpu.run(train_state_init(SEED, small, dc.replace(bundle, model=small), device="cpu"),
                TRAIN_STEPS)
        expect[mode] = [(r.grain_counts, r.makespan, r.idle_time) for r in cpu.reports]

    out, first_loss = {}, {}
    for mode in TRAIN_MODES:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state = train_state_init(SEED, cfg, bundle, device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in state.params.parameters())
        tr = HeMTTrainer(cfg, bundle, slices, mode=mode, device=dev, **kw)
        timing, metrics = time_trainer(torch, tr)
        probe = ("embed.table", "stack.0.mixer.w_in", f"stack.{cfg.n_layers - 1}.mixer.a_log")
        named = dict(state.params.named_parameters())
        zero_counts(counters)
        steps = []
        for step in range(TRAIN_STEPS):
            before = {n: named[n].detach().clone() for n in probe} if step == 0 else None
            t = time.perf_counter()
            state, rep = tr.run_step(state)
            torch.cuda.synchronize()
            host_s = time.perf_counter() - t
            (_, fold_ev, n_grains, _, _), (_, apply_ev, _, _, _) = timing[-2:]
            fold_ms = fold_ev[0].elapsed_time(fold_ev[1])
            apply_ms = apply_ev[0].elapsed_time(apply_ev[1])
            m = metrics[-1]
            if not (np.isfinite(rep.loss) and np.isfinite(m["grad_norm"])):
                raise AssertionError(f"train {mode} step {step}: loss {rep.loss}, "
                                     f"grad norm {m['grad_norm']}")
            if before is not None:
                still = [n for n in probe if torch.equal(before[n], named[n].detach())]
                if still:
                    raise AssertionError(f"train {mode}: {still} did not change in a step")
                del before
            got = (rep.grain_counts, rep.makespan, rep.idle_time)
            if got != expect[mode][step]:
                raise AssertionError(f"train {mode} step {step}: schedule {got}, the CPU "
                                     f"engine's {expect[mode][step]}")
            steps.append({"step": step, "grain_counts": rep.grain_counts,
                          "loss": rep.loss, "grad_norm": m["grad_norm"], "lr": m["lr"],
                          "virtual_makespan_s": rep.makespan, "virtual_idle_s": rep.idle_time,
                          "card_ms_fold": fold_ms, "card_ms_per_grain": fold_ms / n_grains,
                          "card_ms_apply": apply_ms, "card_ms_step": fold_ms + apply_ms,
                          "host_s_step": host_s})
            emit({"phase": "train_step", "arch": cfg.name, "mode": mode, **steps[-1]})
        first_loss[mode] = steps[0]["loss"]
        out[mode] = {"virtual_total_s": tr.total_time(), "virtual_mean_idle_s": tr.mean_idle(),
                     "card_ms_per_grain": float(np.mean([s["card_ms_per_grain"]
                                                         for s in steps[1:]])),
                     "card_ms_per_step": float(np.mean([s["card_ms_step"] for s in steps[1:]])),
                     "init_s": init_s,
                     "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
                     "launches": no_launches(counters, f"train {mode}")}
        del state, tr, named
    a, b = (first_loss[m] for m in TRAIN_MODES)
    if abs(a - b) > TRAIN_LOSS_RTOL * abs(b):
        raise AssertionError(f"train: step-0 loss {a} vs {b} across modes")
    # where a grain's card time goes: one grain step under the profiler
    torch.cuda.empty_cache()
    state = train_state_init(SEED, cfg, bundle, device=dev)
    grain = {k: torch.from_numpy(v).to(dev)
             for k, v in SyntheticCorpus(cfg.vocab_size, TRAIN_SEQ, seed=SEED)
             .batch(range(TRAIN_GRAIN_BATCH)).items()}
    step = make_grain_step(cfg, bundle)
    step(state.params, grain_acc_init(state.params), grain)          # warm-up
    _, prof = device_profile(
        torch, lambda: step(state.params, grain_acc_init(state.params), grain),
        "train", top=25)
    emit({"phase": "train_profile", "arch": cfg.name, "what": "one grain step "
          f"({TRAIN_GRAIN_BATCH} x {TRAIN_SEQ} tokens, forward, recompute, backward, "
          "fp32 accumulate)", **prof})
    del state, grain, step
    emit({"phase": "train_check", "arch": cfg.name, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "remat": bundle.mesh.remat,
          "moments": "bfloat16" if bundle.mesh.bf16_optimizer else "float32",
          "grain_batch": TRAIN_GRAIN_BATCH, "global_batch": TRAIN_GLOBAL_BATCH,
          "seq_len": TRAIN_SEQ, "steps": TRAIN_STEPS, "slices": TRAIN_SLICES,
          "step0_loss": first_loss, "loss_rtol": TRAIN_LOSS_RTOL,
          "timing_note": "card ms averaged over steps 1.. (step 0 includes set-up)",
          "params": n_params, **{f"mode_{m}": v for m, v in out.items()}})


def window_trainer(cfg, bundle, dev, seq_len=TRAIN_SEQ):
    """The oa-hemt trainer, fault trace and fleet monitor of the window
    phase, for ``cfg`` on ``dev``."""
    from repro_torch.core.faults import FaultTrace, NodeCrash
    from repro_torch.runtime.ft import FleetMonitor
    from repro_torch.runtime.hemt_driver import HeMTTrainer, SliceSpec

    names = [name for name, _ in TRAIN_SLICES]
    slices = [SliceSpec(name, ((0.0, speed),)) for name, speed in TRAIN_SLICES]
    tr = HeMTTrainer(cfg, bundle, slices, mode="oa-hemt", grain_batch=WINDOW_GRAIN_BATCH,
                     global_batch=WINDOW_GLOBAL_BATCH, seq_len=seq_len,
                     grain_cost=WINDOW_GRAIN_COST, seed=SEED, device=dev)
    trace = FaultTrace((NodeCrash(names.index(WINDOW_CRASH[0]), WINDOW_CRASH[1]),))
    return tr, trace, FleetMonitor(names, timeout=WINDOW_TIMEOUT)


def phase_train_window(torch, np, counters):
    """OA-HeMT windowed training of full-size mamba2-2.7b: one run_window of
    WINDOW_STEPS steps with rep1 crashed and declared dead inside it,
    against the same window's schedule on the CPU and step 0's loss
    against the plain loss over its sequences."""
    import dataclasses as dc

    from repro_torch.configs import get_bundle, get_config, get_reduced
    from repro_torch.models.model import loss_fn
    from repro_torch.runtime.elastic import scale_event_log
    from repro_torch.runtime.train_loop import train_state_init

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    cfg, bundle = get_config(TRAIN_ARCH), get_bundle(TRAIN_ARCH)
    # the schedule alone: the same window with a reduced model on the CPU
    small = get_reduced(TRAIN_ARCH)
    sbundle = dc.replace(bundle, model=small)
    cpu, trace, cpu_mon = window_trainer(small, sbundle, "cpu", WINDOW_REHEARSAL_SEQ)
    cpu.run_window(train_state_init(SEED, small, sbundle, device="cpu"), WINDOW_STEPS,
                   faults=trace, monitor=cpu_mon)
    expect = [(r.grain_counts, r.makespan, r.idle_time) for r in cpu.reports]
    expect_events = [dc.asdict(e) for e in cpu_mon.events]

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = train_state_init(SEED, cfg, bundle, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tr, trace, mon = window_trainer(cfg, bundle, dev)
    timing, metrics = time_trainer(torch, tr)
    probe = ("embed.table", "stack.0.mixer.w_in", f"stack.{cfg.n_layers - 1}.mixer.a_log")
    named = dict(state.params.named_parameters())
    before = {n: named[n].detach().clone() for n in probe}
    # the plain loss of step 0's sequences, one at a time as the grains are
    step0 = {k: torch.from_numpy(v).to(dev)
             for k, v in tr.corpus.batch(range(WINDOW_GLOBAL_BATCH)).items()}
    with torch.no_grad():
        plain = [float(loss_fn(state.params, {k: v[i:i + 1] for k, v in step0.items()}, cfg))
                 for i in range(WINDOW_GLOBAL_BATCH)]
    plain_loss0 = float(np.mean(plain))
    del step0
    zero_counts(counters)
    t = time.perf_counter()
    state = tr.run_window(state, WINDOW_STEPS, faults=trace, monitor=mon)
    torch.cuda.synchronize()
    window_s = time.perf_counter() - t
    launches = no_launches(counters, "train_window")
    if len(tr.reports) != WINDOW_STEPS or state.step != WINDOW_STEPS:
        raise AssertionError(f"train_window: {len(tr.reports)} reports, step {state.step}")
    folds = [e for e in timing if e[0] == "fold"]
    applies = [e for e in timing if e[0] == "apply"]
    steps = []
    for i, rep in enumerate(tr.reports):
        (_, fold_ev, n_grains, t_start, _), (_, apply_ev, _, _, t_end) = folds[i], applies[i]
        m = metrics[i]
        fold_ms = fold_ev[0].elapsed_time(fold_ev[1])
        apply_ms = apply_ev[0].elapsed_time(apply_ev[1])
        if sum(rep.grain_counts.values()) != WINDOW_GLOBAL_BATCH // WINDOW_GRAIN_BATCH:
            raise AssertionError(f"train_window step {i}: grains {rep.grain_counts}")
        if not (np.isfinite(rep.loss) and np.isfinite(m["grad_norm"])):
            raise AssertionError(f"train_window step {i}: loss {rep.loss}, "
                                 f"grad norm {m['grad_norm']}")
        got = (rep.grain_counts, rep.makespan, rep.idle_time)
        if got != expect[i]:
            raise AssertionError(f"train_window step {i}: schedule {got}, the CPU's {expect[i]}")
        steps.append({"step": rep.step, "grain_counts": rep.grain_counts,
                      "virtual_makespan_s": rep.makespan, "virtual_idle_s": rep.idle_time,
                      "loss": rep.loss, "grad_norm": m["grad_norm"], "lr": m["lr"],
                      "card_ms_fold": fold_ms, "card_ms_per_grain": fold_ms / n_grains,
                      "card_ms_apply": apply_ms, "card_ms_step": fold_ms + apply_ms,
                      "host_s_step": t_end - t_start})
        emit({"phase": "train_window_step", "arch": cfg.name, "mode": tr.mode, **steps[-1]})
    still = [n for n in probe if torch.equal(before[n], named[n].detach())]
    if still:
        raise AssertionError(f"train_window: {still} did not change over the window")
    loss0_rel = abs(tr.reports[0].loss - plain_loss0) / abs(plain_loss0)
    if not loss0_rel <= WINDOW_LOSS_RTOL:
        raise AssertionError(f"train_window: step 0's loss {tr.reports[0].loss}, the plain "
                             f"loss over its {WINDOW_GLOBAL_BATCH} sequences {plain_loss0}")
    events = [dc.asdict(e) for e in mon.events]
    dead = [e["slice_name"] for e in events if e["kind"] == "dead"]
    crashed = WINDOW_CRASH[0]
    if dead != [crashed] or events != expect_events:
        raise AssertionError(f"train_window: monitor events {events}, the CPU's {expect_events}")
    survivors = [s.name for s in tr.slices]
    if survivors != [n for n, _ in TRAIN_SLICES if n != crashed] or tr.exhausted is not None:
        raise AssertionError(f"train_window: slices {survivors} after the window, "
                             f"exhausted {tr.exhausted}")
    if tr.reports[-1].grain_counts.get(crashed, 0) != 0:
        raise AssertionError(f"train_window: the last step gave {crashed} "
                             f"{tr.reports[-1].grain_counts}")
    emit({"phase": "train_window_check", "arch": cfg.name, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "remat": bundle.mesh.remat, "mode": tr.mode,
          "grain_batch": WINDOW_GRAIN_BATCH, "global_batch": WINDOW_GLOBAL_BATCH,
          "seq_len": TRAIN_SEQ, "steps": WINDOW_STEPS, "slices": TRAIN_SLICES,
          "crash": {"slice": crashed, "at_virtual_s": WINDOW_CRASH[1], "permanent": True},
          "monitor_timeout_s": WINDOW_TIMEOUT, "monitor_events": events,
          "slices_after": survivors, "scale_event_log": scale_event_log(tr.planner),
          "estimates": tr.planner.estimator.known(), "virtual_total_s": tr.total_time(),
          "step0_loss": tr.reports[0].loss, "step0_plain_loss": plain_loss0,
          "step0_loss_rel_diff": loss0_rel, "loss_rtol": WINDOW_LOSS_RTOL,
          "step0_plain_loss_per_sequence": [min(plain), max(plain)],
          "card_ms_per_grain": float(np.mean([s["card_ms_per_grain"] for s in steps[1:]])),
          "card_ms_per_step": float(np.mean([s["card_ms_step"] for s in steps[1:]])),
          "host_s_window": window_s, "init_s": init_s,
          "phase_s": time.perf_counter() - t_phase,
          "timing_note": "card ms averaged over steps 1.. (step 0 includes set-up)",
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
          "launches": launches})
    del state, tr, named, before, timing, metrics


def leaves_equal(torch, a, b) -> list:
    """Names of the training-state leaves that differ between ``a`` and
    ``b`` bit for bit: params, moments, error feedback, both steps."""
    bad = [f"params/{n}" for (n, x), (_, y) in zip(a.params.named_parameters(),
                                                    b.params.named_parameters())
           if not torch.equal(x, y)]
    for what, da, db in (("mu", a.opt.mu, b.opt.mu), ("nu", a.opt.nu, b.opt.nu),
                         ("ef", a.ef, b.ef)):
        if list(da) != list(db):
            bad.append(f"{what}: keys differ")
        bad += [f"{what}/{n}" for n in da if n in db and not torch.equal(da[n], db[n])]
    if (a.step, a.opt.step) != (b.step, b.opt.step):
        bad.append(f"steps {a.step}, {a.opt.step} vs {b.step}, {b.opt.step}")
    return bad


def run_cli(module: str, argv) -> list:
    """``python -m repro_torch.launch.<module>`` with ``argv``, run in this
    process (its flags, printed lines and resume are what is checked, not a
    process start): the lines it printed."""
    import contextlib
    import importlib
    import io
    from unittest import mock

    cli = importlib.import_module(f"repro_torch.launch.{module}")
    out = io.StringIO()
    with mock.patch.object(sys, "argv", [f"repro_torch.launch.{module}", *argv]), \
            contextlib.redirect_stdout(out):
        cli.main()
    return out.getvalue().splitlines()


def phase_fleet(counters):
    """``repro_torch.launch.serve --simulate`` in this process for every
    batching mode on its docstring example: host arithmetic on the copied
    resident calendar, no kernel. HeMT must beat even batching on p99 and
    SLO attainment, and the clairvoyant oracle be no worse than HeMT on
    p99 (the reference's bench ordering, tests/test_serving.py)."""
    zero_counts(counters)
    t = time.perf_counter()
    reports = {}
    for mode in FLEET_MODES:
        reports[mode] = json.loads("\n".join(run_cli("serve", [*FLEET_ARGV, "--mode", mode])))
    launches = no_launches(counters, "fleet")
    for mode, rep in reports.items():
        if rep["n_completed"] != rep["n_requests"] or rep["n_requests"] == 0:
            raise AssertionError(f"fleet {mode}: {rep}")
        emit({"phase": "fleet_mode", "mode": mode,
              **{k: rep[k] for k in ("n_requests", "n_completed", "p50_s", "p99_s",
                                     "attainment", "goodput_rps")}})
    hemt, even, oracle = (reports[m] for m in FLEET_MODES)
    if not (hemt["p99_s"] < even["p99_s"] and hemt["attainment"] >= even["attainment"]
            and oracle["p99_s"] <= hemt["p99_s"] + 1e-6):
        raise AssertionError(f"fleet ordering: {reports}")
    emit({"phase": "fleet_check", "argv": list(FLEET_ARGV), "modes": list(FLEET_MODES),
          "launches": launches, "host_s": time.perf_counter() - t})


def fig7_json(scheduler, sim) -> str:
    """Paper Fig 7's OA-HeMT sequence through ``scheduler``'s
    AdaptiveHeMTScheduler on ``sim``'s nodes (tests/test_simulator_scheduler.py):
    the history as JSON."""
    def nodes(k):
        vb = 1.0 if k < FIG7_JOBS // 2 else 0.3
        return [sim.SimNode.constant("a", 1.0), sim.SimNode.constant("b", vb)]

    sched = scheduler.AdaptiveHeMTScheduler(["a", "b"], alpha=0.0)
    hist = sched.run_simulated_sequence(nodes, n_jobs=FIG7_JOBS, total_work=FIG7_WORK)
    return json.dumps([dataclasses.asdict(j) for j in hist], sort_keys=True)


def phase_scheduler(torch, np, counters):
    """The copied scheduler core on the card: ``pull_scan_torch`` in float64
    at SCAN_SHAPE against the numpy ``pull_scan`` (SCAN_TOL rel and abs,
    equal counts), a finite makespan gradient with respect to the works;
    then Fig 7's adaptive sequence, whose JSON must hash as the CPU's. No
    kernel may launch."""
    import hashlib

    from repro_torch.core import batched, scheduler
    from repro_torch.core import simulator as sim

    dev = torch.device("cuda")
    zero_counts(counters)
    t0 = time.perf_counter()
    rows, n, tasks = SCAN_SHAPE
    rng = np.random.default_rng(SEED)
    sp = rng.uniform(0.2, 3.0, (rows, n))
    wk = rng.uniform(0.0, 3.0, (rows, tasks))
    oh = np.full((rows, n), 0.01)
    t = time.perf_counter()
    want = batched.pull_scan(oh, sp, wk)
    numpy_ms = (time.perf_counter() - t) * 1e3
    oh_t, sp_t, wk_t = (torch.tensor(a, device=dev) for a in (oh, sp, wk))
    wk_t.requires_grad_(True)
    torch.cuda.synchronize()
    t = time.perf_counter()
    got = batched.pull_scan_torch(oh_t, sp_t, wk_t)
    torch.cuda.synchronize()
    card_ms = (time.perf_counter() - t) * 1e3
    if got[0].device.type != "cuda" or got[0].dtype != torch.float64:
        raise AssertionError(f"pull_scan_torch ran on {got[0].device} in {got[0].dtype}")
    errs = {}
    for name, g, w in zip(("node_end", "counts", "executed"), got, want):
        g = g.detach().cpu().numpy()
        if name == "counts":
            if not np.array_equal(g, w):
                raise AssertionError("pull_scan_torch counts differ from pull_scan")
            continue
        np.testing.assert_allclose(g, w, rtol=SCAN_TOL, atol=SCAN_TOL, err_msg=name)
        errs[name] = float(np.abs(g - w).max())
    makespan = got[0].amax(dim=1).sum()
    makespan.backward()
    grad = wk_t.grad
    if not bool(torch.isfinite(grad).all()) or float(grad.abs().sum()) == 0.0:
        raise AssertionError("pull_scan_torch: makespan gradient not finite or zero")
    t = time.perf_counter()
    history = fig7_json(scheduler, sim)
    fig7_s = time.perf_counter() - t
    digest = hashlib.sha256(history.encode()).hexdigest()
    if digest != FIG7_SHA256:
        raise AssertionError(f"Fig 7 history hashes {digest}, the CPU's {FIG7_SHA256}: "
                             f"{history}")
    launches = no_launches(counters, "scheduler")
    emit({"phase": "scheduler", "pull_scan_shape": {"rows": rows, "nodes": n,
                                                    "tasks": tasks},
          "dtype": "float64", "device": str(got[0].device), "max_abs_err": errs,
          "tol": SCAN_TOL, "counts_equal": True, "card_ms": card_ms,
          "numpy_ms": numpy_ms, "grad_abs_sum": float(grad.abs().sum()),
          "fig7_sha256": digest, "fig7_completions": [j["completion"]
                                                      for j in json.loads(history)],
          "fig7_s": fig7_s, "launches": launches, "phase_s": time.perf_counter() - t0})


def phase_checkpoint(torch, np, counters):
    """Checkpoints of mamba2-2.7b at full width and CKPT_LAYERS layers in the
    reference's format: save, save_async and restore into a fresh state on
    the card, every leaf bit for bit, the next step from both; then the
    train CLI on the card, resumed from its checkpoint."""
    import dataclasses as dc
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_bundle, get_config
    from repro_torch.runtime.hemt_driver import HeMTTrainer, SliceSpec
    from repro_torch.runtime.train_loop import train_state_init

    dev = torch.device("cuda")
    cfg = dc.replace(get_config(TRAIN_ARCH), n_layers=CKPT_LAYERS)
    bundle = dc.replace(get_bundle(TRAIN_ARCH), model=cfg)
    slices = [SliceSpec(name, ((0.0, speed),)) for name, speed in TRAIN_SLICES]

    def trainer():
        return HeMTTrainer(cfg, bundle, slices, mode="hemt", grain_batch=1,
                           global_batch=CKPT_GLOBAL_BATCH, seq_len=TRAIN_SEQ, seed=SEED,
                           device=dev)

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        torch.cuda.empty_cache()
        zero_counts(counters)
        state, _ = trainer().run_step(train_state_init(SEED, cfg, bundle, device=dev))
        step = state.step
        mgr = CheckpointManager(os.path.join(tmp, "sync"), keep=2)
        t = time.perf_counter()
        path = mgr.save(step, state)
        save_s = time.perf_counter() - t
        amgr = CheckpointManager(os.path.join(tmp, "async"), keep=2)
        t = time.perf_counter()
        amgr.save_async(step, state)
        save_async_call_s = time.perf_counter() - t
        amgr.wait()
        save_async_s = time.perf_counter() - t
        with np.load(os.path.join(path, "arrays.npz")) as za, \
                np.load(os.path.join(amgr.path_for(step), "arrays.npz")) as zb:
            if sorted(za.files) != sorted(zb.files) or \
                    any(not np.array_equal(za[k], zb[k]) for k in za.files):
                raise AssertionError("checkpoint: save and save_async wrote different arrays")
            n_leaves = len(za.files)
        metas = [json.load(open(os.path.join(p, "meta.json")))
                 for p in (path, amgr.path_for(step))]
        if metas[0] != metas[1]:
            raise AssertionError(f"checkpoint: meta.json differs: {metas}")
        fresh = train_state_init(SEED + 1, cfg, bundle, device=dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        got_step, restored, _ = amgr.restore_latest(fresh)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
        bad = leaves_equal(torch, state, restored)
        if got_step != step or bad:
            raise AssertionError(f"checkpoint: restored step {got_step} of {step}, "
                                 f"leaves differ: {bad[:8]}")
        on_card = {p.device.type for p in restored.params.parameters()} | \
            {m.device.type for m in restored.opt.mu.values()}
        if on_card != {dev.type}:
            raise AssertionError(f"checkpoint: restored state on {on_card}")
        # one more step from the live state and from the restored one
        state, rep_live = trainer().run_step(state)
        restored, rep_back = trainer().run_step(restored)
        if abs(rep_back.loss - rep_live.loss) > CKPT_LOSS_RTOL * abs(rep_live.loss):
            raise AssertionError(f"checkpoint: next loss {rep_back.loss} after restore, "
                                 f"{rep_live.loss} live")
        param_diff = max(float((x.detach().float() - y.detach().float()).abs().max())
                         for x, y in zip(state.params.parameters(),
                                         restored.params.parameters()))
        launches = no_launches(counters, "checkpoint")
        npz_bytes = os.path.getsize(os.path.join(path, "arrays.npz"))
        del state, restored, fresh

        # the train CLI on the card, then resumed from its checkpoint
        cli_dir = os.path.join(tmp, "cli")
        runs = []
        for steps in CLI_STEPS:
            t = time.perf_counter()
            lines = run_cli("train", ["--arch", TRAIN_ARCH, "--steps", str(steps), "--ckpt-every",
                             str(CLI_CKPT_EVERY), "--device", "cuda", "--ckpt", cli_dir])
            logged = [json.loads(ln) for ln in lines if ln.startswith("{")]
            runs.append({"steps": steps, "s": time.perf_counter() - t,
                         "resumed": [ln for ln in lines if ln.startswith("resumed")],
                         "logged_steps": [r["step"] for r in logged],
                         "losses": [r["loss"] for r in logged], "last": lines[-1]})
        first, second = runs
        if first["resumed"] or first["logged_steps"] != list(range(CLI_STEPS[0])):
            raise AssertionError(f"train CLI first run: {first}")
        if second["resumed"] != [f"resumed from step {CLI_STEPS[0]}"] or \
                second["logged_steps"] != list(range(*CLI_STEPS)):
            raise AssertionError(f"train CLI second run: {second}")
        if not all(np.isfinite(x) for r in runs for x in r["losses"]):
            raise AssertionError(f"train CLI: losses {runs}")
        cli_steps = sorted(CheckpointManager(cli_dir).steps())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "checkpoint", "arch": cfg.name, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model,
          "reduced": {"n_layers": "64 -> 4: the full training state is ~27 GB of npz, "
                                  "which would dominate the run's time and disk"},
          "step": step, "npz_bytes": npz_bytes, "n_leaves": n_leaves,
          "digest": metas[0]["digest"], "save_s": save_s,
          "save_async_call_s": save_async_call_s, "save_async_s": save_async_s,
          "restore_s": restore_s, "leaves_bit_equal": True,
          "next_loss_live": rep_live.loss, "next_loss_restored": rep_back.loss,
          "loss_rtol": CKPT_LOSS_RTOL, "max_abs_param_diff_after_next_step": param_diff,
          "launches": launches, "cli": runs, "cli_checkpoints": cli_steps,
          "phase_s": time.perf_counter() - t_phase})


def full_tensor(t):
    """A placed tensor's whole value (a plain tensor as it is)."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def phase_serve_placed(torch, counters, dev):
    """One HeMT round of full-size granite-3-8b from weights placed on a
    (1, 1) mesh over one NCCL rank, against the same seed's round on the
    unplaced weights: every token and decode logit bit for bit."""
    from collections import Counter

    from repro_torch.configs import get_bundle
    from repro_torch.launch.mesh import host_mesh
    from repro_torch.models.model import init_params
    from repro_torch.runtime import sharding as sh
    from repro_torch.runtime.serve_loop import HeMTBatcher, make_prefill_step, make_serve_step

    t0 = time.perf_counter()
    bundle = get_bundle(ARCH)
    cfg, mcfg = bundle.model, bundle.mesh
    max_len = PROMPT_LEN + GEN_LEN
    params = init_params(cfg, SEED, device=dev)
    prefill_step = make_prefill_step(cfg, max_len, impl="pallas")
    serve_step = make_serve_step(cfg)
    names = [f"rep{i}" for i in range(len(REPLICAS))]
    shares = HeMTBatcher(names, mode="hemt", min_share=1).dispatch(REQUESTS)
    per_batch = launches_per_batch(cfg)
    placed_as = {}

    def one_round(params, mesh):
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED + 1)
        out = {}
        for name in names:
            b = shares[name]
            if b == 0:
                continue
            tokens = torch.randint(0, cfg.vocab_size, (b, PROMPT_LEN), generator=gen,
                                   device=dev)
            if mesh is not None:
                batch = {"tokens": tokens}
                tokens = sh.place(batch, mesh, sh.batch_shardings(cfg, mesh, mcfg, batch))[
                    "tokens"]
            torch.cuda.synchronize()
            t = time.perf_counter()
            tok, state = prefill_step(params, tokens)
            torch.cuda.synchronize()
            prefill_ms = (time.perf_counter() - t) * 1e3
            if mesh is not None:
                c_sh = sh.cache_shardings(cfg, mesh, mcfg, state, b)
                state = sh.place(state, mesh, c_sh)
                placed_as["cache"] = dict(Counter(str(v) for v in c_sh.values()))
            toks, logits = [tok], []
            t = time.perf_counter()
            for _ in range(GEN_LEN):
                tok, lg, state = serve_step(params, state, tok)
                toks.append(tok)
                logits.append(lg)
            torch.cuda.synchronize()
            decode_ms = (time.perf_counter() - t) * 1e3 / GEN_LEN
            out[name] = {"tokens": torch.stack([full_tensor(x) for x in toks]),
                         "logits": torch.stack([full_tensor(x) for x in logits]),
                         "prefill_ms": prefill_ms, "decode_ms_per_token": decode_ms}
            del state
        return out

    n_batches = sum(1 for n in names if shares[n])
    want = {k: n * n_batches for k, n in per_batch.items()}
    zero_counts(counters)
    plain = one_round(params, None)
    plain_launches = {name: module.launches for name, module in counters.items()}
    launches_on_wgmma(counters, plain_launches, want, f"{cfg.name} unplaced")
    with host_mesh(dev) as mesh:
        p_sh = sh.param_shardings(cfg, mesh, mcfg)
        params = sh.place(params, mesh, p_sh)
        kinds = Counter(type(p).__name__ for p in params.parameters())
        if set(kinds) != {"DTensor"}:
            raise AssertionError(f"placed params: {dict(kinds)}")
        placed_as["params"] = dict(Counter(str(v) for v in p_sh.values()))
        mesh_info = {"shape": list(mesh.shape), "axes": list(mesh.mesh_dim_names),
                     "backend": torch.distributed.get_backend()}
        zero_counts(counters)
        placed = one_round(params, mesh)
        launches = {name: module.launches for name, module in counters.items()}
        by_route = launches_on_wgmma(counters, launches, want, f"{cfg.name} placed")
        del params
    import torch.distributed as dist

    if dist.is_initialized():
        raise AssertionError("serve_placed: the process group outlived its mesh")
    unequal = [f"{name} {what}" for name in plain for what in ("tokens", "logits")
               if not torch.equal(plain[name][what], placed[name][what])]
    if unequal:
        raise AssertionError(f"placed vs unplaced granite differ in {unequal}")
    toks = torch.cat([r["tokens"].flatten() for r in placed.values()])
    if int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
        raise AssertionError(f"placed granite: a token out of [0, {cfg.vocab_size})")
    if not all(bool(torch.isfinite(r["logits"]).all()) for r in placed.values()):
        raise AssertionError("placed granite: non-finite logits")
    timing = {name: {"placed": {k: placed[name][k] for k in ("prefill_ms",
                                                           "decode_ms_per_token")},
                     "plain": {k: plain[name][k] for k in ("prefill_ms",
                                                         "decode_ms_per_token")}}
              for name in placed}
    emit({"phase": "serve_placed", "arch": cfg.name, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "dtype": cfg.dtype, "mesh": mesh_info, "shares": shares,
          "prompt_len": PROMPT_LEN, "gen_len": GEN_LEN, "rounds": 1,
          "placements": placed_as, "launches": launches, "launches_by_route": by_route,
          "unplaced_round_launches": plain_launches,
          "bit_equal": {"tokens": sum(r["tokens"].numel() for r in placed.values()),
                        "logits": sum(r["logits"].numel() for r in placed.values())},
          "card": timing, "phase_s": time.perf_counter() - t0})
    return launches


def start_dryrun():
    """``launch.dryrun``'s full sweep on the CPU in DRYRUN_WORKERS fresh
    processes, driven from a thread so that ``phase_serve_placed`` runs
    beside it; returns (thread, result)."""
    from repro_torch.configs import ARCH_IDS
    from repro_torch.configs.shapes import ALL_SHAPES
    from repro_torch.launch import dryrun

    shutil.rmtree(DRYRUN_OUT, ignore_errors=True)
    result = {}

    def run():
        t = time.perf_counter()
        try:
            result["counts"] = dryrun.sweep(ARCH_IDS, [s.name for s in ALL_SHAPES],
                                            list(dryrun.MESHES), str(DRYRUN_OUT),
                                            workers=DRYRUN_WORKERS, echo=False)
        except Exception as e:          # reported by phase_dryrun
            result["error"] = f"{type(e).__name__}: {e}"
        result["sweep_s"] = time.perf_counter() - t

    thread = threading.Thread(target=run, name="dryrun")
    thread.start()
    return thread, result


def phase_dryrun(thread, result):
    """Wait for the sweep; every cell must be ok or a documented skip."""
    from repro_torch.launch import report
    from repro_torch.launch.op_cost import NOT_MEASURED

    thread.join()
    if "error" in result:
        raise AssertionError(f"dry-run sweep: {result['error']}")
    recs = {(r["arch"], r["shape"], r["mesh"]): r for r in report.load(str(DRYRUN_OUT))}
    errors = {" ".join(k): r["error"] for k, r in recs.items() if r["status"] == "error"}
    counts = result["counts"]
    if errors or counts["error"]:
        raise AssertionError(f"dry-run: {counts['error']} cells in error: {errors}")
    if len(recs) != DRYRUN_CELLS or counts["ok"] + counts["skipped"] != DRYRUN_CELLS:
        raise AssertionError(f"dry-run: {len(recs)} records, counts {counts}")
    sizes = {}
    for arch, shape in DRYRUN_BYTES:
        for mesh in ("single", "multi"):
            r = recs[(arch, shape, mesh)]
            sizes[f"{arch} {shape} {mesh}"] = {
                "n_devices": r["n_chips"],
                "argument_bytes_per_device": r["memory_analysis"]["argument_size_in_bytes"],
                "by_role": r["argument_bytes_by_role"],
                "flops_per_device_even_split": r["op_cost"]["flops_per_device"],
                "fallbacks": len(r["sharding_fallbacks"])}
    emit({"phase": "dryrun", "cells": len(recs), **counts, "sweep_s": result["sweep_s"],
          "workers": DRYRUN_WORKERS, "records": str(DRYRUN_OUT.relative_to(ROOT)),
          "summary": report.summary(list(recs.values())),
          "not_measured": list(NOT_MEASURED), "per_device_argument_bytes": sizes})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs a card", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import simulator as sim
    from repro_torch.core import skewed_hash
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import skewed_bucket as sb
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.workloads import kmeans as km
    from repro_torch.workloads import pagerank as pr

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    card = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    emit({"phase": "device", "name": card, "count": count,
          "capability": list(torch.cuda.get_device_capability(0)),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "nvidia_smi": smi})

    t = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:   # one nvcc per source, together
        built = dict(zip(KERNELS, pool.map(build.build, KERNELS)))
    build_s = time.perf_counter() - t
    smem = {"flash_attention": {"smem_bytes_by_route_and_head_dim":
                                {route: {d: fa.smem_bytes(route, d) for d in HEAD_DIMS}
                                 for route in ("simt", "wgmma")},
                                "wgmma_block_k": {d: fa.wgmma_block_k(d) for d in HEAD_DIMS}},
            "ssd_scan": {f"plan_{route}_{name}": ssd_plan(ssd, route, shape)
                         for route in ("simt", "wgmma")
                         for name, shape in (("serving", SSD_SERVE_SHAPE),
                                             ("long", SSD_LONG_SHAPE))},
            "skewed_bucket": {}}
    smem["ssd_scan"]["plan_simt_n256"] = ssd.plan("simt", 2, 8, 64, 256)
    for d in HEAD_DIMS:     # the wrapper's tile arithmetic is the library's
        if fa.smem_bytes("wgmma", d) != fa.wgmma_smem_bytes(d):
            raise AssertionError(f"flash wgmma smem at head_dim {d}: library "
                                 f"{fa.smem_bytes('wgmma', d)}, wrapper {fa.wgmma_smem_bytes(d)}")
        if max(fa.smem_bytes("wgmma", d), fa.smem_bytes("simt", d)) > SMEM_LIMIT:
            raise AssertionError(f"flash smem at head_dim {d} above {SMEM_LIMIT} B")
    # the tensor-core routes keep their accumulators in registers: no spills
    # and no "wgmma ... serialized" warning from ptxas
    for kernel, entry in (("flash_attention", "flash_fwd_wgmma_kernel"),
                          ("ssd_scan", "ssd_wgmma_kernel")):
        log = built[kernel].log
        entries = ptxas_entries(log, entry)
        serialized = [ln.strip() for ln in log.splitlines() if "serialized" in ln]
        smem[kernel]["ptxas_wgmma"] = entries
        if not entries or serialized or any(e.get("spill_bytes", 1) or e["warnings"]
                                            for e in entries):
            raise AssertionError(f"{kernel} wgmma kernel: ptxas reports {entries} "
                                 f"{serialized}")
    # every head_dim instantiation of the wgmma flash kernel, 256 included
    dims = sorted(int(m) for e in smem["flash_attention"]["ptxas_wgmma"]
                  for m in re.findall(r"ILi(\d+)E", e["entry"]))
    if dims != [64, 128, 256]:
        raise AssertionError(f"flash wgmma kernel instantiations {dims}, want 64/128/256")
    for kernel in KERNELS:
        emit({"phase": "build", "kernel": kernel,
              "library": str(built[kernel].path.relative_to(ROOT)), "build_s": build_s,
              **smem[kernel],
              "log": [ln for ln in built[kernel].log.splitlines() if ln.strip()]})

    dev = torch.device("cuda")
    counters = {"flash_attention": fa, "ssd_scan": ssd, "skewed_bucket": sb}
    rows = {"flash_attention": phase_flash_kernel(torch, F, ops, fa, ref),
            "ssd_scan": phase_ssd_kernel(torch, ops, ssd, ref),
            "skewed_bucket": phase_bucket_kernel(torch, np, ops, sb, ref, pr, skewed_hash)}
    for row in rows.values():
        row["launches"] = 0

    def served(launches):
        for name, n in launches.items():
            rows[name]["launches"] += n
        torch.cuda.empty_cache()

    served(phase_serve(torch, counters, get_config(ARCH), dev, compare_granite))
    served(phase_serve(torch, counters, get_config(GEMMA_ARCH), dev, compare_granite,
                       prompt_len=GEMMA_PROMPT_LEN))
    served(phase_serve(torch, counters, get_config(MOE_ARCH), dev, compare_moe))
    served(phase_serve(torch, counters, get_config(WHISPER_ARCH), dev, compare_granite,
                       prompt_len=WHISPER_PROMPT_LEN))
    for arch in (PIXTRAL_ARCH, CHATGLM_ARCH):
        served(phase_serve(torch, counters, get_config(arch), dev, compare_granite))
    served(phase_serve_once(torch, counters, get_config(DEEPSEEK_ARCH), dev))
    dbrx, cuts = cut_config(torch, get_config(DBRX_ARCH), n_layers=DBRX_LAYERS)
    served(phase_serve(torch, counters, dbrx, dev, compare_moe, cuts=cuts))
    phase_fleet(counters)
    phase_scheduler(torch, np, counters)
    served(phase_serve(torch, counters, get_config(SSM_ARCH), dev, compare_mamba))
    jamba, cuts = cut_config(torch, get_config(JAMBA_ARCH), n_layers=JAMBA_LAYERS,
                             n_experts=JAMBA_EXPERTS)
    served(phase_serve(torch, counters, jamba, dev, compare_hybrid, cuts=cuts))
    rows["skewed_bucket"]["launches"] += phase_pagerank(torch, np, counters, pr,
                                                       skewed_hash, sim)
    torch.cuda.empty_cache()
    phase_kmeans(torch, np, counters, km, sim)
    torch.cuda.empty_cache()
    phase_train(torch, np, counters)
    torch.cuda.empty_cache()
    phase_train_window(torch, np, counters)
    torch.cuda.empty_cache()
    phase_checkpoint(torch, np, counters)
    torch.cuda.empty_cache()
    dryrun = start_dryrun()
    served(phase_serve_placed(torch, counters, dev))
    phase_dryrun(*dryrun)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [{k: rows[kernel][k] for k in keys} for kernel in KERNELS]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": card, "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
