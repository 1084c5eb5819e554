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
             bf16 on the tensor cores, with bf16 head_dim-128 and -256 cases
             at ragged lengths, GQA groups and a window, and gemma3-12b's
             attention shape causal and with its 1024-token window; then
             ssd_scan on both routes, fp32 x on the CUDA cores and bf16 x on
             the tensor cores, over the sweep and at the serving shape and
             one long prompt's, where the whole ``ops.ssd_scan`` call of
             each route is timed too, and bf16 x the tensor cores cannot
             take (P 80, P 12, N 256, fp32 B/C) routed to the CUDA cores;
             then skewed_bucket, held exactly to the plain version and to
             numpy's ``bucket_of``, also at 4096 capacities and on int64
             hashes, and timed with a cold L2);
4. serve   — full-width, full-depth granite-3-8b, then mamba2-2.7b, with
             random weights from a seed, each served for 3 HeMT-dispatched
             rounds over replicas 1.0,1.0,0.4 through
             ``make_prefill_step(impl="pallas")`` and ``make_serve_step``.
             Every kernel's count is set to 0 just before a model's rounds
             and read just after: its own kernel launched once per layer
             and prefill, the other kernel never, all on the wgmma
             (tensor-core) route. Then pallas against xla prefill logits
             (mamba2 at 1024 tokens and on one 8192-token prompt: the bf16
             pallas logits held to twice the bf16 xla path's distance from
             the xla logits of the weights cast up to fp32, and pallas vs
             xla on that fp32 copy, which runs the CUDA-core route);
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
8. the ``{"kernels": [...]}`` line, the nvidia-smi line, and last
   ``{"ok": true, "device": {...}}``.

Without a card, or run where ``src/repro_torch`` is missing, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
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
BASE_TOKEN_RATE = 100.0       # virtual decode tokens/s of a speed-1.0 replica

# the reference sweep (tests/test_kernels.py) and the serving shape
SWEEP_SHAPES = [(1, 2, 2, 64, 64, 16), (2, 4, 2, 96, 96, 32),
                (1, 8, 1, 128, 256, 64), (1, 2, 2, 33, 65, 16),
                (1, 4, 2, 130, 130, 256)]    # head_dim 256 on both routes
SWEEP_MASKS = [(True, 0), (True, 24), (False, 0)]
SERVE_SHAPE = (10, 32, 8, 1024, 128)    # B, Hq, Hkv, S, D: the largest share
# bf16 at the serving head_dim, model layout: ragged lengths around the
# 128-row tiles, GQA groups 1, 4 and 8 (Hq 8), causal, causal + window, full
WGMMA_LENGTHS = (1, 127, 129, 1000)
WGMMA_HEADS = ((8, 8), (8, 2), (8, 1))
WGMMA_MASKS = ((True, 0), (True, 100), (False, 0))
# bf16 at head_dim 256 (64-key tiles): ragged lengths around them
WGMMA_256_LENGTHS = (1, 63, 65, 129, 1000)
WGMMA_256_HEADS = ((4, 4), (4, 1))
# gemma3-12b's attention (src/repro/configs/gemma3_12b.py: 16 query heads,
# 8 kv heads, head_dim 256; local layers slide a 1024-token window) at a
# 2048-token prompt, batch 2, in model layout
GEMMA_SHAPE = (2, 16, 8, 2048, 256)
GEMMA_MASKS = (("causal", True, 0), ("window 1024", True, 1024))
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
    for name, shape in (("serving", SSD_SERVE_SHAPE), ("long", SSD_LONG_SHAPE)):
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


def prefill_gap(torch, prefill, params, prompts, cfg, max_len):
    """Relative L2 and top-1 agreement of pallas against xla prefill logits
    over the real vocab (these launches are not counted)."""
    with torch.no_grad():
        lp, _ = prefill(params, prompts, cfg, max_len, impl="pallas")
        lx, _ = prefill(params, prompts, cfg, max_len, impl="xla")
    lp, lx = lp[:, :cfg.vocab_size].float(), lx[:, :cfg.vocab_size].float()
    if not (bool(torch.isfinite(lp).all()) and bool(torch.isfinite(lx).all())):
        raise AssertionError("non-finite prefill logits")
    return {"rel_l2": float((lp - lx).norm() / lx.norm()),
            "max_abs": float((lp - lx).abs().max()),
            "top1_agree": float((lp.argmax(-1) == lx.argmax(-1)).float().mean()),
            "batch": int(prompts.shape[0]), "prompt_len": int(prompts.shape[1])}


def compare_granite(torch, cfg, params, prompts, dev):
    from repro_torch.models.model import prefill

    gap = prefill_gap(torch, prefill, params, prompts, cfg, MAX_LEN)
    if gap["rel_l2"] > PREFILL_REL_TOL:
        raise AssertionError(f"pallas vs xla prefill logits: rel L2 {gap['rel_l2']} > "
                             f"{PREFILL_REL_TOL}")
    return {"pallas_vs_xla_rel_l2": gap["rel_l2"], "pallas_vs_xla_max_abs": gap["max_abs"],
            "pallas_vs_xla_top1_agree": gap["top1_agree"], "rel_tol": PREFILL_REL_TOL,
            "compare_batch": gap["batch"]}


def compare_mamba(torch, cfg, params, prompts, dev):
    """At 1024 tokens (one replica's batch) and on one 8192-token prompt,
    whose xla side scans chunks (S >= SSD_SCAN_THRESHOLD), against the xla
    logits of the bf16 weights cast up to fp32: the served bf16 pallas path
    (e_p) held to twice the bf16 xla path's spread (e_x); and pallas vs xla
    on the fp32 copy (the CUDA-core route) held to SSM_PREFILL_REL_TOL."""
    import copy

    from repro_torch.models.model import prefill

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 3)
    long_prompt = torch.randint(0, cfg.vocab_size, (1, LONG_PROMPT_LEN), generator=gen,
                                device=dev)
    params32 = copy.deepcopy(params).float()      # exact: every bf16 is an fp32
    out = {"rel_tol_fp32": SSM_PREFILL_REL_TOL, "bf16_spread_factor": SSM_BF16_SPREAD}
    cases = (("1024", prompts, MAX_LEN), ("8192", long_prompt, LONG_PROMPT_LEN))

    def logits(p, toks, max_len, impl):
        with torch.no_grad():
            lg, _ = prefill(p, toks, cfg, max_len, impl=impl)
        lg = lg[:, :cfg.vocab_size].float()
        if not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"non-finite {impl} prefill logits")
        return lg

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    def top1(a, b):
        return float((a.argmax(-1) == b.argmax(-1)).float().mean())

    for name, toks, max_len in cases:
        want = logits(params32, toks, max_len, "xla")
        xla16 = logits(params, toks, max_len, "xla")
        pal16 = logits(params, toks, max_len, "pallas")
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
        del want, xla16, pal16
    for name, toks, max_len in cases:
        gap = prefill_gap(torch, prefill, params32, toks, cfg, max_len)
        if gap["rel_l2"] > SSM_PREFILL_REL_TOL:
            raise AssertionError(f"fp32 pallas vs xla prefill logits at {name} tokens: "
                                 f"rel L2 {gap['rel_l2']} > {SSM_PREFILL_REL_TOL}")
        out[f"fp32_{name}"] = gap
    del params32
    return out


def phase_serve(torch, counters, cfg, dev, kernel, compare, route=None):
    """Serve ``cfg`` for ROUNDS rounds; ``kernel`` must launch once per
    layer and prefill call, all on ``route`` where given, the other
    counters not at all."""
    from repro_torch.configs import padded_vocab_size
    from repro_torch.models.model import init_params
    from repro_torch.runtime.serve_loop import (HeMTBatcher, make_prefill_step,
                                                make_serve_step)

    t0 = time.perf_counter()
    params = init_params(cfg, SEED, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    emit({"phase": "serve_init", "arch": cfg.name, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
          "padded_vocab": padded_vocab_size(cfg), "params": n_params,
          "ssm": None if cfg.ssm is None else dataclasses.asdict(cfg.ssm),
          "dtype": cfg.dtype, "init_s": time.perf_counter() - t0, "depth_cut": None})

    prefill_step = make_prefill_step(cfg, MAX_LEN, impl="pallas")
    serve_step = make_serve_step(cfg)
    names = [f"rep{i}" for i in range(len(REPLICAS))]
    batcher = HeMTBatcher(names, mode="hemt", min_share=1)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    torch.cuda.reset_peak_memory_stats()

    for module in counters.values():
        module.launches = 0
        for name in getattr(module, "launches_by_route", {}):
            module.launches_by_route[name] = 0
    prefill_calls = 0
    compare_prompts = None
    for rnd in range(ROUNDS):
        shares = batcher.dispatch(REQUESTS)
        finish, measured = {}, {}
        for name, speed in zip(names, REPLICAS):
            b = shares[name]
            if b == 0:
                finish[name] = 0.0
                continue
            prompts = torch.randint(0, cfg.vocab_size, (b, PROMPT_LEN),
                                    generator=gen, device=dev)
            before = counters[kernel].launches
            torch.cuda.synchronize()
            t = time.perf_counter()
            tok, state = prefill_step(params, prompts)
            prefill_host_ms = (time.perf_counter() - t) * 1e3
            torch.cuda.synchronize()
            prefill_ms = (time.perf_counter() - t) * 1e3
            prefill_calls += 1
            if counters[kernel].launches - before != cfg.n_layers:
                raise AssertionError(f"prefill launched {kernel} "
                                     f"{counters[kernel].launches - before} times, "
                                     f"want {cfg.n_layers}")
            tokens = [tok]
            finite = torch.ones((), dtype=torch.bool, device=dev)
            t = time.perf_counter()
            for _ in range(GEN_LEN):
                tok, logits, state = serve_step(params, state, tok)
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
            if state["length"] != MAX_LEN:
                raise AssertionError(f"decode length {state['length']} != {MAX_LEN}")
            n_tok = b * GEN_LEN
            finish[name] = n_tok / (speed * BASE_TOKEN_RATE)
            batcher.observe(name, n_tok, finish[name])
            # *_host_ms: time until the host has issued the work; close to
            # the synchronized time means the host, not the card, sets the pace
            measured[name] = {"batch": b, "prefill_ms": prefill_ms,
                              "prefill_host_ms": prefill_host_ms,
                              "decode_ms_per_token": decode_ms,
                              "decode_host_ms_per_token": decode_host_ms}
            compare_prompts = prompts
            del state, logits
        makespan = max(finish.values())
        idle = makespan - min(v for v in finish.values() if v > 0)
        emit({"phase": "serve_round", "round": rnd, "shares": shares,
              "virtual_makespan_s": makespan, "virtual_idle_s": idle,
              "card": measured})
    launches = {name: module.launches for name, module in counters.items()}
    by_route = dict(getattr(counters[kernel], "launches_by_route", {}))
    want = {name: cfg.n_layers * prefill_calls if name == kernel else 0
            for name in counters}
    if launches != want:
        raise AssertionError(f"{cfg.name}: launches {launches} for {prefill_calls} "
                             f"prefill calls, want {want}")
    if route is not None and by_route.get(route) != launches[kernel]:
        raise AssertionError(f"{cfg.name}: {kernel} launches by route {by_route}, "
                             f"want all {launches[kernel]} on {route}")
    peak = torch.cuda.max_memory_allocated()

    emit({"phase": "serve_check", "arch": cfg.name, "prefill_calls": prefill_calls,
          "launches": launches,
          **({"launches_by_route": {kernel: by_route}} if by_route else {}),
          "launches_per_prefill": cfg.n_layers,
          "max_memory_allocated_bytes": peak,
          **compare(torch, cfg, params, compare_prompts, dev)})
    return launches[kernel]


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
        # time the grain fold and the barrier update with CUDA events, and
        # keep the update's metrics
        acc_inner, apply_inner = tr.grain_accumulate, tr.apply_step
        timing, metrics = [], []

        def accumulate(params, acc, grains, inner=acc_inner):
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
            acc = inner(params, acc, grains)
            ev[1].record()
            timing.append(("fold", ev, int(grains["tokens"].shape[0])))
            return acc

        def apply(state, acc, total, inner=apply_inner):
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
            state, m = inner(state, acc, total)
            ev[1].record()
            timing.append(("apply", ev, 0))
            metrics.append({k: float(v) for k, v in m.items()})
            return state, m

        tr.grain_accumulate, tr.apply_step = accumulate, apply
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
            (_, fold_ev, n_grains), (_, apply_ev, _) = timing[-2:]
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
        del state, tr, named, accumulate, apply
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
    rows["flash_attention"]["launches"] = phase_serve(
        torch, counters, get_config(ARCH), dev, "flash_attention", compare_granite,
        route="wgmma")
    torch.cuda.empty_cache()
    rows["ssd_scan"]["launches"] = phase_serve(
        torch, counters, get_config(SSM_ARCH), dev, "ssd_scan", compare_mamba,
        route="wgmma")
    torch.cuda.empty_cache()
    rows["skewed_bucket"]["launches"] = phase_pagerank(torch, np, counters, pr,
                                                       skewed_hash, sim)
    torch.cuda.empty_cache()
    phase_kmeans(torch, np, counters, km, sim)
    torch.cuda.empty_cache()
    phase_train(torch, np, counters)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [{k: rows[kernel][k] for k in keys} for kernel in KERNELS]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": card, "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
