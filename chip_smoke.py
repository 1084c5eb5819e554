#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repo root on a machine with one CUDA card (an H100):

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and exits non-zero:

1. device  — card name and count, torch and CUDA versions, power limit;
2. build   — nvcc builds every kernel of the paths for sm_90a from the
             sources in the checkout, all at once; the -Xptxas -v report
             is printed;
3. kernel  — each kernel against its plain PyTorch version on the card, at
             the reference's sweep shapes and at the path's shape, timed
             with CUDA events beside the plain version and the library call
             (flash_attention, then ssd_scan, which also runs one long
             prompt's shape, then skewed_bucket, held exactly to the plain
             version and to numpy's ``bucket_of`` and timed with a cold L2);
4. serve   — full-width, full-depth granite-3-8b, then mamba2-2.7b, with
             random weights from a seed, each served for 3 HeMT-dispatched
             rounds over replicas 1.0,1.0,0.4 through
             ``make_prefill_step(impl="pallas")`` and ``make_serve_step``.
             Every kernel's count is set to 0 just before a model's rounds
             and read just after: its own kernel launched once per layer
             and prefill, the other kernel never. Then pallas against xla
             prefill logits (mamba2 also on one 8192-token prompt);
5. pagerank — paper Fig 18's PageRank on a 4,847,571-vertex graph with 14
             out-edges per vertex (soc-LiveJournal1's vertex count), 100
             iterations in each of the four modes of the demo, then a
             10-iteration job, run under ``torch.profiler`` (device time by
             kernel), against a float64 numpy oracle. Counts are set
             to 0 before the phase: skewed_bucket launches once per job, the
             other kernels never. The card's ownership map must equal
             ``bucket_of`` on the host, HeMT's bucket share 1/1.4, and HeMT
             must finish first (Fig 18's ordering);
6. the ``{"kernels": [...]}`` line, the nvidia-smi line, and last
   ``{"ok": true, "device": {...}}``.

Without a card, or run where ``src/repro_torch`` is missing, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
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
                (1, 8, 1, 128, 256, 64), (1, 2, 2, 33, 65, 16)]
SWEEP_MASKS = [(True, 0), (True, 24), (False, 0)]
SERVE_SHAPE = (10, 32, 8, 1024, 128)    # B, Hq, Hkv, S, D: the largest share
# kernel vs plain version, both fp32 inside: bf16 output rounding dominates
ATOL = {"float32": 2e-5, "bfloat16": 2e-2}
RTOL = 1e-2
# pallas vs xla prefill logits, relative L2 over the real vocab: the xla
# path rounds probabilities to bf16 before PV, the kernel keeps them fp32;
# a 40-layer bf16 CPU probe at reduced width showed 2.0e-2
PREFILL_REL_TOL = 5e-2

# ssd_scan: (batch, S, H, P, G, N); the reference sweep's shapes
# (tests/test_kernels.py), then B/C in bf16 over G in {1, 2, 4} and the
# serving head and state sizes at a ragged S
SSD_SWEEP = [((1, 64, 2, 16, 1, 8), "float32"), ((2, 96, 4, 8, 2, 16), "float32"),
             ((1, 50, 4, 16, 4, 8), "float32")]
SSD_SWEEP += [((2, 96, 8, 16, g, 16), "bfloat16") for g in (1, 2, 4)]
SSD_SWEEP += [((2, 200, 8, 64, g, 128), "bfloat16") for g in (1, 4)]
SSD_SERVE_SHAPE = (10, 1024, 80, 64, 1, 128)   # the largest share's prefill
SSD_LONG_SHAPE = (1, 8192, 80, 64, 1, 128)     # one long prompt
# the reference sweep's tolerance: chunked against sequential sums in fp32
SSD_ATOL = 2e-3
SSD_NO_LIBRARY = "no single PyTorch call computes a chunked SSD scan"
# mamba2 pallas vs xla prefill logits: checked on an fp32 copy of the same
# random weights, where the two paths differ only in summation order. In
# bf16 the paths round y at different places and random weights amplify
# that with depth, as much in the JAX package's own two paths
# (tests/test_torch_ssm.py::test_bf16_path_gap_is_the_references_own), so
# the bf16 gap is reported, not checked.
SSM_PREFILL_REL_TOL = 5e-2

# skewed_bucket: the reference sweep (tests/test_kernels.py) at its
# resolution, and the path's shape: PageRank's vertex ownership
BUCKET_WEIGHTS = [[1.0, 0.4], [1.0, 1.0, 1.0], [3, 4, 4], [0.5, 0.3, 0.1, 0.1]]
BUCKET_LENGTHS = [17, 1024, 5000]
BUCKET_RESOLUTION = 997
BUCKET_LIBRARY = ("torch.bucketize(torch.remainder(h, total), cum, right=True, "
                  "out_int32=True)")
L2_SCRUB_BYTES = 128 << 20     # written between timed calls: > the 50 MB L2

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

    errs = {"float32": 0.0, "bfloat16": 0.0}
    cases = 0
    for (b, hq, hkv, sq, sk, d) in SWEEP_SHAPES:
        for causal, window in SWEEP_MASKS:
            for name, dt in dtypes.items():
                q, k, v = (randn((b, hq, sq, d), dt), randn((b, hkv, sk, d), dt),
                           randn((b, hkv, sk, d), dt))
                got = fa.flash_attention(q, k, v, causal=causal, window=window)
                want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
                err = check_close(torch, got, want, ATOL[name], RTOL,
                                  f"sweep {(b, hq, hkv, sq, sk, d)} "
                                  f"causal={causal} window={window} {name}")
                errs[name] = max(errs[name], err)
                cases += 1
    torch.cuda.synchronize()
    emit({"phase": "kernel_sweep", "kernel": "flash_attention", "cases": cases,
          "max_abs_err": errs, "atol": ATOL, "rtol": RTOL})

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
          "dtype": "bfloat16", "causal": True, "flops": flops, "bytes": nbytes,
          "flops_bound_ms": flops_ms, "bytes_bound_ms": bytes_ms,
          "fp32_core_bound_ms": flops / PEAK_FP32_FLOPS * 1e3,
          "achieved_tflops": flops / (ms * 1e-3) / 1e12,
          "roofline_share": bound_ms / ms, **row})
    return row


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


def ssd_plan(ssd, shape):
    bsz, _, h, p, _, n = shape
    return ssd.plan(bsz, h, p, n)


def ssd_work(shape, chunk):
    """Operations and bytes one call needs at ``shape`` with B/C in bf16:
    the causal half of the intra-chunk products at the kernel's chunk
    length, the state products, and each input read and output written
    once in fp32 (B/C in bf16)."""
    bsz, s, h, p, g, n = shape
    nc = -(-s // chunk)
    per_chunk = chunk * (chunk + 1) // 2 * (n + p) * 2 + 2 * chunk * p * n * 2
    flops = bsz * h * nc * per_chunk
    nbytes = (4 * bsz * s * h * p * 2          # xdt in, y out
              + 4 * bsz * s * h                # dta
              + 2 * bsz * s * g * n * 2        # B, C
              + 4 * bsz * h * p * n)           # final state
    return flops, nbytes


def phase_ssd_kernel(torch, ops, ssd, ref):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 2)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    err, cases = 0.0, 0
    for shape, bc_name in SSD_SWEEP:
        for with_init in (False, True):
            x, dt, a_log, B, C, init = ssd_inputs(torch, gen, shape, dtypes[bc_name],
                                                  with_init, 8.0)
            x = x.float()
            got_y, got_f = ops.ssd_scan(x, dt, a_log, B, C, chunk=16, init_state=init)
            want_y, want_f = ref.ssd_scan_ref(x, dt, a_log, B, C, init_state=init)
            what = f"ssd sweep {shape} B/C {bc_name} init={with_init}"
            err = max(err, check_close(torch, got_y, want_y, SSD_ATOL, 0.0, what + " y"),
                      check_close(torch, got_f, want_f, SSD_ATOL, 0.0, what + " state"))
            cases += 1
    torch.cuda.synchronize()
    emit({"phase": "kernel_sweep", "kernel": "ssd_scan", "cases": cases,
          "max_abs_err": err, "atol": SSD_ATOL})

    # the serving shape and one long prompt, as the model calls the kernel:
    # x and B/C in bf16, a_log = log(linspace(1, 16, H)); the raw fp32
    # output against the fp32 plain version on the same inputs
    rows = {}
    for name, shape in (("serving", SSD_SERVE_SHAPE), ("long", SSD_LONG_SHAPE)):
        bsz, s, h, p, g, n = shape
        x, dt, a_log, B, C, _ = ssd_inputs(torch, gen, shape, torch.bfloat16, False, 16.0)
        a = -torch.exp(a_log)
        xdt, dta = x.float() * dt[..., None], dt * a
        got_y, got_f = ssd.ssd_scan(xdt, dta, B, C)
        want_y, want_f = ref.ssd_scan_ref(x.float(), dt, a_log, B, C)
        err = max(check_close(torch, got_y, want_y, SSD_ATOL, 0.0, f"ssd {name} y"),
                  check_close(torch, got_f, want_f, SSD_ATOL, 0.0, f"ssd {name} state"))
        del got_y, got_f, want_y, want_f
        ms = cuda_ms(torch, lambda: ssd.ssd_scan(xdt, dta, B, C), iters=20)
        plain_ms = cuda_ms(torch, lambda: ref.ssd_scan_ref(x.float(), dt, a_log, B, C),
                           iters=2, warmup=1)
        plan = ssd_plan(ssd, shape)
        flops, nbytes = ssd_work(shape, plan["chunk"])
        flops_ms = flops / PEAK_TF32_FLOPS * 1e3
        bytes_ms = nbytes / PEAK_HBM_BYTES * 1e3
        bound_ms = max(flops_ms, bytes_ms)
        rows[name] = {"name": "ssd_scan", "route": "cuda",
                      "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
                      "replaces": "src/repro/kernels/ssd_scan.py:75",
                      "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": bound_ms,
                      "bound_by": "operations" if flops_ms >= bytes_ms else "bytes",
                      "library_ms": None}
        emit({"phase": f"kernel_{name}_shape", "kernel": "ssd_scan",
              "shape": {"x": [bsz, s, h, p], "B": [bsz, s, g, n]}, "bc_dtype": "bfloat16",
              "plan": plan, "flops": flops, "bytes": nbytes,
              "flops_bound_ms_tf32": flops_ms, "bytes_bound_ms": bytes_ms,
              "fp32_core_bound_ms": flops / PEAK_FP32_FLOPS * 1e3,
              "achieved_tflops": flops / (ms * 1e-3) / 1e12,
              "achieved_tb_per_s": nbytes / (ms * 1e-3) / 1e12,
              "roofline_share": bound_ms / ms, "library": SSD_NO_LIBRARY,
              **rows[name]})
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
    """pallas vs xla at 1024 tokens (one replica's batch) and on one 8192-
    token prompt, whose xla side scans chunks (S >= SSD_SCAN_THRESHOLD):
    checked on an fp32 copy of the weights, reported on the bf16 ones."""
    from repro_torch.models.model import init_params, prefill

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 3)
    long_prompt = torch.randint(0, cfg.vocab_size, (1, LONG_PROMPT_LEN), generator=gen,
                                device=dev)
    out = {"rel_tol_fp32": SSM_PREFILL_REL_TOL}
    cases = (("1024", prompts, MAX_LEN), ("8192", long_prompt, LONG_PROMPT_LEN))
    for name, toks, max_len in cases:
        out[f"bf16_{name}"] = prefill_gap(torch, prefill, params, toks, cfg, max_len)
    params32 = init_params(cfg, SEED, device=dev, dtype=torch.float32)
    for name, toks, max_len in cases:
        gap = prefill_gap(torch, prefill, params32, toks, cfg, max_len)
        if gap["rel_l2"] > SSM_PREFILL_REL_TOL:
            raise AssertionError(f"fp32 pallas vs xla prefill logits at {name} tokens: "
                                 f"rel L2 {gap['rel_l2']} > {SSM_PREFILL_REL_TOL}")
        out[f"fp32_{name}"] = gap
    return out


def phase_serve(torch, counters, cfg, dev, kernel, compare):
    """Serve ``cfg`` for ROUNDS rounds; ``kernel`` must launch once per
    layer and prefill call, the other counters not at all."""
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
    want = {name: cfg.n_layers * prefill_calls if name == kernel else 0
            for name in counters}
    if launches != want:
        raise AssertionError(f"{cfg.name}: launches {launches} for {prefill_calls} "
                             f"prefill calls, want {want}")
    peak = torch.cuda.max_memory_allocated()

    emit({"phase": "serve_check", "arch": cfg.name, "prefill_calls": prefill_calls,
          "launches": launches, "launches_per_prefill": cfg.n_layers,
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
        got = ops.skewed_bucket(h, c)
        want = ref.skewed_bucket_ref(h, c)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"skewed_bucket {what}: "
                                 f"{int((got != want).sum())} buckets differ "
                                 "from the plain version")
        if not np.array_equal(got.cpu().numpy(), bucket_of(hashes, caps)):
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
    emit({"phase": "kernel_sweep", "kernel": "skewed_bucket", "cases": cases,
          "max_abs_err": err, "tolerance": "exact"})

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
    return row


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
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        got = job.run(PR_CHECK_ITERS)
        torch.cuda.synchronize()
    del job
    kernels = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms, n = kernels.get(e.name, (0.0, 0))
            kernels[e.name] = (ms + (e.time_range.end - e.time_range.start) / 1e3, n + 1)
    if not kernels:
        raise AssertionError("pagerank: the profiler recorded no device activity")
    emit({"phase": "pagerank_profile", "iters": PR_CHECK_ITERS,
          "device_ms": sum(ms for ms, _ in kernels.values()),
          "by_kernel": [[name[:100], ms, n] for name, (ms, n) in
                        sorted(kernels.items(), key=lambda kv: -kv[1][0])]})
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
    smem = {"flash_attention": {"smem_bytes_by_head_dim":
                                {d: fa.smem_bytes(d) for d in (16, 32, 64, 128)}},
            "ssd_scan": {"plan_serving": ssd_plan(ssd, SSD_SERVE_SHAPE),
                         "plan_long": ssd_plan(ssd, SSD_LONG_SHAPE)},
            "skewed_bucket": {"max_buckets": sb.MAX_BUCKETS}}
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
        torch, counters, get_config(ARCH), dev, "flash_attention", compare_granite)
    torch.cuda.empty_cache()
    rows["ssd_scan"]["launches"] = phase_serve(
        torch, counters, get_config(SSM_ARCH), dev, "ssd_scan", compare_mamba)
    torch.cuda.empty_cache()
    rows["skewed_bucket"]["launches"] = phase_pagerank(torch, np, counters, pr,
                                                       skewed_hash, sim)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [{k: rows[kernel][k] for k in keys} for kernel in KERNELS]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": card, "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
