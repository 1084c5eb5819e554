#!/usr/bin/env python3
"""Device timeline of the PyTorch port's serving steps on one CUDA card.

Serves a full-width, full-depth model (granite-3-8b, or mamba2-2.7b with
``--arch``; random weights from a seed) as ``chip_smoke.py`` does and
profiles two windows with ``torch.profiler``: one prefill of the largest
replica share (10 prompts of 1024 tokens, ``impl="pallas"``) and the 8
decode steps that follow it. For each window it prints one JSON line: the
host wall time with and without the profiler (both end in
``torch.cuda.synchronize()``), the device busy time (the union of the
kernel and copy intervals on the card), the busy share of the profiled
wall time, and device time by kind (the port's kernels by name, matrix
products, the rest) and by kernel name.

Run from the repo root on a machine with one card:

    python3 benchmarks/profile_torch_serving.py [--arch mamba2-2.7b]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SEED = 0
BATCH = 10
PROMPT_LEN = 1024
DECODE_STEPS = 8
MAX_LEN = PROMPT_LEN + 16
TOP = 12


def kind(name: str) -> str:
    if "flash_fwd_" in name:         # flash_fwd_wgmma_kernel (bf16), flash_fwd_kernel (fp32)
        return "flash_attention"
    if "ssd_scan_kernel" in name or "ssd_wgmma_kernel" in name:   # fp32, bf16
        return "ssd_scan"
    # cuBLAS(Lt) names its kernels nvjet_*, *gemm*, *gemv*, splitKreduce_*
    if any(s in name.lower() for s in ("nvjet", "gemm", "gemv", "splitk", "xmma", "cutlass")):
        return "matmul"
    return "other"


def device_intervals(prof, torch):
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.device_type == cuda]


def union_us(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for _, s, e in sorted(intervals, key=lambda x: x[1]):
        if e <= end:
            continue
        busy += e - max(s, end)
        end = e
    return busy


def timed(torch, fn) -> float:
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3


def window(torch, name: str, fn, steps: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    plain_ms = timed(torch, fn)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiled_ms = timed(torch, fn)
    ivs = device_intervals(prof, torch)
    if not ivs:
        raise RuntimeError(f"{name}: the profiler recorded no device activity")
    by_name, by_kind = defaultdict(float), defaultdict(float)
    for n, s, e in ivs:
        by_name[n] += e - s
        by_kind[kind(n)] += e - s
    busy_ms = union_us(ivs) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {"window": name, "steps": steps, "wall_ms": plain_ms,
            "profiled_wall_ms": profiled_ms, "device_busy_ms": busy_ms,
            "busy_share": busy_ms / profiled_ms, "device_events": len(ivs),
            "device_ms_by_kind": {k: v / 1e3 for k, v in sorted(by_kind.items())},
            "device_ms_top_kernels": [[n[:120], v / 1e3] for n, v in top]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-8b", choices=["granite-3-8b", "mamba2-2.7b"])
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_serving: needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.runtime.serve_loop import make_prefill_step, make_serve_step

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    cfg = get_config(args.arch)
    params = init_params(cfg, SEED, device=dev)
    prefill_step = make_prefill_step(cfg, MAX_LEN, impl="pallas")
    serve_step = make_serve_step(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT_LEN), generator=gen,
                            device=dev)

    tok, state = prefill_step(params, prompts)        # warm-up: library set-up
    for _ in range(2):
        tok, _, state = serve_step(params, state, tok)

    box = {}

    def prefill():
        box["tok"], box["state"] = prefill_step(params, prompts)

    def decode():
        tok, st = box["tok"], box["state"]
        # rewind: the same KV cache slots; an SSM state goes on from where it
        # is, which costs the same work
        st["length"] = PROMPT_LEN
        for _ in range(DECODE_STEPS):
            tok, _, st = serve_step(params, st, tok)

    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                      "torch": torch.__version__, "arch": cfg.name,
                      "n_layers": cfg.n_layers, "batch": BATCH,
                      "prompt_len": PROMPT_LEN}), flush=True)
    print(json.dumps(window(torch, "prefill", prefill, 1)), flush=True)
    print(json.dumps(window(torch, "decode", decode, DECODE_STEPS)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
