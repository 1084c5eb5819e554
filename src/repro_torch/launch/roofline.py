"""Roofline terms from dry-run records (NVIDIA H100 SXM targets).

Port of ``repro/launch/roofline.py`` with the H100's constants in place of
the reference's TPU's:

    compute term    = FLOPs / peak_FLOPs                  [per device]
    memory term     = bytes / HBM_bw
    collective term = intra-node bytes / NVLink_bw + inter-node bytes / NIC_bw

The port's dry-run has FLOPs and bytes but no collective bytes
(``op_cost``): a term whose bytes were not measured is None, never a
guess, and takes no part in the bottleneck.

Hardware constants — NVIDIA H100 SXM data sheet, 700 W: 989 TFLOP/s dense
bf16 on the tensor cores; 3.35 TB/s HBM3; NVLink 900 GB/s per GPU, both
directions together, so 450 GB/s each way for a ring collective. Between
nodes — NVIDIA DGX H100 data sheet: eight ConnectX-7 400 Gb/s ports for
eight GPUs, 50 GB/s per GPU. These are data-sheet numbers, not
measurements.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.configs.base import ModelConfig, ShapeConfig, active_param_count

PEAK_FLOPS = 989e12          # bf16 / GPU, dense
HBM_BW = 3.35e12             # bytes/s / GPU
ICI_BW = 450e9               # NVLink, one direction of 900 GB/s
DCN_BW = 50e9                # one 400 Gb/s ConnectX-7 port per GPU


@dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: Optional[float]
    dcn_s: Optional[float]
    model_flops_per_dev: float
    flops: float
    bottleneck: str
    useful_ratio: float      # MODEL_FLOPS / counted FLOPs

    def as_dict(self) -> Dict:
        return {
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dcn_s": self.dcn_s,
            "bottleneck": self.bottleneck,
            "model_flops_per_dev": self.model_flops_per_dev,
            "flops_per_dev": self.flops,
            "useful_ratio": self.useful_ratio,
        }


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Analytic MODEL_FLOPS for the whole cell (all devices).

    train:   6 * N_active * tokens      (fwd + bwd)
    prefill: 2 * N_active * tokens      (fwd only)
    decode:  2 * N_active * batch       (one new token per sequence)
    """
    n_active = active_param_count(cfg)
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch


def compute_roofline(cfg: ModelConfig, shape: ShapeConfig, *, n_chips: int,
                     flops: float, bytes_accessed: float,
                     ici_bytes: Optional[float], dcn_bytes: Optional[float]) -> Roofline:
    """Per-device terms; ``ici_bytes``/``dcn_bytes`` None when not measured."""
    compute_s = flops / PEAK_FLOPS
    memory_s = bytes_accessed / HBM_BW
    terms = {"compute": compute_s, "memory": memory_s}
    collective_s = dcn_s = None
    if ici_bytes is not None and dcn_bytes is not None:
        dcn_s = dcn_bytes / DCN_BW
        collective_s = ici_bytes / ICI_BW + dcn_s
        terms["collective"] = collective_s
    mf = model_flops(cfg, shape) / n_chips
    bottleneck = max(terms, key=terms.get)
    return Roofline(compute_s, memory_s, collective_s, dcn_s, mf, flops,
                    bottleneck, mf / flops if flops else math.inf)


def improvement_hint(r: Roofline) -> str:
    if r.bottleneck == "compute":
        if r.useful_ratio < 0.6:
            return ("compute-bound with low useful ratio: cut remat recompute "
                    "or fuse the attention/router side computations")
        return "compute-bound near useful peak: only kernel-level wins remain"
    if r.bottleneck == "memory":
        return ("memory-bound: shrink materialized intermediates (remat "
                "policy, fp32->bf16 temps, sequence-parallel saved carries, "
                "fused loss)")
    return ("collective-bound: re-shard to shorten the all-reduce (FSDP "
            "prefix on data axis), overlap grad all-reduce with backward, "
            "or compress the cross-pod reduction")
