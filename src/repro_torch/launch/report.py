"""Render the dry-run/roofline markdown tables from the dry-run's records.

Port of ``repro/launch/report.py`` over ``launch.dryrun``'s records
(artifacts/dryrun_torch/*.json). The reference's columns that come from
XLA's compile (compile seconds, temp bytes, HLO bytes, collective bytes)
have no source in the port (``launch.op_cost.NOT_MEASURED``); the tables
show the per-device argument bytes, the FLOPs per device and the sharding
fallbacks instead, and the collective term as not measured.

  PYTHONPATH=src python -m repro_torch.launch.report artifacts/dryrun_torch
"""
from __future__ import annotations

import glob
import json
import os
import sys
from typing import Dict, List

from repro_torch.configs import ARCH_IDS
from repro_torch.configs.shapes import ALL_SHAPES

NOT_MEASURED = "not measured"


def load(dirname: str) -> List[Dict]:
    recs = []
    for path in sorted(glob.glob(os.path.join(dirname, "*.json"))):
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def _fmt_gb(b: float) -> str:
    return f"{b / 1e9:.2f}"


def _rows(recs: List[Dict], mesh: str) -> List[Dict]:
    order = {a: i for i, a in enumerate(ARCH_IDS)}
    sorder = {s.name: i for i, s in enumerate(ALL_SHAPES)}
    return sorted([r for r in recs if r["mesh"] == mesh and not r.get("tag")],
                  key=lambda r: (order[r["arch"]], sorder[r["shape"]]))


def dryrun_table(recs: List[Dict], mesh: str) -> str:
    lines = [
        "| arch | shape | status | args GB/dev | GFLOPs/dev | GFLOPs step |"
        " fallbacks | coll GB/dev |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in _rows(recs, mesh):
        if r["status"] != "ok":
            status = "skipped" if r["status"] == "skipped" else "ERROR"
            lines.append(f"| {r['arch']} | {r['shape']} | {status} | — | — | — | — | — |")
            continue
        ma, oc = r["memory_analysis"], r["op_cost"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | ok "
            f"| {_fmt_gb(ma['argument_size_in_bytes'])} "
            f"| {oc['flops_per_device'] / 1e9:,.0f} | {oc['flops'] / 1e9:,.0f} "
            f"| {len(r['sharding_fallbacks'])} | {NOT_MEASURED} |")
    return "\n".join(lines)


def roofline_table(recs: List[Dict], mesh: str) -> str:
    lines = [
        "| arch | shape | compute s | memory s (args) | collective s |"
        " bottleneck | useful ratio | next move |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in _rows(recs, mesh):
        if r["status"] == "skipped":
            lines.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                         f"skipped(full-attn) | — | — |")
            continue
        if r["status"] == "error":
            lines.append(f"| {r['arch']} | {r['shape']} | — | — | — | ERROR "
                         f"| — | — |")
            continue
        ro = r["roofline"]
        coll = NOT_MEASURED if ro["collective_s"] is None else f"{ro['collective_s']:.3f}"
        lines.append(
            f"| {r['arch']} | {r['shape']} | {ro['compute_s']:.3f} "
            f"| {ro['memory_s']:.3f} | {coll} | {ro['bottleneck']} "
            f"| {min(ro['useful_ratio'], 99.0):.2f} | {r['hint'][:72]} |")
    return "\n".join(lines)


def summary(recs: List[Dict]) -> str:
    base = [r for r in recs if not r.get("tag")]
    n_ok = sum(r["status"] == "ok" for r in base)
    n_skip = sum(r["status"] == "skipped" for r in base)
    n_err = sum(r["status"] == "error" for r in base)
    return (f"{len(base)} cells: {n_ok} ok, {n_skip} skipped "
            f"(documented long_500k full-attention skips), {n_err} errors")


def main() -> None:
    d = sys.argv[1] if len(sys.argv) > 1 else "artifacts/dryrun_torch"
    recs = load(d)
    print("## Summary\n")
    print(summary(recs) + "\n")
    for mesh in ("single", "multi"):
        print(f"\n## Dry-run — {mesh} "
              f"({'2x16x16=512' if mesh == 'multi' else '16x16=256'} devices)\n")
        print(dryrun_table(recs, mesh))
    print("\n## Roofline — single pod (16x16), H100 data-sheet rates\n")
    print(roofline_table(recs, "single"))
    print("\n## Roofline — multi-pod (2x16x16), H100 data-sheet rates\n")
    print(roofline_table(recs, "multi"))


if __name__ == "__main__":
    main()
