"""Multi-pod dry-run: place and count every (arch x shape x mesh) cell.

Port of ``repro/launch/dryrun.py``. The reference lowers and compiles each
cell with XLA on 512 forced host devices; PyTorch has no ahead-of-time
compile of a sharded step, so per cell it:

  1. builds the production mesh ((16,16) or (2,16,16)) on a one-process
     ``fake`` group (``launch.mesh``), destroyed when the cell ends,
  2. builds meta-device stand-ins (``launch.specs.input_specs``),
  3. builds placements (``runtime.sharding``) with divisibility fallbacks,
  4. counts the per-device argument bytes from the placements' local
     shapes and the step's FLOPs over its meta run (``launch.op_cost``;
     the dense ``xla`` paths, as the reference's dry-run),
  5. records roofline terms into
     artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json.

A cell that raises is an error (a sharding or shape bug in this repo); the
sweep goes on and ``main`` exits 1 at the end. Nothing is timed (there is
no compile) and no environment variable is touched.

Usage:
  python -m repro_torch.launch.dryrun                         # full sweep
  python -m repro_torch.launch.dryrun --arch granite-3-8b --shape train_4k --mesh multi
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import multiprocessing
import os
import traceback
from concurrent.futures import ProcessPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs import ARCH_IDS, get_bundle
from repro_torch.configs.shapes import ALL_SHAPES, SHAPES, shape_skip_reason
from repro_torch.launch import specs as specs_mod
from repro_torch.launch.mesh import production_mesh
from repro_torch.launch.op_cost import (
    NOT_MEASURED, OpCost, count_by_groups, count_flops, dense_paths, tree_bytes,
)
from repro_torch.launch.roofline import compute_roofline, improvement_hint
from repro_torch.models.model import decode_step, params_axes, prefill
from repro_torch.runtime.sharding import (
    ShardingReport, axis_rules, batch_shardings, cache_shardings, shardings_for,
    train_state_shardings,
)
from repro_torch.runtime.train_loop import value_and_grad

MESHES = {"single": dict(multi_pod=False), "multi": dict(multi_pod=True)}
OUT = "artifacts/dryrun_torch"


@functools.lru_cache(maxsize=None)
def step_flops(bundle, shape_name: str) -> int:
    """FLOPs of the cell's step, all devices: the meta run of the train
    step's loss and gradients, the prefill, or one decode step, by layer
    groups; the prefill and decode steps on the dense paths (``op_cost``).
    The same for both meshes, so computed once per bundle and shape."""
    def count(cfg) -> int:
        return meta_step_flops(bundle.replace(model=cfg), shape_name)

    if SHAPES[shape_name].kind == "train":
        return count_by_groups(count, bundle.model)
    with dense_paths():
        return count_by_groups(count, bundle.model)


def meta_step_flops(bundle, shape_name: str) -> int:
    """FLOPs of the cell's step run once on meta tensors."""
    cfg, shape = bundle.model, SHAPES[shape_name]
    cell = specs_mod.input_specs(cfg, bundle, shape)
    if shape.kind == "train":
        return count_flops(value_and_grad, cell["state"].params, cell["batch"], cfg,
                           "xla", bundle.mesh.remat)[1]
    with torch.no_grad():
        if shape.kind == "prefill":
            batch = cell["batch"]
            return count_flops(prefill, cell["params"], batch.get("tokens"), cfg,
                               specs_mod.decode_cache_len(cfg, shape),
                               enc_feats=batch.get("enc_feats"),
                               input_embeds=batch.get("input_embeds"))[1]
        return count_flops(decode_step, cell["params"], cell["dstate"], cell["token"],
                           cfg, enc_out=cell["enc_out"])[1]


@functools.lru_cache(maxsize=None)
def cell_specs(bundle, shape_name: str) -> Dict[str, Any]:
    """``specs.input_specs`` of a cell; meta tensors hold no storage, so
    both meshes share one build."""
    return specs_mod.input_specs(bundle.model, bundle, SHAPES[shape_name])


def argument_bytes(bundle, shape_name: str, mesh, report: ShardingReport,
                   ) -> Dict[str, int]:
    """Per-device bytes of the cell's arguments by role, from the
    placements' local shapes."""
    cfg, shape = bundle.model, SHAPES[shape_name]
    mcfg = bundle.mesh
    cell = cell_specs(bundle, shape_name)
    if shape.kind == "train":
        return {"state": tree_bytes(cell["state"], train_state_shardings(
                    cfg, mesh, mcfg, cell["state"], report), mesh),
                "batch": tree_bytes(cell["batch"], batch_shardings(
                    cfg, mesh, mcfg, cell["batch"]), mesh)}
    # param_shardings over the cell's own meta params, without a rebuild
    p_sh = shardings_for(cell["params"], params_axes(cfg), mesh,
                         axis_rules(cfg, mesh, mcfg), report)
    out = {"params": tree_bytes(cell["params"], p_sh, mesh)}
    if shape.kind == "prefill":
        out["batch"] = tree_bytes(cell["batch"], batch_shardings(cfg, mesh, mcfg,
                                                                 cell["batch"]), mesh)
        return out
    out["dstate"] = tree_bytes(cell["dstate"], cache_shardings(
        cfg, mesh, mcfg, cell["dstate"], shape.global_batch, report), mesh)
    inputs = {"token": cell["token"]}
    if cell["enc_out"] is not None:
        inputs["enc_out"] = cell["enc_out"]
    out["inputs"] = tree_bytes(inputs, batch_shardings(cfg, mesh, mcfg, inputs), mesh)
    return out


def lower_cell(arch: str, shape_name: str, mesh_kind: str,
               overrides: Optional[Dict[str, Any]] = None) -> Tuple[Optional[OpCost], Dict]:
    """Returns (op cost, context dict), or (None, {"skip": reason}). Raises
    on failure."""
    bundle = get_bundle(arch)
    if overrides:
        overrides = dict(overrides)
        ssm_chunk = overrides.pop("ssm_chunk", None)
        model = bundle.model
        if ssm_chunk is not None:
            model = dataclasses.replace(
                model, ssm=dataclasses.replace(model.ssm, chunk=ssm_chunk))
        bundle = bundle.replace(
            model=model,
            mesh=dataclasses.replace(bundle.mesh, **overrides))
    cfg = bundle.model
    shape = SHAPES[shape_name]
    skip = shape_skip_reason(cfg, shape)
    if skip:
        return None, {"skip": skip}
    report = ShardingReport()
    with production_mesh(**MESHES[mesh_kind]) as mesh:
        n_chips = mesh.size()
        by_role = argument_bytes(bundle, shape_name, mesh, report)
    cost = OpCost(step_flops(bundle, shape_name), n_chips, sum(by_role.values()))
    return cost, {"cfg": cfg, "shape": shape, "n_chips": n_chips,
                  "argument_bytes_by_role": by_role, "fallbacks": report.fallbacks}


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: str,
             overrides: Optional[Dict[str, Any]] = None,
             tag: str = "", echo: bool = True) -> Dict[str, Any]:
    """One cell's record, written to ``out_dir`` (and a line printed when
    ``echo``)."""
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_kind, "tag": tag}
    try:
        cost, ctx = lower_cell(arch, shape_name, mesh_kind, overrides)
        if cost is None:
            rec["status"] = "skipped"
            rec["reason"] = ctx["skip"]
            return _write(rec, out_dir, echo)
        roof = compute_roofline(
            ctx["cfg"], ctx["shape"], n_chips=ctx["n_chips"],
            flops=cost.flops_per_device, bytes_accessed=cost.argument_bytes,
            ici_bytes=None, dcn_bytes=None)
        rec.update({
            "status": "ok",
            "n_chips": ctx["n_chips"],
            "memory_analysis": {"argument_size_in_bytes": float(cost.argument_bytes)},
            "argument_bytes_by_role": ctx["argument_bytes_by_role"],
            "op_cost": cost.summary(),
            "not_measured": list(NOT_MEASURED),
            "roofline": roof.as_dict(),
            "roofline_memory_bytes": "per-device argument bytes, each read once (a floor)",
            "hint": improvement_hint(roof),
            "sharding_fallbacks": ctx["fallbacks"],
        })
    except Exception as e:  # noqa: BLE001 — recorded, sweep continues
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    return _write(rec, out_dir, echo)


def _write(rec: Dict[str, Any], out_dir: str, echo: bool = True) -> Dict[str, Any]:
    os.makedirs(out_dir, exist_ok=True)
    tag = f"__{rec['tag']}" if rec.get("tag") else ""
    path = os.path.join(
        out_dir, f"{rec['arch']}__{rec['shape']}__{rec['mesh']}{tag}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    status = rec["status"]
    line = f"{rec['arch']:24s} {rec['shape']:12s} {rec['mesh']:7s} {status:8s}"
    if status == "ok":
        r = rec["roofline"]
        line += (f" args={rec['memory_analysis']['argument_size_in_bytes'] / 1e9:7.2f}GB"
                 f" GFLOP/dev={rec['op_cost']['flops_per_device'] / 1e9:12,.1f}"
                 f" c/m={r['compute_s']:.3f}/{r['memory_s']:.3f}s -> {r['bottleneck']}"
                 f" fallbacks={len(rec['sharding_fallbacks'])}")
    elif status == "skipped":
        line += f" ({rec['reason'][:60]})"
    else:
        line += f" {rec['error'][:90]}"
    if echo:
        print(line, flush=True)
    return rec


def sweep_arch(arch: str, shapes, meshes, out_dir: str = OUT, tag: str = "",
               echo: bool = True) -> List[str]:
    """Every cell of one arch; the statuses in order."""
    return [run_cell(arch, shape, mesh, out_dir, tag=tag, echo=echo)["status"]
            for shape in shapes for mesh in meshes]


def sweep(archs, shapes, meshes, out_dir: str = OUT, tag: str = "",
          workers: int = 1, echo: bool = True) -> Dict[str, int]:
    """Every cell of ``archs`` x ``shapes`` x ``meshes``; counts by status.
    ``workers`` > 1 sweeps the archs in that many fresh processes (each
    with its own fake group), all ended before this returns."""
    counts = {"ok": 0, "skipped": 0, "error": 0}
    if workers > 1:
        # the longest counts first: an arch's meta runs span two layer groups
        archs = sorted(archs, key=lambda a: -get_bundle(a).model.layer_period)
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(min(workers, len(archs)), mp_context=ctx) as pool:
            futures = [pool.submit(sweep_arch, arch, shapes, meshes, out_dir, tag, echo)
                       for arch in archs]
            per_arch = [f.result() for f in futures]
    else:
        per_arch = [sweep_arch(arch, shapes, meshes, out_dir, tag, echo) for arch in archs]
    for statuses in per_arch:
        for status in statuses:
            counts[status] += 1
    return counts


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=ARCH_IDS + [None])
    ap.add_argument("--shape", default=None,
                    choices=[s.name for s in ALL_SHAPES] + [None])
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--tag", default="")
    ap.add_argument("--workers", type=int, default=1,
                    help="processes to sweep the archs in")
    args = ap.parse_args()

    archs = [args.arch] if args.arch else ARCH_IDS
    shapes = [args.shape] if args.shape else [s.name for s in ALL_SHAPES]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    counts = sweep(archs, shapes, meshes, args.out, args.tag, args.workers)
    print(f"\ndry-run: {counts['ok']} ok, {counts['skipped']} skipped, "
          f"{counts['error']} errors")
    if counts["error"]:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
