"""Logical-axis -> mesh placements with automatic divisibility fallback.

Port of ``repro/runtime/sharding.py``. Model code names every parameter
and cache leaf's *logical* axes (``models.model.params_axes``,
``models.transformer.cache_axes``). This module maps them onto the
production mesh per the ArchBundle's MeshConfig:

  heads / kv_heads / mlp / vocab / expert / ssm_inner / ssm_conv -> "model"  (TP/EP)
  embed         -> ("pod","data") under FSDP (ZeRO-3), else replicated
  batch         -> ("pod","data")   (pure DP across pods)
  cache_seq     -> "model" only when kv heads don't divide the model axis
  seq (activations) -> "data" for long-context decode (sequence parallelism)
  layers        -> never sharded (the reference's scan axis; the port keeps
                   one module per layer, so no leaf has it)

Every mapping is validated against the actual leaf dim: if the mesh-axis
product doesn't divide it, the rule falls back to replication for that leaf
instead of sharding unevenly. Fallbacks are recorded so the dry-run can
report them.

``axis_rules``, ``ShardingReport`` and ``_spec_for`` keep the reference's
logic line for line, pure Python over a mesh's ``shape`` (sizes by axis
name) and ``axis_names``; ``_spec_for`` returns the spec's per-dimension
tuple (the reference's ``PartitionSpec`` entries). ``placements`` turns a
spec into DTensor placements on a ``DeviceMesh``: ``Shard(d)`` on each mesh
dimension the spec names for tensor dimension ``d``, ``Replicate()``
elsewhere. The ``*_shardings`` functions return flat dicts ``{leaf name:
placements}`` keyed by the port's own parameter and cache names (a train
state's under ``params.``, ``opt.mu.``, ``opt.nu.`` and ``ef.``, a decode
state's under ``cache.``); ``place`` distributes a tree by them.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard, distribute_tensor
from torch.overrides import TorchFunctionMode

from repro_torch.configs.base import MeshConfig, ModelConfig

Pytree = Any
Spec = Tuple[Any, ...]
Placements = Tuple[Placement, ...]

MODEL_AXES = ("heads", "kv_heads", "mlp", "vocab", "expert", "ssm_inner",
              "ssm_conv", "kv_heads_cache")


class MeshAxes(NamedTuple):
    """A mesh's sizes by axis name and its axis names, in mesh order: what
    the rules read of the reference's ``jax.sharding.Mesh``."""
    shape: Dict[str, int]
    axis_names: Tuple[str, ...]


def mesh_axes(mesh) -> MeshAxes:
    """``mesh``'s axes: a ``DeviceMesh``'s ``mesh_dim_names`` and sizes, or
    any object that has ``shape`` by name and ``axis_names`` already."""
    if isinstance(mesh, DeviceMesh):
        names = tuple(mesh.mesh_dim_names or ())
        if len(names) != mesh.ndim:
            raise ValueError("the mesh needs a name for every dimension (mesh_dim_names)")
        return MeshAxes(dict(zip(names, mesh.shape)), names)
    return MeshAxes(dict(mesh.shape), tuple(mesh.axis_names))


def _data_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def axis_rules(cfg: ModelConfig, mesh, mesh_cfg: MeshConfig,
               ) -> Dict[str, Optional[Tuple[str, ...]]]:
    """Logical-name -> mesh-axes tuple (None = replicated)."""
    mesh = mesh_axes(mesh)
    data = _data_axes(mesh)
    # FSDP axes: by default exclude "pod" so parameter all-gathers stay inside
    # a pod and the cross-pod links only carry the per-step gradient all-reduce
    fsdp_axes = data if mesh_cfg.fsdp_pod else tuple(
        a for a in data if a != "pod")
    rules: Dict[str, Optional[Tuple[str, ...]]] = {
        "layers": None,
        "batch": data,
        "embed": fsdp_axes if mesh_cfg.fsdp else None,
        "seq": ("data",) if mesh_cfg.sequence_parallel else None,
    }
    for name in MODEL_AXES:
        rules[name] = ("model",)
    a = cfg.attention
    model_size = mesh.shape["model"] if "model" in mesh.axis_names else 1
    # KV-cache fallback: the cache layout is (..., seq, n_kv_heads, head_dim)
    # with the *head count* as its own dim — when it doesn't divide the
    # model axis (GQA kv=8 or 2 on a 16-way axis), shard the cache's
    # sequence dim instead (paged-KV style)
    if a is not None and a.n_kv_heads % max(model_size, 1) != 0:
        rules["kv_heads_cache"] = None
        rules["cache_seq"] = ("model",)
    else:
        rules["cache_seq"] = None
    # SSM decode state: (batch, heads, P, N) — shard heads on model
    rules["ssm_heads_cache"] = ("model",)
    return rules


class ShardingReport:
    """Collects per-leaf fallbacks for the dry-run log."""

    def __init__(self):
        self.fallbacks: List[str] = []

    def note(self, path: str, dim: int, size: int, axes: Tuple[str, ...]):
        self.fallbacks.append(
            f"{path} dim{dim}={size} not divisible by {axes} -> replicated")


def _spec_for(shape: Tuple[int, ...], names: Tuple, mesh,
              rules: Dict[str, Optional[Tuple[str, ...]]],
              report: Optional[ShardingReport], path: str = "") -> Spec:
    mesh = mesh_axes(mesh)
    used: set = set()
    parts: List[Optional[Tuple[str, ...]]] = []
    for d, name in enumerate(names):
        if name is None:
            parts.append(None)
            continue
        axes = rules.get(name)
        if axes is None:
            parts.append(None)
            continue
        axes = tuple(a for a in axes if a in mesh.axis_names and a not in used)
        if not axes:
            parts.append(None)
            continue
        prod = int(np.prod([mesh.shape[a] for a in axes]))
        if d >= len(shape) or shape[d] % prod != 0:
            # divisibility fallback: try a prefix of the axes tuple
            while axes and (d >= len(shape) or shape[d] % int(
                    np.prod([mesh.shape[a] for a in axes])) != 0):
                axes = axes[:-1]
            if not axes:
                if report is not None and d < len(shape):
                    parts.append(None)
                    report.note(path, d, shape[d], tuple(rules.get(name) or ()))
                    continue
                parts.append(None)
                continue
        used.update(axes)
        parts.append(axes if len(axes) > 1 else axes[0])
    return tuple(parts)


def placements(spec: Spec, mesh) -> Placements:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dimension:
    ``Shard(d)`` where the spec names that mesh axis for tensor dim ``d``,
    else ``Replicate()``. A dim split over several axes is split in mesh
    order (major to minor, as a PartitionSpec's axis tuple). A mesh axis of
    one rank splits nothing, so it takes ``Replicate()`` whatever the spec
    says: a one-rank mesh places every tensor whole, and the ops that
    cannot run on a sharded dim without a redistribution (a view that
    flattens it) never see one there."""
    mesh = mesh_axes(mesh)
    out: List[Placement] = [Replicate()] * len(mesh.axis_names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        idx = [mesh.axis_names.index(a) for a in ((entry,) if isinstance(entry, str) else entry)]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: dim {d} names mesh axes out of mesh order")
        for i in idx:
            if mesh.shape[mesh.axis_names[i]] > 1:
                out[i] = Shard(d)
    return tuple(out)


def replicated(mesh) -> Placements:
    return placements((), mesh)


# --------------------------------------------------------------------------
# trees: leaves by dotted name
# --------------------------------------------------------------------------

def _is_names(t) -> bool:
    return isinstance(t, tuple) and all(n is None or isinstance(n, str) for n in t)


def _fields(tree) -> Optional[Dict[str, Any]]:
    """The children of a container by name (None for a leaf)."""
    if isinstance(tree, dict):
        return {str(k): v for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {f: getattr(tree, f) for f in tree._fields}
    if isinstance(tree, (list, tuple)):
        return {str(i): v for i, v in enumerate(tree)}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return {f.name: getattr(tree, f.name) for f in dataclasses.fields(tree)}
    return None


def named_tensors(tree: Pytree, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """Every tensor leaf of ``tree`` with its dotted name: a module's
    parameters by ``named_parameters()``, containers by key, index or field.
    Other leaves (a decode state's Python ``length``) have no name."""
    if isinstance(tree, nn.Module):
        for name, p in tree.named_parameters():
            yield prefix + name, p
    elif isinstance(tree, torch.Tensor):
        yield prefix.rstrip("."), tree
    else:
        children = _fields(tree)
        for key, value in (children or {}).items():
            yield from named_tensors(value, f"{prefix}{key}.")


def _flat_axes(tree: Pytree, prefix: str = "") -> Dict[str, Tuple]:
    if _is_names(tree):
        return {prefix.rstrip("."): tree}
    out: Dict[str, Tuple] = {}
    for key, value in (_fields(tree) or {}).items():
        out.update(_flat_axes(value, f"{prefix}{key}."))
    return out


def shardings_for(abstract: Pytree, axes_tree: Pytree, mesh,
                  rules: Dict[str, Optional[Tuple[str, ...]]],
                  report: Optional[ShardingReport] = None) -> Dict[str, Placements]:
    """``{leaf name: placements}`` for the tensor leaves of ``abstract``
    (real or meta tensors) given the logical-axes tree (flat by name, or
    the same structure with tuples of names as leaves)."""
    axes = _flat_axes(axes_tree)
    leaves = dict(named_tensors(abstract))
    if set(leaves) != set(axes):
        raise ValueError(f"axes and leaves differ: {sorted(set(leaves) ^ set(axes))[:8]}")
    return {name: placements(_spec_for(tuple(t.shape), axes[name], mesh, rules, report, name),
                             mesh)
            for name, t in leaves.items()}


def place(tree: Pytree, mesh: DeviceMesh, shardings: Dict[str, Placements],
          prefix: str = "") -> Pytree:
    """``tree`` with every tensor leaf distributed on ``mesh`` by its
    placements (``distribute_tensor``; a DTensor is redistributed). A
    module's parameters are replaced in place, one at a time, so the
    unplaced copy of each is freed as the next is placed; containers are
    rebuilt and other leaves kept."""
    if isinstance(tree, nn.Module):
        for name, p in list(tree.named_parameters()):
            owner, _, leaf = name.rpartition(".")
            mod = tree.get_submodule(owner) if owner else tree
            new = nn.Parameter(_place_tensor(p.detach(), mesh, shardings[prefix + name]),
                               requires_grad=p.requires_grad)
            setattr(mod, leaf, new)
        return tree
    if isinstance(tree, torch.Tensor):
        return _place_tensor(tree, mesh, shardings[prefix.rstrip(".")])
    children = _fields(tree)
    if children is None:
        return tree
    placed = {k: place(v, mesh, shardings, f"{prefix}{k}.") for k, v in children.items()}
    if isinstance(tree, dict):
        return dict(zip(tree.keys(), placed.values()))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(**placed)
    if isinstance(tree, (list, tuple)):
        return type(tree)(placed.values())
    return type(tree)(**placed)


class _FoldProducts(TorchFunctionMode):
    """``x @ w`` with a placed ``x`` of three or more dims and a matrix
    ``w`` as one 2-D product over ``x``'s rows. ``torch.matmul`` folds such
    a product only where ``x``'s leading strides are contiguous, and a
    DTensor reports its own strides for size-one dims (a decode step's
    (B, 1, D)), which can send it to a batched product instead: folding
    here runs the kernels the unplaced step runs, so the two agree bit for
    bit."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in _MATMULS and len(args) == 2 and not kwargs:
            x, w = args
            if isinstance(x, DTensor) and x.dim() >= 3 and w.dim() == 2:
                out = x.reshape(-1, x.shape[-1]) @ w
                return out.reshape(*x.shape[:-1], w.shape[-1])
        return func(*args, **(kwargs or {}))


_MATMULS = (torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__)


@contextlib.contextmanager
def mesh_context(params: nn.Module) -> Iterator[None]:
    """For a step over ``params``: when they are placed (DTensors), plain
    tensors the step meets (token ids, positions and masks made inside the
    model) count as replicated — every rank holds them alike — and products
    fold as on plain tensors (``_FoldProducts``); otherwise nothing."""
    if not isinstance(next(params.parameters(), None), DTensor):
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication
    with implicit_replication(), _FoldProducts():
        yield


def _place_tensor(t: torch.Tensor, mesh: DeviceMesh, pl: Placements) -> DTensor:
    if isinstance(t, DTensor):
        return t.redistribute(mesh, pl)
    return distribute_tensor(t, mesh, pl)


def make_activation_constraint(mesh, mesh_cfg: MeshConfig, batch: int, seq: int):
    """Activation sharding hook, by kind:

      residual — (B,S,D): batch over ("pod","data"), seq over "model" when
                 sequence_parallel (Megatron-SP),
      hidden   — (B,S,D) before the unembed matmul: batch-sharded, rest
                 replicated,
      logits   — (B,S,V): batch over data, vocab over "model",
      moe_buffer — (B, E, cap, D): experts over "model" (the EP layout),
      ssm_state  — (B, H, P, N) SSD carry: heads over "model".

    Returns fn(x, kind="residual") or None when batch doesn't divide. The
    hook redistributes a DTensor to the kind's placements; a plain tensor
    passes through on a one-rank mesh and is refused on a larger one (it
    would hold the whole activation on every rank)."""
    axes = mesh_axes(mesh)
    data = _data_axes(axes)
    dprod = int(np.prod([axes.shape[a] for a in data]))
    if batch % dprod != 0:
        return None
    dspec = data if len(data) > 1 else data[0]
    seq_ok = (mesh_cfg.sequence_parallel and "model" in axes.axis_names
              and seq % axes.shape["model"] == 0)
    has_model = "model" in axes.axis_names
    specs = {
        "residual": (dspec, "model" if seq_ok else None, None),
        "hidden": (dspec, None, None),
        "logits": (dspec, None, "model" if has_model else None),
        "moe_buffer": (dspec, "model" if has_model else None, None, None),
        "ssm_state": (dspec, "model" if has_model else None, None, None),
    }
    _checked_dim = {"logits": -1, "moe_buffer": 1, "ssm_state": 1}
    ranks = int(np.prod(list(axes.shape.values())))

    def constrain(h, kind: str = "residual"):
        spec = specs[kind]
        d = _checked_dim.get(kind)
        if d is not None and spec[d] is not None \
                and h.shape[d] % axes.shape["model"] != 0:
            spec = (dspec,) + (None,) * (h.ndim - 1)
        if isinstance(h, DTensor):
            return h.redistribute(mesh, placements(spec, axes))
        if ranks > 1:
            raise ValueError(f"constrain({kind!r}): a plain tensor on a mesh of {ranks} "
                             "ranks; place the inputs first")
        return h

    return constrain


# --------------------------------------------------------------------------
# top-level placements
# --------------------------------------------------------------------------

def param_shardings(cfg: ModelConfig, mesh, mesh_cfg: MeshConfig,
                    report: Optional[ShardingReport] = None) -> Dict[str, Placements]:
    from repro_torch.models.model import init_params, params_axes
    abstract = init_params(cfg, device="meta")
    rules = axis_rules(cfg, mesh, mesh_cfg)
    return shardings_for(abstract, params_axes(cfg), mesh, rules, report)


def train_state_shardings(cfg: ModelConfig, mesh, mesh_cfg: MeshConfig,
                          state_abstract: Pytree,
                          report: Optional[ShardingReport] = None) -> Dict[str, Placements]:
    """Placements for a TrainState: params + mirrored opt moments; the
    error feedback replicated. Works off a meta (or real) state."""
    from repro_torch.models.model import params_axes
    rules = axis_rules(cfg, mesh, mesh_cfg)
    pax = params_axes(cfg)
    st = state_abstract
    out: Dict[str, Placements] = {}
    for field, sub in (("params", st.params), ("opt.mu", st.opt.mu), ("opt.nu", st.opt.nu)):
        out.update({f"{field}.{k}": v
                    for k, v in shardings_for(sub, pax, mesh, rules, report).items()})
    out.update({f"ef.{k}": replicated(mesh) for k, _ in named_tensors(st.ef)})
    return out


def batch_shardings(cfg: ModelConfig, mesh, mesh_cfg: MeshConfig,
                    batch_abstract: Dict[str, Any],
                    long_context: bool = False) -> Dict[str, Placements]:
    """Inputs: batch dim over ("pod","data"); for long-context single-row
    batches, the sequence dim goes over "data" instead (SP)."""
    axes = mesh_axes(mesh)
    data = _data_axes(axes)
    out = {}
    for k, v in batch_abstract.items():
        b = v.shape[0]
        prod = int(np.prod([axes.shape[a] for a in data]))
        if b % prod == 0:
            spec = [data if len(data) > 1 else data[0]] + [None] * (v.ndim - 1)
        elif len(v.shape) > 1 and long_context and v.shape[1] % axes.shape["data"] == 0:
            spec = [None, "data"] + [None] * (v.ndim - 2)
        else:
            spec = [None] * v.ndim
        out[k] = placements(tuple(spec), axes)
    return out


def cache_shardings(cfg: ModelConfig, mesh, mesh_cfg: MeshConfig,
                    cache_abstract: Pytree, batch: int,
                    report: Optional[ShardingReport] = None) -> Dict[str, Placements]:
    """Decode-state placements. Batch over ("pod","data") when divisible;
    otherwise (long_500k's batch=1) the cache sequence dim is sharded over
    "data" — sequence parallelism for the KV pages."""
    from repro_torch.models.transformer import cache_axes
    rules = axis_rules(cfg, mesh, mesh_cfg)
    axes = mesh_axes(mesh)
    data = _data_axes(axes)
    prod = int(np.prod([axes.shape[a] for a in data]))
    if batch % prod != 0:
        rules["batch"] = None
        # shard KV pages over "data" (plus "model" too when the kv-head dim
        # can't use it) — sequence parallelism for the cache
        if rules.get("kv_heads_cache") is None:
            rules["cache_seq2"] = ("data", "model")
        else:
            rules["cache_seq2"] = ("data",)
    ax = cache_axes(cfg)
    if batch % prod != 0:
        # rewrite the cache axes: the dim after batch gets "cache_seq2"
        def rewrite(t):
            if len(t) >= 2 and t[0] == "batch":
                lst = list(t)
                if lst[1] in (None, "cache_seq"):
                    lst[1] = "cache_seq2"
                return tuple(lst)
            return t
        ax = [{k: rewrite(t) for k, t in layer.items()} for layer in ax]
    # decode state = {"cache": ..., "length": Python int (not placed); a decode
    # step adds "pos", a plain tensor, after placement}
    return shardings_for(cache_abstract, {"cache": ax}, mesh, rules, report)
