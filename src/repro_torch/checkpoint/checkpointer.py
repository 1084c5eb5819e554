"""Atomic checkpointing in the reference's on-disk format.

Port of ``repro/checkpoint/checkpointer.py``. Layout: <dir>/step_<N>/ containing
  arrays.npz   — flattened leaves keyed by '/'-joined key path
  meta.json    — step, leaf count, user metadata, integrity digest
  _COMPLETE    — commit marker written LAST (atomic rename); readers treat
                 a step dir without the marker as garbage from a crashed
                 writer (restart-safe, the paper's revocable-instance case)

The keys, the arrays (bf16 as its ``uint16`` bits) and the digest are the
reference's, so a checkpoint written by either package restores in the
other. A tree is nested dicts (keys in sorted order, as the reference
flattens them), lists, tuples and NamedTuples of tensors, numpy arrays and
Python scalars. The port's ``TrainState`` is written in the layout of the
reference's: ``params/stack/sub{j}/...`` stacked along ``(n_groups,)``,
``opt/step``, ``opt/mu/...``, ``opt/nu/...``, ``step`` (both steps int32)
and ``ef/...``; its moments and error feedback, dicts keyed by parameter
name, go through the same layout (``convert.reference_paths``).

Restoring checks each leaf's shape, casts to the ``like`` leaf's dtype as
the reference does, and writes into the ``like`` tree's tensors in place on
their device (a second copy of a large model's moments would not fit); the
tree returned holds those tensors, with new numpy arrays and scalars.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch import convert
from repro_torch.optim.adamw import AdamWState
from repro_torch.runtime.train_loop import TrainState

Pytree = Any
Leaf = Any                      # a tensor, numpy array or Python scalar
# one leaf on disk: its key, and the like tree's leaves it holds (several
# only for a stack leaf, stacked along a leading axis)
Entry = Tuple[str, List[Leaf], bool]

_SEP = "/"


def _period(params: nn.Module) -> int:
    period = getattr(params, "layer_period", None)
    if period is None:
        raise ValueError("the model does not record its layer_period: build it with "
                         "models.model.init_params or convert.from_jax_params")
    return period


def _named(prefix: str, params: nn.Module, values: Dict[str, torch.Tensor]) -> List[Entry]:
    """``values`` (tensors by parameter name) in the reference's layout."""
    return [(_SEP.join((prefix, *path)), [values[n] for n in names], convert.is_stacked(path))
            for path, names in sorted(convert.reference_paths(params,
                                                              _period(params)).items())]


def _step(value: int) -> np.ndarray:
    return np.asarray(value, dtype=np.int32)     # the reference's () int32 steps


def _entries(tree: Pytree, prefix: str = "") -> List[Entry]:
    """Every leaf of ``tree`` with its key, in the reference's flatten order."""
    def key(k) -> str:
        return f"{prefix}{_SEP}{k}" if prefix else str(k)

    if isinstance(tree, TrainState):
        params = tree.params
        out = _named(key("params"), params, dict(params.named_parameters()))
        out.append((key("opt/step"), [_step(tree.opt.step)], False))
        out += _named(key("opt/mu"), params, tree.opt.mu)
        out += _named(key("opt/nu"), params, tree.opt.nu)
        out.append((key("step"), [_step(tree.step)], False))
        if tree.ef:
            out += _named(key("ef"), params, tree.ef)
        return out
    if isinstance(tree, dict):
        return [e for k in sorted(tree) for e in _entries(tree[k], key(k))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [e for f in tree._fields for e in _entries(getattr(tree, f), key(f))]
    if isinstance(tree, (list, tuple)):
        return [e for i, v in enumerate(tree) for e in _entries(v, key(i))]
    if tree is None:
        return []
    return [(prefix, [tree], False)]


def _host(leaf: Leaf, copy: bool) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        arr = convert._to_numpy(leaf)      # bf16 as its uint16 bits
        return arr.copy() if copy and leaf.device.type == "cpu" else arr
    arr = np.asarray(leaf)
    return arr.copy() if copy else arr


def snapshot(tree: Pytree, copy: bool = True) -> Dict[str, np.ndarray]:
    """The tree's leaves on the host, keyed as on disk. With ``copy`` no
    array shares memory with the tree, so training may go on."""
    flat: Dict[str, np.ndarray] = {}
    for key, leaves, stacked in _entries(tree):
        flat[key] = (np.stack([_host(x, False) for x in leaves]) if stacked
                     else _host(leaves[0], copy))
    return flat


def _digest(flat: Dict[str, np.ndarray]) -> int:
    return sum(int(np.sum(np.abs(v).astype(np.float64)) * 1000) % (1 << 31)
               for v in flat.values()) % (1 << 31)


def save_checkpoint(directory: str, step: int, tree: Pytree,
                    metadata: Optional[Dict] = None) -> str:
    """Atomically write a checkpoint; returns the committed path. A dict of
    arrays keyed by path (``snapshot``) is written as it is."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(prefix=".tmp_ckpt_", dir=directory)
    try:
        flat = snapshot(tree, copy=False)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        meta = {"step": step, "n_leaves": len(flat), "digest": _digest(flat),
                "user": metadata or {}}
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        open(os.path.join(tmp, "_COMPLETE"), "w").close()
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)          # atomic commit
        return final
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty((), dtype=dtype).numpy().dtype


def _like_shape(leaves: List[Leaf], stacked: bool) -> Tuple[int, ...]:
    shape = tuple(np.shape(leaves[0]))
    return (len(leaves), *shape) if stacked else shape


def _cast(arr: np.ndarray, like: Leaf) -> Leaf:
    """``arr`` in the dtype of ``like``: a CPU tensor for a tensor, else the
    like's numpy dtype or Python type."""
    if isinstance(like, torch.Tensor):
        if like.dtype == torch.bfloat16 and arr.dtype == np.uint16:
            return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        if like.dtype == torch.bfloat16:
            return torch.from_numpy(np.asarray(arr, np.float32)).to(torch.bfloat16)
        return torch.from_numpy(np.asarray(arr, _np_dtype(like.dtype)))
    if isinstance(like, np.ndarray):
        return np.asarray(arr, like.dtype)
    return type(like)(arr)


@torch.no_grad()
def load_pytree(path: str, like: Pytree) -> Pytree:
    """Restore arrays into the structure of ``like`` (shape-checked, cast
    to each like leaf's dtype); its tensors are overwritten in place."""
    entries = _entries(like)
    loaded: Dict[str, Leaf] = {}
    with np.load(os.path.join(path, "arrays.npz")) as z:
        files = set(z.files)
        for key, leaves, stacked in entries:       # check every leaf first
            if key not in files:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            arr = z[key]
            want = _like_shape(leaves, stacked)
            if tuple(arr.shape) != want:
                raise ValueError(f"shape mismatch for {key}: {arr.shape} vs {want}")
            loaded[key] = _cast(arr, leaves[0])
    values: Dict[str, Leaf] = {}
    for key, leaves, stacked in entries:
        src = loaded[key]
        for i, leaf in enumerate(leaves):
            part = src[i] if stacked else src
            if isinstance(leaf, torch.Tensor):
                leaf.copy_(part)
            else:
                values[key] = part
    return _rebuild(like, values.get)


def _rebuild(tree: Pytree, new: Callable[[str], Optional[Leaf]], prefix: str = "") -> Pytree:
    """``tree`` with each non-tensor leaf replaced by ``new(key)``."""
    def key(k) -> str:
        return f"{prefix}{_SEP}{k}" if prefix else str(k)

    if isinstance(tree, TrainState):
        opt = AdamWState(int(new(key("opt/step"))), tree.opt.mu, tree.opt.nu)
        return TrainState(tree.params, opt, int(new(key("step"))), tree.ef)
    if isinstance(tree, dict):
        return {k: _rebuild(v, new, key(k)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(getattr(tree, f), new, key(f)) for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, new, key(i)) for i, v in enumerate(tree))
    if tree is None or isinstance(tree, torch.Tensor):
        return tree
    return new(prefix)


def restore_checkpoint(path: str, like: Pytree) -> Tuple[int, Pytree, Dict]:
    """Returns (step, tree, user metadata). Validates the commit marker."""
    if not os.path.exists(os.path.join(path, "_COMPLETE")):
        raise FileNotFoundError(f"{path} has no commit marker (partial write?)")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    tree = load_pytree(path, like)
    return meta["step"], tree, meta.get("user", {})
