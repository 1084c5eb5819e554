"""Carry weights between the JAX reference's parameter tree and the port.

The reference keeps parameters as nested dicts whose stack leaves carry a
leading ``(n_groups,)`` axis under ``stack/sub{j}/...`` (layer
``g * period + j`` is entry ``g`` of ``sub{j}``); an encoder-decoder
model's ``encoder/sub{j}/...`` is stacked the same way, by the encoder's
own period, and its decoder layers carry ``norm_cross`` and ``cross``. A dict of leaves becomes
an ``nn.ParameterDict``; one that also nests a dict (the SSM mixer's
``gate_norm``) becomes a ``ParamTree``. Leaves here are numpy arrays; bf16
leaves arrive either as ml_dtypes ``bfloat16`` arrays or as their
``uint16`` bit view (the reference checkpointer's npz convention) and move
bit-exactly. ``reference_paths`` is the one statement of the layout: the
converter and the checkpointer (``repro_torch.checkpoint``) both go
through it. A model built here or by ``models.model.init_params`` records
its ``layer_period`` (and ``encoder_period``), so the layout can be
recovered from the model alone.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from repro_torch import devices
from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as model_mod
from repro_torch.models import transformer
from repro_torch.models.layers import ParamTree

Tree = Dict[str, Any]
STACKS = ("stack", "encoder")       # the reference's stacked (n_groups, ...) trees


def _to_torch(a: np.ndarray, device: torch.device) -> nn.Parameter:
    a = np.array(a)        # a copy: the port never aliases the caller's buffers
    if a.dtype.name == "bfloat16" or a.dtype == np.uint16:
        # int16 carries the bits: torch has full int16 support in every version
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return nn.Parameter(t.to(device), requires_grad=False)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _params(tree: Tree, device: torch.device,
            index: Optional[int] = None) -> Union[nn.ParameterDict, ParamTree]:
    """A module of ``tree``'s leaves, each sliced at ``index`` when given."""
    def leaf(a):
        return _to_torch(a if index is None else a[index], device)

    if not any(isinstance(a, dict) for a in tree.values()):
        return nn.ParameterDict({k: leaf(a) for k, a in tree.items()})
    return ParamTree({k: _params(a, device, index) if isinstance(a, dict) else leaf(a)
                      for k, a in tree.items()})


def reference_paths(model: nn.Module, period: int) -> Dict[Tuple[str, ...], List[str]]:
    """Each leaf of the reference's parameter tree, by key path -> the port's
    parameter names it holds. A ``stack`` leaf holds layers ``j, j + period,
    ...`` (stacked along its leading ``(n_groups,)`` axis, in that order)
    under ``("stack", f"sub{j}", ...)``; an ``encoder`` leaf likewise by the
    model's ``encoder_period``; any other leaf holds one name."""
    periods = {"stack": period, "encoder": getattr(model, "encoder_period", 1)}
    paths: Dict[Tuple[str, ...], List[str]] = {}
    for name, _ in model.named_parameters():
        parts = name.split(".")
        if parts[0] in STACKS:
            key = (parts[0], f"sub{int(parts[1]) % periods[parts[0]]}", *parts[2:])
        else:
            key = tuple(parts)
        paths.setdefault(key, []).append(name)
    return paths


def is_stacked(path: Tuple[str, ...]) -> bool:
    return path[0] in STACKS


def _stack(tree: Tree, n_layers: int, period: int, device: torch.device) -> nn.ModuleList:
    """One module per layer from a stacked tree of ``sub{j}`` groups."""
    layers = []
    for g in range(n_layers // period):
        for j in range(period):
            layers.append(nn.ModuleDict({name: _params(leaves, device, g)
                                         for name, leaves in tree[f"sub{j}"].items()}))
    return nn.ModuleList(layers)


def from_jax_params(tree: Tree, cfg: ModelConfig, *,
                    device: Union[str, torch.device] = "cuda") -> nn.ModuleDict:
    """The reference's parameter tree (numpy leaves) -> the port's model,
    value for value."""
    transformer.check_ported(cfg)
    dev = devices.resolve(device)
    model = nn.ModuleDict({"stack": _stack(tree["stack"], cfg.n_layers,
                                           cfg.layer_period, dev)})
    for key in ("embed", "final_norm", "unembed"):
        if key in tree:
            model[key] = _params(tree[key], dev)
    if cfg.encoder_layers > 0:
        enc_cfg = model_mod._encoder_cfg(cfg)
        model["encoder"] = _stack(tree["encoder"], enc_cfg.n_layers,
                                  enc_cfg.layer_period, dev)
        model["enc_norm"] = _params(tree["enc_norm"], dev)
    if "adapter" in tree:
        model["adapter"] = _params(tree["adapter"], dev)
    model_mod.record_periods(model, cfg)
    return model


def to_jax_layout(model: nn.ModuleDict, cfg: ModelConfig) -> Tree:
    """The inverse of ``from_jax_params``: numpy leaves, stack leaves
    stacked along ``(n_groups,)``, bf16 as its ``uint16`` bit view."""
    named = dict(model.named_parameters())
    tree: Tree = {}
    for path, names in reference_paths(model, cfg.layer_period).items():
        leaves = [_to_numpy(named[n]) for n in names]
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.stack(leaves) if is_stacked(path) else leaves[0]
    return tree
