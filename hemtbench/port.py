"""What the benchmark takes from the program under test, the PyTorch port
``repro_torch``: its model configuration, its parameter tree filled with
the benchmark's weights, its serving steps and batcher, and its kernels'
launch counters. Nothing else of the program is imported anywhere in the
benchmark."""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn


def model_config(spec: Dict):
    """The port's ``ModelConfig`` from the configuration file's ``port``."""
    from repro_torch.configs.base import AttentionConfig, ModelConfig, SSMConfig

    kw = dict(spec["port"])
    if "attention" in kw:
        kw["attention"] = AttentionConfig(**kw["attention"])
    if "ssm" in kw:
        kw["ssm"] = SSMConfig(**kw["ssm"])
    return ModelConfig(**kw)


def params(cfg, weights: Dict[str, torch.Tensor]) -> nn.ModuleDict:
    """The port's parameter tree holding ``weights`` themselves (no copy).
    Every parameter of the tree must be among them, at the same shape and
    dtype, and every weight must be used."""
    from repro_torch.models.model import init_params

    tree = init_params(cfg, 0, device="meta")
    names = dict(tree.named_parameters())
    if set(names) != set(weights):
        raise ValueError(f"{cfg.name}: the port's parameters and the benchmark's weights "
                         f"differ: {sorted(set(names) ^ set(weights))[:8]}")
    for name, p in names.items():
        w = weights[name]
        if tuple(p.shape) != tuple(w.shape) or p.dtype != w.dtype:
            raise ValueError(f"{cfg.name}: {name} is {tuple(p.shape)} {p.dtype} in the port, "
                             f"{tuple(w.shape)} {w.dtype} here")
        path, _, leaf = name.rpartition(".")
        tree.get_submodule(path)._parameters[leaf] = nn.Parameter(w, requires_grad=False)
    return tree


def serving(cfg, max_len: int, impl: str = "pallas"):
    """(prefill step, decode step) of the port's serving loop."""
    from repro_torch.runtime.serve_loop import make_prefill_step, make_serve_step

    return make_prefill_step(cfg, max_len, impl=impl), make_serve_step(cfg)


def batcher(replicas, mode: str, min_share: int):
    from repro_torch.runtime.serve_loop import HeMTBatcher

    return HeMTBatcher(replicas, mode=mode, min_share=min_share)


def launches() -> Dict[str, int]:
    """The port's own counters of hand-written kernel launches, by kernel
    and route."""
    from repro_torch.kernels import flash_attention, ssd_scan

    out = {"flash_attention": flash_attention.launches, "ssd_scan": ssd_scan.launches}
    for name, mod in (("flash_attention", flash_attention), ("ssd_scan", ssd_scan)):
        out.update({f"{name}.{route}": n for route, n in mod.launches_by_route.items()})
    return out
