"""Architecture registry of the port: only the archs whose path is ported."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (
    ArchBundle, AttentionConfig, MeshConfig, ModelConfig, MoEConfig,
    SSMConfig, ShapeConfig, TrainConfig, active_param_count, param_count,
    padded_vocab_size,
)

__all__ = [
    "ARCH_IDS", "ArchBundle", "AttentionConfig", "MeshConfig", "ModelConfig",
    "MoEConfig", "SSMConfig", "ShapeConfig", "TrainConfig", "active_param_count",
    "get_bundle", "get_config", "get_reduced", "padded_vocab_size", "param_count",
]

# arch id -> module name
_ARCH_MODULES: Dict[str, str] = {
    "granite-3-8b": "granite_3_8b",
    "mamba2-2.7b": "mamba2_2_7b",
}

ARCH_IDS: List[str] = list(_ARCH_MODULES)


def _module(arch: str):
    if arch not in _ARCH_MODULES:
        raise KeyError(f"arch {arch!r} is not ported yet; ported: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")


def get_bundle(arch: str) -> ArchBundle:
    return _module(arch).BUNDLE


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_reduced(arch: str) -> ModelConfig:
    return _module(arch).reduced()
