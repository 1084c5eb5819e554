"""Architecture registry of the port: ``--arch <id>`` resolution for the
launchers and tests, the reference's ten archs."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (
    ArchBundle, AttentionConfig, MeshConfig, ModelConfig, MoEConfig,
    SSMConfig, ShapeConfig, TrainConfig, active_param_count, param_count,
    padded_vocab_size,
)
from repro_torch.configs.shapes import (
    ALL_SHAPES, DECODE_32K, LONG_500K, PREFILL_32K, SHAPES, TRAIN_4K,
    applicable_shapes, shape_skip_reason,
)

__all__ = [
    "ALL_SHAPES", "ARCH_IDS", "ArchBundle", "AttentionConfig", "DECODE_32K",
    "LONG_500K", "MeshConfig", "ModelConfig", "MoEConfig", "PREFILL_32K",
    "SHAPES", "SSMConfig", "ShapeConfig", "TRAIN_4K", "TrainConfig",
    "active_param_count", "all_bundles", "applicable_shapes", "get_bundle",
    "get_config", "get_reduced", "padded_vocab_size", "param_count",
    "shape_skip_reason",
]

# arch id -> module name
_ARCH_MODULES: Dict[str, str] = {
    "dbrx-132b": "dbrx_132b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "gemma3-12b": "gemma3_12b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "granite-3-8b": "granite_3_8b",
    "chatglm3-6b": "chatglm3_6b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "whisper-medium": "whisper_medium",
    "mamba2-2.7b": "mamba2_2_7b",
    "pixtral-12b": "pixtral_12b",
}

ARCH_IDS: List[str] = list(_ARCH_MODULES)


def _module(arch: str):
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")


def get_bundle(arch: str) -> ArchBundle:
    return _module(arch).BUNDLE


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_reduced(arch: str) -> ModelConfig:
    return _module(arch).reduced()


def all_bundles() -> Dict[str, ArchBundle]:
    return {a: get_bundle(a) for a in ARCH_IDS}
