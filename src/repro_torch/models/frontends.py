"""Modality frontends.

Port of ``repro/models/frontends.py``. The audio and vision frontends are
stubs: callers hand precomputed frame or patch embeddings, and a linear
adapter maps those features into the backbone's d_model.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import Params, _dense_init

# Feature dims the (stubbed) frontends would emit.
AUDIO_FEATURE_DIM = 128      # e.g. 128-bin log-mel frame stack after conv
VISION_FEATURE_DIM = 1024    # pixtral-ViT patch embedding dim


def frontend_feature_dim(cfg: ModelConfig) -> int:
    return {"audio": AUDIO_FEATURE_DIM, "vision": VISION_FEATURE_DIM}[cfg.frontend]


def adapter_init(gen: torch.Generator, cfg: ModelConfig, *, dtype=torch.bfloat16,
                 device=None) -> nn.ParameterDict:
    return nn.ParameterDict({"w": _dense_init(gen, frontend_feature_dim(cfg), cfg.d_model,
                                              dtype=dtype, device=device)})


def adapter_apply(params: Params, feats: torch.Tensor) -> torch.Tensor:
    # frontend stubs may hand fp32 features; keep the backbone in param dtype
    return feats.to(params["w"].dtype) @ params["w"]


def stub_feature_shape(cfg: ModelConfig, batch: int, seq: int) -> Tuple[int, ...]:
    """Shape of the precomputed embeddings the backbone takes."""
    return (batch, seq, frontend_feature_dim(cfg))
