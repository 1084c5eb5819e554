"""input_specs(): meta-device stand-ins for every (arch x shape) cell.

Port of ``repro/launch/specs.py``: where the reference builds
``ShapeDtypeStruct`` pytrees with ``jax.eval_shape``, this builds the same
trees on ``torch.device("meta")`` — real shapes and dtypes, no storage —
through the port's own ``init_params``, ``train_state_init`` and
``init_decode_state``. Train cells produce (TrainState, batch); prefill
cells (params, prompt batch); decode cells (params, decode state, token,
enc_out).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchBundle, ModelConfig, ShapeConfig
from repro_torch.models.model import init_decode_state, init_params
from repro_torch.runtime.train_loop import train_state_init

Pytree = Any
META = torch.device("meta")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    """Model inputs for a full-sequence pass (train / prefill)."""
    b, s = shape.global_batch, shape.seq_len
    specs: Dict[str, torch.Tensor] = {}
    if cfg.frontend == "vision":
        from repro_torch.models.frontends import frontend_feature_dim
        specs["input_embeds"] = _meta((b, s, frontend_feature_dim(cfg)), torch.float32)
    else:
        specs["tokens"] = _meta((b, s), torch.int32)
    if shape.kind == "train":
        specs["labels"] = _meta((b, s), torch.int32)
    if cfg.encoder_layers > 0:
        from repro_torch.models.frontends import frontend_feature_dim
        specs["enc_feats"] = _meta((b, cfg.max_source_positions,
                                    frontend_feature_dim(cfg)), torch.float32)
    return specs


def params_abstract(cfg: ModelConfig) -> Pytree:
    return init_params(cfg, device=META)


def train_state_abstract(cfg: ModelConfig, bundle: ArchBundle) -> Pytree:
    return train_state_init(0, cfg, bundle, device=META)


def decode_cache_len(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """KV budget for a decode cell: the shape's seq_len capped at the arch's
    architectural max (whisper's decoder caps at 448 target positions)."""
    return min(shape.seq_len, cfg.max_seq_len)


def decode_specs(cfg: ModelConfig, shape: ShapeConfig,
                 ) -> Tuple[Pytree, torch.Tensor, Optional[torch.Tensor]]:
    """(decode state, token spec, enc_out spec or None)."""
    b = shape.global_batch
    state = init_decode_state(cfg, b, decode_cache_len(cfg, shape), device=META)
    tok = _meta((b,), torch.int32)
    enc = None
    if cfg.encoder_layers > 0:
        enc = _meta((b, cfg.max_source_positions, cfg.d_model), torch.bfloat16)
    return state, tok, enc


def input_specs(cfg: ModelConfig, bundle: ArchBundle, shape: ShapeConfig,
                ) -> Dict[str, Any]:
    """Everything the dry-run needs for one cell, keyed by role."""
    if shape.kind == "train":
        return {"state": train_state_abstract(cfg, bundle),
                "batch": batch_specs(cfg, shape)}
    if shape.kind == "prefill":
        return {"params": params_abstract(cfg),
                "batch": batch_specs(cfg, shape)}
    if shape.kind == "decode":
        state, tok, enc = decode_specs(cfg, shape)
        return {"params": params_abstract(cfg), "dstate": state,
                "token": tok, "enc_out": enc}
    raise ValueError(shape.kind)
