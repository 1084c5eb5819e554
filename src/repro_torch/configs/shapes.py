"""The four assigned input-shape sets (same for every LM-family arch).

``decode_*`` / ``long_*`` lower ``serve_step`` (one new token against a KV
cache of ``seq_len``), NOT ``train_step``. ``long_500k`` requires a
sub-quadratic architecture (cfg.sub_quadratic) and is skipped otherwise —
the skip is recorded as an explicit roofline-table row.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.configs.base import ModelConfig, ShapeConfig

TRAIN_4K = ShapeConfig("train_4k", seq_len=4_096, global_batch=256, kind="train")
PREFILL_32K = ShapeConfig("prefill_32k", seq_len=32_768, global_batch=32, kind="prefill")
DECODE_32K = ShapeConfig("decode_32k", seq_len=32_768, global_batch=128, kind="decode")
LONG_500K = ShapeConfig("long_500k", seq_len=524_288, global_batch=1, kind="decode")

ALL_SHAPES: List[ShapeConfig] = [TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K]
SHAPES: Dict[str, ShapeConfig] = {s.name: s for s in ALL_SHAPES}


def shape_skip_reason(cfg: ModelConfig, shape: ShapeConfig) -> Optional[str]:
    """Return a reason string if (cfg, shape) must be skipped, else None."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return "skipped(full-attn): 512k decode requires sub-quadratic attention"
    return None


def applicable_shapes(cfg: ModelConfig) -> List[ShapeConfig]:
    return [s for s in ALL_SHAPES if shape_skip_reason(cfg, s) is None]
