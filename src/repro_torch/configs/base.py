"""Config dataclasses for models, shapes, meshes and training.

A copy of the JAX package's ``repro/configs/base.py`` (stdlib only), kept
here so that the PyTorch port imports nothing of the JAX package. Every
ported architecture gets one module in ``repro_torch.configs`` exporting a
``CONFIG: ModelConfig`` with the exact published hyper-parameters, plus a
``reduced()`` constructor used by CPU smoke tests (same family, tiny sizes).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    # Which layers carry an MoE FFN: layer_idx % every == offset.
    every: int = 1
    offset: int = 0
    # Capacity factor for dispatch buffers (per-expert slots = tokens/E * factor).
    capacity_factor: float = 1.25
    # HeMT-EP: per-expert-shard relative capacities (None = homogeneous).
    # The skewed router (paper Algorithm 1) uses these to bucket tokens.
    shard_capacities: Optional[Tuple[float, ...]] = None
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) block hyper-parameters."""
    state_dim: int = 128
    head_dim: int = 64
    expand: int = 2            # d_inner = expand * d_model
    conv_width: int = 4
    chunk: int = 256           # SSD chunk length
    n_groups: int = 1          # B/C groups (like GQA for SSM)


@dataclass(frozen=True)
class AttentionConfig:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    # 0 = full attention. >0 = sliding-window size for *local* layers.
    sliding_window: int = 0
    # local:global pattern, e.g. (5, 1) = 5 local then 1 global per period.
    local_global: Tuple[int, int] = (0, 0)
    rope_style: str = "full"   # "full" | "half" (chatglm 2d-rope) | "none"
    rope_theta: float = 10_000.0
    causal: bool = True
    # softmax scale override (None -> 1/sqrt(head_dim))
    scale: Optional[float] = None


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    attention: Optional[AttentionConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # Hybrid interleave: 1 attention layer per `attn_period` layers (jamba 1:7 -> 8).
    # 0 => pure attention (or pure ssm if attention is None).
    attn_period: int = 0
    attn_offset: int = 0       # which index inside the period is the attention layer
    # Encoder-decoder (whisper): encoder_layers > 0 enables cross-attention decoder.
    encoder_layers: int = 0
    max_source_positions: int = 0
    frontend: str = "none"     # none | audio | vision  (stubs supply embeddings)
    norm_eps: float = 1e-5
    tie_embeddings: bool = True
    act: str = "silu"          # silu (SwiGLU) | gelu (plain MLP, whisper)
    glu: bool = True
    max_seq_len: int = 131_072
    sub_quadratic: bool = False  # eligible for long_500k decode
    dtype: str = "bfloat16"

    # ---- derived ----------------------------------------------------------
    @property
    def layer_period(self) -> int:
        """Structural repeat period for scan-over-layers grouping."""
        p = 1
        if self.attn_period:
            p = self.attn_period
        if self.moe is not None and self.moe.every > 1:
            import math
            p = p * self.moe.every // math.gcd(p, self.moe.every)
        if self.attention is not None and self.attention.local_global != (0, 0):
            lg = sum(self.attention.local_global)
            import math
            p = p * lg // math.gcd(p, lg)
        return p

    def layer_kind(self, idx: int) -> str:
        """'attn' | 'ssm' for layer `idx` of the decoder stack."""
        if self.ssm is not None and self.attention is None:
            return "ssm"
        if self.attn_period:
            return "attn" if idx % self.attn_period == self.attn_offset else "ssm"
        return "attn"

    def layer_is_moe(self, idx: int) -> bool:
        if self.moe is None:
            return False
        return idx % self.moe.every == self.moe.offset

    def layer_is_global_attn(self, idx: int) -> bool:
        """For local:global sliding-window patterns (gemma3)."""
        if self.attention is None or self.attention.local_global == (0, 0):
            return True
        loc, glb = self.attention.local_global
        return idx % (loc + glb) >= loc


def padded_vocab_size(cfg: ModelConfig, multiple: int = 256) -> int:
    """Embedding tables are padded to a multiple of 256 so the vocab dim
    shards over a 16-way model axis for every arch (granite 49155, whisper
    51865, mamba2 50280 are not otherwise divisible). Pad logits are masked
    to -inf in the loss/serve paths."""
    v = cfg.vocab_size
    return ((v + multiple - 1) // multiple) * multiple


def param_count(cfg: ModelConfig) -> int:
    """Total parameter count N (embedding included once if tied)."""
    n = 0
    d = cfg.d_model
    emb = cfg.vocab_size * d
    n += emb
    if not cfg.tie_embeddings:
        n += emb

    def attn_params() -> int:
        a = cfg.attention
        q = d * a.n_heads * a.head_dim
        kv = 2 * d * a.n_kv_heads * a.head_dim
        o = a.n_heads * a.head_dim * d
        return q + kv + o + 2 * d  # + pre/post norm scales

    def mlp_params(d_ff: int) -> int:
        per = (3 if cfg.glu else 2) * d * d_ff
        return per

    def moe_params() -> int:
        m = cfg.moe
        return m.n_experts * mlp_params(cfg.d_ff) + d * m.n_experts  # + router

    def ssm_params() -> int:
        s = cfg.ssm
        d_in = s.expand * d
        n_heads = d_in // s.head_dim
        zxbcdt = d * (2 * d_in + 2 * s.n_groups * s.state_dim + n_heads)
        conv = s.conv_width * (d_in + 2 * s.n_groups * s.state_dim)
        out = d_in * d
        extra = 2 * n_heads + d_in  # A_log, dt_bias, gate-norm scale
        return zxbcdt + conv + out + extra + 2 * d

    for i in range(cfg.n_layers):
        kind = cfg.layer_kind(i)
        if kind == "attn":
            n += attn_params()
        else:
            n += ssm_params()
        if cfg.ssm is not None and cfg.attention is None:
            continue  # pure-SSM blocks (mamba2) have no separate FFN
        if cfg.layer_is_moe(i):
            n += moe_params()
        else:
            n += mlp_params(cfg.d_ff)
    # encoder stack (whisper)
    for _ in range(cfg.encoder_layers):
        n += attn_params() + mlp_params(cfg.d_ff)
        n += attn_params()  # decoder cross-attention paired per layer
    n += d  # final norm
    return n


def active_param_count(cfg: ModelConfig) -> int:
    """Activated parameters per token (MoE: only top_k experts count)."""
    if cfg.moe is None:
        return param_count(cfg)
    full = param_count(cfg)
    d, m = cfg.d_model, cfg.moe
    per_exp = (3 if cfg.glu else 2) * d * cfg.d_ff
    n_moe_layers = sum(cfg.layer_is_moe(i) for i in range(cfg.n_layers))
    inactive = n_moe_layers * (m.n_experts - m.top_k) * per_exp
    return full - inactive


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


@dataclass(frozen=True)
class MeshConfig:
    """Production mesh + per-arch distribution strategy."""
    # Parallelism strategy knobs (consumed by runtime.sharding).
    fsdp: bool = False            # shard params over data axis too (ZeRO-3)
    fsdp_pod: bool = False        # let FSDP span the DCN "pod" axis too
                                  # (off: param gathers stay on ICI; the pod
                                  # axis only carries the grad all-reduce)
    bf16_optimizer: bool = False  # Gopher-style bf16 adam moments (>=100B models)
    remat: str = "none"           # none | dots | full
    sequence_parallel: bool = False
    expert_parallel: bool = False
    # HeMT-DP defaults
    grain_batch: int = 8          # per-grain micro-batch size (fixed shape)


@dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    seed: int = 0
    # gradient compression on the cross-pod (DCN) axis
    compression: str = "none"     # none | topk | int8


@dataclass(frozen=True)
class ArchBundle:
    """Everything the launcher needs for one assigned architecture."""
    model: ModelConfig
    mesh: MeshConfig = field(default_factory=MeshConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    def replace(self, **kw) -> "ArchBundle":
        return dataclasses.replace(self, **kw)
