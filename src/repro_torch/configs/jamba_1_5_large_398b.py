"""jamba-1.5-large-398b — 72L d_model=8192 64H (GQA kv=8) d_ff=24576
vocab=65536, MoE 16e top-2, Mamba+attention 1:7 interleave (1 attention layer
per 8), MoE every other layer.  [arXiv:2403.19887; hf]
"""
from repro_torch.configs.base import (
    ArchBundle, AttentionConfig, MeshConfig, ModelConfig, MoEConfig, SSMConfig,
)

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    d_ff=24576,
    vocab_size=65_536,
    attention=AttentionConfig(n_heads=64, n_kv_heads=8, head_dim=128,
                              rope_style="none"),  # jamba uses no positional enc
    moe=MoEConfig(n_experts=16, top_k=2, every=2, offset=1),
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_width=4),
    attn_period=8,           # 1 attention : 7 mamba
    attn_offset=4,           # attention mid-period, per the jamba paper
    tie_embeddings=False,
    max_seq_len=262_144,
    sub_quadratic=True,
)

MESH = MeshConfig(fsdp=True, bf16_optimizer=True, remat="full", sequence_parallel=True,
                  expert_parallel=True)

BUNDLE = ArchBundle(model=CONFIG, mesh=MESH)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b-reduced",
        family="hybrid",
        n_layers=8,   # one full attn:mamba period
        d_model=64,
        d_ff=96,
        vocab_size=256,
        attention=AttentionConfig(n_heads=4, n_kv_heads=2, head_dim=16,
                                  rope_style="none"),
        moe=MoEConfig(n_experts=4, top_k=2, every=2, offset=1),
        ssm=SSMConfig(state_dim=16, head_dim=16, expand=2, conv_width=4, chunk=16),
        attn_period=8,
        attn_offset=4,
        tie_embeddings=False,
        max_seq_len=128,
        sub_quadratic=True,
    )
