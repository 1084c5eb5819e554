"""dbrx-132b — 40L d_model=6144 48H (GQA kv=8) d_ff=10752/expert, vocab=100352,
fine-grained MoE 16 experts top-4.  [hf:databricks/dbrx-base; unverified]
"""
from repro_torch.configs.base import (
    ArchBundle, AttentionConfig, MeshConfig, ModelConfig, MoEConfig,
)

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    d_ff=10752,
    vocab_size=100_352,
    attention=AttentionConfig(n_heads=48, n_kv_heads=8, head_dim=128,
                              rope_theta=500_000.0),
    moe=MoEConfig(n_experts=16, top_k=4),
    tie_embeddings=False,
    sub_quadratic=False,
)

MESH = MeshConfig(fsdp=True, bf16_optimizer=True, remat="full", sequence_parallel=True,
                  expert_parallel=True)

BUNDLE = ArchBundle(model=CONFIG, mesh=MESH)


def reduced() -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    return ModelConfig(
        name="dbrx-132b-reduced",
        family="moe",
        n_layers=2,
        d_model=64,
        d_ff=96,
        vocab_size=256,
        attention=AttentionConfig(n_heads=4, n_kv_heads=2, head_dim=16),
        moe=MoEConfig(n_experts=4, top_k=2),
        tie_embeddings=False,
        max_seq_len=128,
    )
