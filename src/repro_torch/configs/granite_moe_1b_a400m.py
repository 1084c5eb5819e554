"""granite-moe-1b-a400m — 24L d_model=1024 16H (GQA kv=8) d_ff=512/expert,
vocab=49155, MoE 32 experts top-8.  [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
"""
from repro_torch.configs.base import (
    ArchBundle, AttentionConfig, MeshConfig, ModelConfig, MoEConfig,
)

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    d_ff=512,
    vocab_size=49_155,
    attention=AttentionConfig(n_heads=16, n_kv_heads=8, head_dim=64),
    moe=MoEConfig(n_experts=32, top_k=8),
    tie_embeddings=True,
    sub_quadratic=False,
)

MESH = MeshConfig(fsdp=False, remat="full", sequence_parallel=True, expert_parallel=True)

BUNDLE = ArchBundle(model=CONFIG, mesh=MESH)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m-reduced",
        family="moe",
        n_layers=2,
        d_model=64,
        d_ff=32,
        vocab_size=256,
        attention=AttentionConfig(n_heads=4, n_kv_heads=2, head_dim=16),
        moe=MoEConfig(n_experts=8, top_k=2),
        tie_embeddings=True,
        max_seq_len=128,
    )
