"""pixtral-12b — 40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072,
pixtral-ViT frontend (STUB per the brief — ``input_specs()`` provides
precomputed patch embeddings) + mistral-nemo backbone.
[hf:mistralai/Pixtral-12B-2409; unverified]
"""
from repro_torch.configs.base import ArchBundle, AttentionConfig, MeshConfig, ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    d_ff=14336,
    vocab_size=131_072,
    attention=AttentionConfig(n_heads=32, n_kv_heads=8, head_dim=128,
                              rope_theta=1_000_000.0),
    frontend="vision",
    tie_embeddings=False,
    sub_quadratic=False,
)

MESH = MeshConfig(fsdp=True, remat="full", sequence_parallel=True)

BUNDLE = ArchBundle(model=CONFIG, mesh=MESH)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="pixtral-12b-reduced",
        family="vlm",
        n_layers=2,
        d_model=64,
        d_ff=128,
        vocab_size=256,
        attention=AttentionConfig(n_heads=4, n_kv_heads=2, head_dim=16),
        frontend="vision",
        tie_embeddings=False,
        max_seq_len=128,
    )
