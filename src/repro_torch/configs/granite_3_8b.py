"""granite-3-8b — 40L d_model=4096 32H (GQA kv=8) d_ff=12800 vocab=49155, GQA.
[hf:ibm-granite/granite-3.0-2b-base; hf]
"""
from repro_torch.configs.base import ArchBundle, AttentionConfig, MeshConfig, ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b",
    family="dense",
    n_layers=40,
    d_model=4096,
    d_ff=12800,
    vocab_size=49_155,
    attention=AttentionConfig(n_heads=32, n_kv_heads=8, head_dim=128),
    tie_embeddings=True,
    sub_quadratic=False,
)

MESH = MeshConfig(fsdp=True, remat="full", sequence_parallel=True)

BUNDLE = ArchBundle(model=CONFIG, mesh=MESH)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="granite-3-8b-reduced",
        family="dense",
        n_layers=2,
        d_model=64,
        d_ff=128,
        vocab_size=256,
        attention=AttentionConfig(n_heads=4, n_kv_heads=2, head_dim=16),
        tie_embeddings=True,
        max_seq_len=128,
    )
