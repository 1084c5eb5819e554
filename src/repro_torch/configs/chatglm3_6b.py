"""chatglm3-6b — 28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024,
2d-RoPE (rotary applied to half the head dims), GQA.  [arXiv:2406.12793; hf]
"""
from repro_torch.configs.base import ArchBundle, AttentionConfig, MeshConfig, ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    d_ff=13696,
    vocab_size=65_024,
    attention=AttentionConfig(n_heads=32, n_kv_heads=2, head_dim=128,
                              rope_style="half"),
    tie_embeddings=False,
    sub_quadratic=False,
)

MESH = MeshConfig(fsdp=False, remat="full", sequence_parallel=True)

BUNDLE = ArchBundle(model=CONFIG, mesh=MESH)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-6b-reduced",
        family="dense",
        n_layers=2,
        d_model=64,
        d_ff=128,
        vocab_size=256,
        attention=AttentionConfig(n_heads=4, n_kv_heads=2, head_dim=16,
                                  rope_style="half"),
        tie_embeddings=False,
        max_seq_len=128,
    )
