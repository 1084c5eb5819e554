"""deepseek-coder-33b — 62L d_model=7168 56H (GQA kv=8) d_ff=19200 vocab=32256,
llama-arch.  [arXiv:2401.14196; hf]
"""
from repro_torch.configs.base import ArchBundle, AttentionConfig, MeshConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    family="dense",
    n_layers=62,
    d_model=7168,
    d_ff=19200,
    vocab_size=32_256,
    attention=AttentionConfig(n_heads=56, n_kv_heads=8, head_dim=128,
                              rope_theta=100_000.0),
    tie_embeddings=False,
    sub_quadratic=False,
)

MESH = MeshConfig(fsdp=True, remat="full", sequence_parallel=True)

BUNDLE = ArchBundle(model=CONFIG, mesh=MESH)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="deepseek-coder-33b-reduced",
        family="dense",
        n_layers=2,
        d_model=64,
        d_ff=160,
        vocab_size=256,
        attention=AttentionConfig(n_heads=8, n_kv_heads=2, head_dim=8),
        tie_embeddings=False,
        max_seq_len=128,
    )
