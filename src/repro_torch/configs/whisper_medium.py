"""whisper-medium — enc-dec, 24L(enc)+24L(dec) d_model=1024 16H (MHA kv=16)
d_ff=4096 vocab=51865, conv audio frontend (STUB per the brief —
``input_specs()`` provides precomputed frame embeddings).
[arXiv:2212.04356; unverified]

Decode shapes lower the *decoder* (self-attn KV cache + cross-attn over the
1500-frame encoder output). long_500k is skipped (full attention).
"""
from repro_torch.configs.base import ArchBundle, AttentionConfig, MeshConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,
    d_model=1024,
    d_ff=4096,
    vocab_size=51_865,
    attention=AttentionConfig(n_heads=16, n_kv_heads=16, head_dim=64,
                              rope_style="none"),  # whisper: learned/sinusoidal pos
    encoder_layers=24,
    max_source_positions=1500,
    frontend="audio",
    act="gelu",
    glu=False,
    tie_embeddings=True,
    max_seq_len=448,   # whisper decoder max target positions
    sub_quadratic=False,
)

MESH = MeshConfig(fsdp=False, remat="full", sequence_parallel=True)

BUNDLE = ArchBundle(model=CONFIG, mesh=MESH)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium-reduced",
        family="audio",
        n_layers=2,
        d_model=64,
        d_ff=128,
        vocab_size=256,
        attention=AttentionConfig(n_heads=4, n_kv_heads=4, head_dim=16,
                                  rope_style="none"),
        encoder_layers=2,
        max_source_positions=32,
        frontend="audio",
        act="gelu",
        glu=False,
        tie_embeddings=True,
        max_seq_len=64,
    )
