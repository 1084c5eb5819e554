"""gemma3-12b — 48L d_model=3840 16H (GQA kv=8) d_ff=15360 vocab=262144,
5:1 local:global sliding-window attention, 128k context.
[hf:google/gemma-3-1b-pt; unverified]

Sub-quadratic eligibility: 5/6 of layers are sliding-window (1024) local
attention; decode cost is O(window) for those and O(L) for the 1-in-6 global
layers, so long_500k decode is lowered for this arch (see DESIGN.md §5).
"""
from repro_torch.configs.base import ArchBundle, AttentionConfig, MeshConfig, ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    d_ff=15360,
    vocab_size=262_144,
    attention=AttentionConfig(n_heads=16, n_kv_heads=8, head_dim=256,
                              sliding_window=1024, local_global=(5, 1),
                              rope_theta=1_000_000.0),
    act="gelu",
    glu=True,
    tie_embeddings=True,
    max_seq_len=131_072,
    sub_quadratic=True,
)

MESH = MeshConfig(fsdp=True, remat="full", sequence_parallel=True)

BUNDLE = ArchBundle(model=CONFIG, mesh=MESH)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="gemma3-12b-reduced",
        family="dense",
        n_layers=6,   # one full 5:1 local:global period
        d_model=64,
        d_ff=128,
        vocab_size=256,
        attention=AttentionConfig(n_heads=4, n_kv_heads=2, head_dim=16,
                                  sliding_window=16, local_global=(5, 1)),
        act="gelu",
        tie_embeddings=True,
        max_seq_len=128,
        sub_quadratic=True,
    )
