"""mamba2-2.7b — 64L d_model=2560 (attention-free) vocab=50280 ssm_state=128,
SSD (state-space duality).  [arXiv:2405.21060; unverified]
"""
from repro_torch.configs.base import ArchBundle, MeshConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    d_ff=0,            # mamba2 blocks have no separate FFN
    vocab_size=50_280,
    attention=None,
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_width=4),
    tie_embeddings=True,
    max_seq_len=1_048_576,
    sub_quadratic=True,
)

MESH = MeshConfig(fsdp=False, remat="full", sequence_parallel=True)

BUNDLE = ArchBundle(model=CONFIG, mesh=MESH)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b-reduced",
        family="ssm",
        n_layers=2,
        d_model=64,
        d_ff=0,
        vocab_size=256,
        attention=None,
        ssm=SSMConfig(state_dim=16, head_dim=16, expand=2, conv_width=4, chunk=16),
        tie_embeddings=True,
        max_seq_len=128,
        sub_quadratic=True,
    )
