"""Model code of the port (decoder-only attention archs)."""
from repro_torch.models.model import (
    decode_step, forward, init_decode_state, init_params, prefill,
)

__all__ = ["decode_step", "forward", "init_decode_state", "init_params", "prefill"]
