"""Model code of the port (attention, encoder-decoder and SSM archs)."""
from repro_torch.models.model import (
    decode_step, forward, init_decode_state, init_params, prefill,
)

__all__ = ["decode_step", "forward", "init_decode_state", "init_params", "prefill"]
