"""Optimizer substrate: AdamW, LR schedules, gradient compression."""
from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update  # noqa: F401
from repro_torch.optim.compression import (  # noqa: F401
    CompressionState, compress_decompress, compression_init,
)
from repro_torch.optim.schedule import warmup_cosine  # noqa: F401
