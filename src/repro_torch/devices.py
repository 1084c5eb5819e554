"""Device choice for the port's entry points.

Entry points default to ``cuda``. A caller that wants the CPU (the tests)
says so; asking for ``cuda`` where there is no card raises instead of
carrying on quietly on the CPU.
"""
from __future__ import annotations

from typing import Union

import torch


def resolve(device: Union[str, torch.device] = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA card is available; "
            "pass device='cpu' to run on the CPU")
    return dev
