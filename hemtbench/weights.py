"""The served weights, made on the device from the seed.

The family's reference names every leaf; those drawn from a normal
distribution are drawn in one call into one flat buffer of the
configuration's dtype and scaled in place, leaf by leaf, as views of it.
The same tensors go to the program (``port.params``) and to the
reference."""
from __future__ import annotations

import math
from typing import Dict

import torch

from hemtbench.traffic import sub_seed

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def make(spec: Dict, family, seed: int, device) -> Dict[str, torch.Tensor]:
    dtype = DTYPES[spec["dtype"]]
    leaves = family.normal_leaves(spec)
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, "weights"))
    flat = torch.randn(sum(math.prod(shape) for _, shape, _ in leaves), generator=gen,
                       dtype=dtype, device=device)
    out, offset = {}, 0
    for name, shape, std in leaves:
        n = math.prod(shape)
        out[name] = flat[offset:offset + n].view(shape).mul_(std)
        offset += n
    out.update(family.other_leaves(spec, gen, device))
    return out
