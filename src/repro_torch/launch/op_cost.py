"""Operation and byte counts of a dry-run cell.

Stands for ``repro/launch/hlo_cost.py``, which parses XLA's optimized,
partitioned HLO text. PyTorch produces no HLO, so this module counts
other things and says which:

* ``flops`` — ``torch.utils.flop_counter.FlopCounterMode`` over the step
  run on meta tensors: 2*M*N*K per matrix product (``mm``, ``bmm``,
  ``addmm``, ``baddbmm``, the products ``einsum`` lowers to, convolutions,
  fused attention), the backward's products included for a train step and
  a rematerialized layer's products counted again. It counts the whole
  step over all devices. Two things keep the meta run short, neither of
  which changes the count (the tests hold both to the plain count):
  ``dense_paths`` runs the long sequences of a step that records no
  gradient through the batched attention and SSD math instead of the block
  loops (at sequence lengths that are multiples of the blocks both do the
  same products, the masked blocks included; under a gradient the block
  loops' checkpoints recompute their products in the backward, so a train
  step keeps them), and ``count_by_groups`` counts one and two layer groups and
  extends linearly, since every group does the same products.
  ``flops_per_device`` divides the count by the chip count, which assumes
  every product is split evenly: replicated compute (a leaf that fell back
  to replication) is not charged to each device, as the reference's
  per-device HLO would.
* ``argument_bytes`` — the per-device bytes of the step's arguments from
  the placements' local shapes, each argument counted once. The
  reference's HLO bytes count every fused kernel's operands and outputs;
  PyTorch has no count that stands for that here.
* Collective bytes and counts, and XLA's output, temp and generated-code
  sizes: PyTorch offers no source for them on a fake mesh. They are listed
  in ``NOT_MEASURED`` and recorded as not measured, never estimated.
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, Tuple

from torch.distributed.tensor import Shard
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, ssm
from repro_torch.runtime.sharding import Placements, mesh_axes, named_tensors

NOT_MEASURED = ("collective_bytes", "dcn_bytes", "n_collectives", "output_size_in_bytes",
                "temp_size_in_bytes", "generated_code_size_in_bytes")


def count_flops(fn: Callable, *args, **kwargs) -> Tuple[Any, int]:
    """``(fn(*args, **kwargs), FLOPs of its matrix products)``."""
    with FlopCounterMode(display=False) as counter:
        out = fn(*args, **kwargs)
    return out, int(counter.get_total_flops())


@contextlib.contextmanager
def dense_paths() -> Iterator[None]:
    """Within: the ``xla`` paths take the batched attention and SSD math at
    every length (``attention.CHUNKED_THRESHOLD``,
    ``ssm.SSD_SCAN_THRESHOLD``), one product per einsum instead of one per
    block; for steps that record no gradient only (see above)."""
    saved = attention.CHUNKED_THRESHOLD, ssm.SSD_SCAN_THRESHOLD
    attention.CHUNKED_THRESHOLD = ssm.SSD_SCAN_THRESHOLD = sys.maxsize
    try:
        yield
    finally:
        attention.CHUNKED_THRESHOLD, ssm.SSD_SCAN_THRESHOLD = saved


def count_by_groups(count: Callable[[ModelConfig], int], cfg: ModelConfig) -> int:
    """``count(cfg)`` from counts at one and two layer groups (and one and
    two encoder layers): the embedding, head and loss cost ``a``, each
    decoder group ``b`` and each encoder layer ``c``, all exactly linear."""
    period = cfg.layer_period
    groups, enc = cfg.n_layers // period, cfg.encoder_layers

    def at(g: int, e: int) -> int:
        return count(dataclasses.replace(cfg, n_layers=g * period, encoder_layers=e))

    base = at(1, min(enc, 1))
    total = base + (groups - 1) * (at(2, min(enc, 1)) - base)
    if enc > 1:
        total += (enc - 1) * (at(1, 2) - base)
    return total


def local_shape(shape: Tuple[int, ...], pl: Placements, mesh) -> Tuple[int, ...]:
    """A leaf's shape on one device under ``pl`` (the ``*_shardings``
    functions shard a dim only where the mesh axes divide it)."""
    axes = mesh_axes(mesh)
    out = list(shape)
    for name, p in zip(axes.axis_names, pl):
        if isinstance(p, Shard):
            if out[p.dim] % axes.shape[name]:
                raise ValueError(f"dim {p.dim} of {tuple(shape)} does not split "
                                 f"{axes.shape[name]} ways over {name!r}")
            out[p.dim] //= axes.shape[name]
    return tuple(out)


def tree_bytes(tree: Any, shardings: Dict[str, Placements], mesh) -> int:
    """Per-device bytes of ``tree``'s tensor leaves under ``shardings``."""
    total = 0
    for name, t in named_tensors(tree):
        n = 1
        for d in local_shape(tuple(t.shape), shardings[name], mesh):
            n *= d
        total += n * t.element_size()
    return total


@dataclass
class OpCost:
    flops: int                 # the whole step, all devices
    n_chips: int
    argument_bytes: int        # per device

    @property
    def flops_per_device(self) -> float:
        return self.flops / self.n_chips

    def summary(self) -> Dict[str, Any]:
        return {"flops": self.flops, "flops_per_device": self.flops_per_device,
                "flops_split": "even over the devices",
                "argument_bytes_per_device": self.argument_bytes,
                **{k: None for k in NOT_MEASURED}}
