"""Elastic scaling: respond to slice loss/gain without restarting training.

Port of ``repro/runtime/elastic.py``: ``FleetExhaustedError``, ``replan``
and ``scale_event_log`` are copied verbatim apart from imports.
``reshard_restore`` keeps the reference's signature and errors; its
``shardings`` may be a ``torch.device`` that the restored state is moved
to, or a ``(mesh, placements)`` pair from ``runtime.sharding`` that places
it on a ``DeviceMesh`` (the reference's NamedShardings).

The HeMT insight makes elasticity cheap: capacity change is just another
speed change, so the planner re-skews instead of redistributing state.
Sequence of events on a resize (DESIGN.md §8):

  1. FleetMonitor declares a slice dead (or the scheduler grants new ones).
  2. `replan` updates the GrainPlanner slice set — survivors keep their
     AR(1) estimates; newcomers cold-start at the survivor mean (§5.1 L_k^o).
  3. Data assignment is index-based (repro_torch.data.grains), so the next
     step's grain ranges simply split differently — no data movement.
  4. Model/optimizer state: under pure cross-slice DP each slice holds a
     full replica, so nothing reshards; a resize that changes where the
     state lives restores it from the latest checkpoint (`reshard_restore`).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.core.planner import GrainPlanner
from repro_torch.runtime.sharding import Placements, place

Pytree = Any


class FleetExhaustedError(RuntimeError):
    """Every slice died and no newcomers arrived: the fleet cannot run
    another step.  Carries the last-known AR(1) speed ``estimates``
    (slice name -> estimated speed, directly-observed slices only) so a
    recovery loop can checkpoint them and halt gracefully — or seed a
    replacement fleet — instead of crashing with a bare error.

    Subclasses :class:`RuntimeError` with the historical message, so
    pre-existing ``except RuntimeError`` / message-matching callers keep
    working."""

    def __init__(self, estimates: Dict[str, float]):
        super().__init__("no slices left after resize")
        self.estimates = dict(estimates)


def replan(planner: GrainPlanner, survivors: Sequence[str],
           newcomers: Sequence[str] = ()) -> List[str]:
    """Apply a fleet change to the planner; returns the new slice list.

    Raises :class:`FleetExhaustedError` (carrying the planner's last-known
    speed estimates) when survivors and newcomers are both empty."""
    new_slices = list(survivors) + list(newcomers)
    if not new_slices:
        raise FleetExhaustedError(planner.estimator.known())
    planner.resize(new_slices)
    return new_slices


def _place(tree: Pytree, device: torch.device) -> Pytree:
    """``tree`` with every tensor on ``device``: modules move in place,
    containers are rebuilt, other leaves are kept."""
    if isinstance(tree, torch.nn.Module):
        return tree.to(device)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _place(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_place(v, device) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_place(v, device) for v in tree)
    if hasattr(tree, "__dataclass_fields__"):
        return type(tree)(**{k: _place(getattr(tree, k), device)
                             for k in tree.__dataclass_fields__})
    return tree


def reshard_restore(ckpt_manager, state_like: Pytree,
                    shardings: Optional[Union[str, torch.device,
                                              Tuple[DeviceMesh, Dict[str, Placements]]]] = None,
                    ) -> Pytree:
    """Restore the latest checkpoint and (optionally) place it — the resize
    path. ``shardings`` is a device the state moves to, or ``(mesh,
    placements)``: every leaf is distributed on the mesh by its placements
    (``runtime.sharding.place``; the names of the ``*_shardings``
    functions, e.g. ``train_state_shardings``). Returns ``(step, state)``."""
    restored = ckpt_manager.restore_latest(state_like)
    if restored is None:
        raise FileNotFoundError("no checkpoint to resume from")
    step, state, _meta = restored
    if isinstance(shardings, tuple):
        mesh, placements = shardings
        state = place(state, mesh, placements)
    elif shardings is not None:
        state = _place(state, torch.device(shardings))
    return step, state


def scale_event_log(planner: GrainPlanner) -> List[Dict]:
    """Per-step grain allocations (for EXPERIMENTS / tests)."""
    return [{"mode": p.mode, "grains": dict(zip(p.slice_names, p.grains))}
            for p in planner.step_log]
