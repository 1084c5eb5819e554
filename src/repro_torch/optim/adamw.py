"""AdamW with decoupled weight decay and global-norm clipping.

Port of ``repro/optim/adamw.py``. Moments default to fp32;
``moment_dtype='bfloat16'`` stores them in bf16 (the update math runs in
fp32 and only storage is bf16). Written out by hand: ``torch.optim.AdamW``
decays every parameter, the reference only matrices.

Parameters are the model's ``nn.Module``; gradients, moments and the
error-feedback state are dicts keyed by ``named_parameters()`` names. The
port updates parameters and moments in place (the reference returns new
trees): a 2.7B model's fp32 moments alone take 21.6 GB.

Weight decay goes to a leaf whose rank *in the reference's layout* is at
least 2. The reference stacks every decoder-layer leaf along a leading
``(n_groups,)`` axis, so a layer's 1-D norm scale, ``a_log`` or ``D`` is
rank 2 there and is decayed; the port keeps one module per layer
(``repro_torch.convert``), so a ``stack.*`` leaf (and an encoder's
``encoder.*`` leaf) counts one rank more than it has here
(``reference_rank``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple, Union

import torch
from torch import nn

Grads = Dict[str, torch.Tensor]
STACK_PREFIXES = ("stack.", "encoder.")


@dataclass
class AdamWState:
    step: int                        # updates applied so far
    mu: Dict[str, torch.Tensor]      # first moment
    nu: Dict[str, torch.Tensor]      # second moment


def reference_rank(name: str, t: torch.Tensor) -> int:
    """The leaf's rank in the reference's layout (stack leaves carry the
    leading layer-group axis there)."""
    return t.dim() + (1 if name.startswith(STACK_PREFIXES) else 0)


def decays(name: str, t: torch.Tensor) -> bool:
    """Decoupled weight decay on matrices only (reference rank >= 2)."""
    return reference_rank(name, t) >= 2


def adamw_init(params: nn.Module, moment_dtype: str = "float32") -> AdamWState:
    dt = torch.bfloat16 if moment_dtype == "bfloat16" else torch.float32
    mu = {n: torch.zeros(p.shape, dtype=dt, device=p.device)
          for n, p in params.named_parameters()}
    nu = {n: torch.zeros(p.shape, dtype=dt, device=p.device)
          for n, p in params.named_parameters()}
    return AdamWState(0, mu, nu)


def global_norm(tree: Grads) -> torch.Tensor:
    return torch.sqrt(sum(x.float().square().sum() for x in tree.values()))


def clip_by_global_norm(grads: Grads, max_norm: float) -> Tuple[Grads, torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return {n: (g.float() * scale).to(g.dtype) for n, g in grads.items()}, norm


@torch.no_grad()
def adamw_update(grads: Grads, state: AdamWState, params: nn.Module, *,
                 lr: Union[float, torch.Tensor], beta1: float = 0.9, beta2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1,
                 grad_clip: float = 0.0,
                 ) -> Tuple[nn.Module, AdamWState, torch.Tensor]:
    """Updates ``params`` and the moments in place; returns (params, new
    state, pre-clip grad norm). The clip is applied leaf by leaf, rounded
    to each gradient's dtype as the reference's ``clip_by_global_norm``,
    without a clipped copy of every gradient."""
    gnorm = global_norm(grads)
    scale = (torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
             if grad_clip > 0 else None)
    step = state.step + 1
    b1c = 1.0 - torch.tensor(beta1, dtype=torch.float32) ** step
    b2c = 1.0 - torch.tensor(beta2, dtype=torch.float32) ** step
    lr = torch.as_tensor(lr, dtype=torch.float32)
    for name, p in params.named_parameters():
        g = grads[name]
        dev = p.device
        gf = g.float() if scale is None else (g.float() * scale.to(dev)).to(g.dtype).float()
        m, v = state.mu[name], state.nu[name]
        mf = m.float() * beta1 + (1 - beta1) * gf
        vf = v.float() * beta2 + (1 - beta2) * gf.square()
        delta = (mf / b1c.to(dev)) / (torch.sqrt(vf / b2c.to(dev)) + eps)
        if decays(name, p):
            delta = delta + weight_decay * p.float()
        p.copy_(p.float() - lr.to(dev) * delta)
        m.copy_(mf)
        v.copy_(vf)
    return params, AdamWState(step, state.mu, state.nu), gnorm
