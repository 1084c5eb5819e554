"""Train-step factory + HeMT grain accumulation.

Port of ``repro/runtime/train_loop.py``. Two granularities:

* ``make_train_step`` — one global step (the whole global batch at once),
  AdamW fused in.

* ``make_grain_step`` / ``make_apply_step`` — HeMT-DP decomposition: a
  grain step accumulates loss/grads over one fixed-shape microbatch; the
  apply step consumes the accumulated gradient at the barrier. The
  accumulation trip count is a host-side loop so each slice can run its
  own k_i (the paper's macrotask size) between barriers.

* ``make_grain_accumulate`` / ``grain_accumulate_cached`` — the stacked
  grains of a whole step ([G, grain_batch, seq]) are folded into one
  GrainAcc by one call, as the reference's single ``lax.scan`` dispatch;
  ``grain_accumulate_cached`` keys a module-level cache on the (frozen,
  hashable) (cfg, bundle, impl) triple, so drivers built repeatedly share
  one function.

PyTorch runs eagerly, so nothing here is traced or compiled. Gradients
come from ``torch.autograd.grad`` per grain and accumulate in fp32, as the
reference's ``g.astype(float32)`` sum. Parameters, moments and the
accumulator are updated in place (the reference returns new trees): at
mamba2-2.7b's size they are 5.4 GB, 21.6 GB and 10.8 GB, and a second copy
of any would not fit beside the activations.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple, Union

import torch
from torch import nn

from repro_torch.configs.base import ArchBundle, ModelConfig
from repro_torch.models.model import _encoder_cfg, init_params, loss_fn
from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update
from repro_torch.optim.compression import (
    CompressionState, compress_decompress, compression_init,
)
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.runtime.sharding import mesh_context

Grads = Dict[str, torch.Tensor]
Batch = Dict[str, torch.Tensor]


class TrainState(NamedTuple):
    params: nn.ModuleDict
    opt: AdamWState
    step: int
    ef: Grads                  # compression error-feedback (possibly empty {})


def train_state_from_params(params: nn.ModuleDict, bundle: ArchBundle) -> TrainState:
    """A training state over ``params`` (e.g. ``convert.from_jax_params``):
    turns ``requires_grad`` on, which the serving weights keep off."""
    for p in params.parameters():
        p.requires_grad_(True)
    moment_dtype = "bfloat16" if bundle.mesh.bf16_optimizer else "float32"
    opt = adamw_init(params, moment_dtype)
    ef: Grads = {}
    if bundle.train.compression != "none":
        ef = compression_init(params).error
    return TrainState(params, opt, 0, ef)


def train_state_init(seed: int, cfg: ModelConfig, bundle: ArchBundle, *,
                     device: Union[str, torch.device] = "cuda") -> TrainState:
    return train_state_from_params(init_params(cfg, seed, device=device), bundle)


def value_and_grad(params: nn.ModuleDict, batch: Batch, cfg: ModelConfig, impl: str,
                   remat: str, constrain=None) -> Tuple[torch.Tensor, Grads]:
    """(loss, grads by parameter name) of ``loss_fn``; grads in the
    parameters' dtypes. A parameter the loss does not reach (the token
    table under embedding prompts) gets zeros, as the reference's grad."""
    named = list(params.named_parameters())
    loss = loss_fn(params, batch, cfg, impl=impl, remat=remat, constrain=constrain)
    grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
    return loss.detach(), {n: torch.zeros_like(p) if g is None else g
                           for (n, p), g in zip(named, grads)}


def _apply(state: TrainState, grads: Grads, cfg: ModelConfig, bundle: ArchBundle,
           ) -> Tuple[TrainState, Dict[str, Any]]:
    """Compression (when on), the schedule's lr and the AdamW update."""
    tc = bundle.train
    ef = state.ef
    if tc.compression != "none":
        grads, new_cs = compress_decompress(grads, CompressionState(ef),
                                            scheme=tc.compression, period=cfg.layer_period,
                                            enc_period=_encoder_cfg(cfg).layer_period)
        ef = new_cs.error
    lr = warmup_cosine(state.step, peak_lr=tc.lr, warmup_steps=tc.warmup_steps,
                       total_steps=tc.total_steps)
    params, opt, gnorm = adamw_update(
        grads, state.opt, state.params, lr=lr, beta1=tc.beta1, beta2=tc.beta2,
        weight_decay=tc.weight_decay, grad_clip=tc.grad_clip)
    return TrainState(params, opt, state.step + 1, ef), {"grad_norm": gnorm, "lr": lr}


def make_train_step(cfg: ModelConfig, bundle: ArchBundle, *, impl: str = "xla",
                    constrain=None,
                    ) -> Callable[[TrainState, Batch], Tuple[TrainState, Dict[str, Any]]]:
    """constrain: optional activation sharding hook
    (``runtime.sharding.make_activation_constraint``). A state placed by
    ``runtime.sharding.place`` steps on its mesh."""
    remat = bundle.mesh.remat

    def train_step(state: TrainState, batch: Batch) -> Tuple[TrainState, Dict[str, Any]]:
        with mesh_context(state.params):
            loss, grads = value_and_grad(state.params, batch, cfg, impl, remat, constrain)
            state, metrics = _apply(state, grads, cfg, bundle)
        return state, {"loss": loss, **metrics}

    return train_step


# --------------------------------------------------------------------------
# HeMT-DP grain decomposition
# --------------------------------------------------------------------------

class GrainAcc(NamedTuple):
    grads: Grads               # fp32, by parameter name
    loss_sum: torch.Tensor
    n: int                     # grains accumulated


def grain_acc_init(params: nn.ModuleDict) -> GrainAcc:
    grads = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for n, p in params.named_parameters()}
    dev = next(iter(grads.values())).device
    return GrainAcc(grads, torch.zeros((), dtype=torch.float32, device=dev), 0)


def _fold(params: nn.ModuleDict, acc: GrainAcc, grain: Batch, cfg: ModelConfig,
          impl: str, remat: str) -> GrainAcc:
    """One grain's loss and gradients added into ``acc`` (its gradient
    buffers in place)."""
    loss, grads = value_and_grad(params, grain, cfg, impl, remat)
    for n, g in grads.items():
        acc.grads[n].add_(g.float())
    return GrainAcc(acc.grads, acc.loss_sum + loss.float(), acc.n + 1)


def make_grain_step(cfg: ModelConfig, bundle: ArchBundle, *, impl: str = "xla") -> Callable:
    remat = bundle.mesh.remat

    def grain_step(params: nn.ModuleDict, acc: GrainAcc, grain: Batch) -> GrainAcc:
        return _fold(params, acc, grain, cfg, impl, remat)

    return grain_step


def make_grain_accumulate(cfg: ModelConfig, bundle: ArchBundle, *,
                          impl: str = "xla") -> Callable:
    """(params, acc, grains[G, ...]) -> acc after folding all G grains, in
    stacking order: the same as calling ``grain_step`` G times, in one call
    per step."""
    remat = bundle.mesh.remat

    def grain_accumulate(params: nn.ModuleDict, acc: GrainAcc, grains: Batch) -> GrainAcc:
        n_grains = next(iter(grains.values())).shape[0]
        for i in range(n_grains):
            acc = _fold(params, acc, {k: v[i] for k, v in grains.items()}, cfg, impl, remat)
        return acc

    return grain_accumulate


_GRAIN_ACC_CACHE: Dict[Any, Callable] = {}


def grain_accumulate_cached(cfg: ModelConfig, bundle: ArchBundle, *,
                            impl: str = "xla") -> Callable:
    """Module-level cache of grain-accumulate functions, keyed by the frozen
    (cfg, bundle, impl) triple: every driver with the same config shares
    one function."""
    key = (cfg, bundle, impl)
    fn = _GRAIN_ACC_CACHE.get(key)
    if fn is None:
        fn = _GRAIN_ACC_CACHE[key] = make_grain_accumulate(cfg, bundle, impl=impl)
    return fn


def make_apply_step(cfg: ModelConfig, bundle: ArchBundle) -> Callable:
    """Barrier step: mean the accumulated grads over the *global* grain
    count (HeMT slices contribute different k_i; the denominator is the
    total, so skewing never biases the gradient) and apply AdamW. The
    accumulator is consumed: its buffers are divided in place."""

    def apply_step(state: TrainState, acc: GrainAcc, total_grains: int,
                   ) -> Tuple[TrainState, Dict[str, Any]]:
        denom = max(float(total_grains), 1.0)
        for g in acc.grads.values():
            g.div_(denom)
        state, metrics = _apply(state, acc.grads, cfg, bundle)
        return state, {"loss": acc.loss_sum / denom, **metrics}

    return apply_step
