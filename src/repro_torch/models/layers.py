"""Primitive layers: norms, rotary embeddings, MLPs, embeddings.

Port of ``repro/models/layers.py``. Parameters are ``nn.ParameterDict``s
indexed by the reference's leaf names, so every function here also takes a
plain dict of tensors. Weights keep the reference's ``(d_in, d_out)`` layout
and are applied as ``x @ w``. Initializers draw from an explicit
``torch.Generator``: only shapes and standard deviations match the
reference, so numeric parity goes through ``repro_torch.convert``.
"""
from __future__ import annotations

import math
from functools import partial, wraps
from typing import Callable, List, Mapping, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

Params = Mapping[str, torch.Tensor]


def _param(t: torch.Tensor) -> nn.Parameter:
    # serving weights are frozen; a training path turns requires_grad on
    return nn.Parameter(t, requires_grad=False)


def shard_local(fn: Callable, split_dims: Tuple[int, ...] = (0,)) -> Callable:
    """``fn`` run on each rank's own shards when its arguments are placed.

    ``fn`` must treat the slices along ``split_dims`` independently (a
    row-wise sort, a cumsum along another dim). Its DTensor arguments are
    brought to the first one's placements with a ``Shard`` of any other dim
    made ``Replicate()``, and unwrapped; its tensor results (one, or a
    tuple) are wrapped in those placements again, so autograd runs through
    ``fn`` as on plain tensors. Plain arguments pass as they are, and
    without a DTensor argument ``fn`` runs as it is. This keeps ops that
    DTensor has no sharding strategy for (``searchsorted``; in PyTorch 2.11
    also ``flip``, in ``cumsum``'s backward) off DTensors."""
    @wraps(fn)
    def run(*args):
        placed = [a for a in args if isinstance(a, DTensor)]
        if not placed:
            return fn(*args)
        mesh = placed[0].device_mesh
        keep = tuple(p if isinstance(p, Shard) and p.dim in split_dims else Replicate()
                     for p in placed[0].placements)
        out = fn(*(a.redistribute(mesh, keep).to_local() if isinstance(a, DTensor) else a
                   for a in args))
        wrap = partial(DTensor.from_local, device_mesh=mesh, placements=keep, run_check=False)
        return wrap(out) if isinstance(out, torch.Tensor) else tuple(wrap(t) for t in out)
    return run


class ParamTree(nn.Module):
    """Parameters and nested parameter dicts under the reference's leaf
    names, indexed like its nested dicts (the SSM mixer's leaves sit beside
    ``gate_norm/scale``): ``nn.ParameterDict`` holds only tensors and
    ``nn.ModuleDict`` only modules."""

    def __init__(self, entries: Mapping[str, Union[nn.Parameter, nn.Module]]):
        super().__init__()
        for key, value in entries.items():
            if isinstance(value, nn.Module):
                self.add_module(key, value)
            else:
                self.register_parameter(key, value)

    def __getitem__(self, key: str):
        if key in self._parameters:
            return self._parameters[key]
        return self._modules[key]

    def keys(self) -> List[str]:
        return [*self._parameters, *self._modules]


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------

def rmsnorm_init(d: int, *, device=None) -> nn.ParameterDict:
    return nn.ParameterDict(
        {"scale": _param(torch.ones(d, dtype=torch.float32, device=device))})


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Computed in fp32 and cast back to x's dtype."""
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * params["scale"]
    return out.to(dt)


def layernorm_init(d: int, *, device=None) -> nn.ParameterDict:
    return nn.ParameterDict({
        "scale": _param(torch.ones(d, dtype=torch.float32, device=device)),
        "bias": _param(torch.zeros(d, dtype=torch.float32, device=device))})


def layernorm(params: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Computed in fp32 and cast back to x's dtype."""
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps) * params["scale"] + params["bias"]
    return out.to(dt)


# --------------------------------------------------------------------------
# rotary position embeddings
# --------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, style: str,
                     device=None) -> torch.Tensor:
    """Inverse frequencies. style='half' (chatglm 2d-rope) rotates only the
    first half of head dims, so it needs head_dim//4 frequencies."""
    rot = head_dim if style == "full" else head_dim // 2
    expo = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    return 1.0 / (theta ** expo)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               style: str = "full") -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq) integer.

    Rotates interleaved pairs (x[..., 0::2], x[..., 1::2]), as the
    reference does, not the half-split pairs of ``rotate_half``."""
    if style == "none":
        return x
    inv = rope_frequencies(x.shape[-1], theta, style, device=x.device)
    ang = positions[..., :, None].float() * inv               # (..., S, rot/2)
    cos = torch.cos(ang)[..., :, None, :]                     # (..., S, 1, rot/2)
    sin = torch.sin(ang)[..., :, None, :]

    if style == "half":
        rot_part, pass_part = x.chunk(2, dim=-1)
    else:
        rot_part, pass_part = x, None

    xf = rot_part.float()
    x1, x2 = xf[..., 0::2], xf[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    rotated = torch.stack([r1, r2], dim=-1).reshape(rot_part.shape).to(x.dtype)
    if pass_part is not None:
        return torch.cat([rotated, pass_part], dim=-1)
    return rotated


def sinusoidal_positions(n_pos: int, d: int, *, device=None) -> torch.Tensor:
    """Whisper-style sinusoidal embedding table (n_pos, d), fp32."""
    half = d // 2
    log_timescale = math.log(10_000.0) / max(half - 1, 1)
    inv = torch.exp(-log_timescale * torch.arange(half, dtype=torch.float32,
                                                  device=device))
    scaled = torch.arange(n_pos, dtype=torch.float32, device=device)[:, None] * inv[None, :]
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=1)


# --------------------------------------------------------------------------
# dense / GLU MLP
# --------------------------------------------------------------------------

def _dense_init(gen: torch.Generator, d_in: int, d_out: int,
                scale: Optional[float] = None, *, dtype=torch.bfloat16,
                device=None) -> nn.Parameter:
    if scale is None:
        scale = 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=device) * scale
    return _param(w.to(dtype))


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, glu: bool, *,
             dtype=torch.bfloat16, device=None) -> nn.ParameterDict:
    p = nn.ParameterDict({
        "w_up": _dense_init(gen, d_model, d_ff, dtype=dtype, device=device),
        "w_down": _dense_init(gen, d_ff, d_model, dtype=dtype, device=device)})
    if glu:
        p["w_gate"] = _dense_init(gen, d_model, d_ff, dtype=dtype, device=device)
    return p


def mlp_apply(params: Params, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """SwiGLU when the params hold ``w_gate``; gelu is the tanh form, as
    ``jax.nn.gelu`` defaults to."""
    activation = F.silu if act == "silu" else partial(F.gelu, approximate="tanh")
    up = x @ params["w_up"]
    if "w_gate" in params:
        up = activation(x @ params["w_gate"]) * up
    else:
        up = activation(up)
    return up @ params["w_down"]


# --------------------------------------------------------------------------
# embeddings
# --------------------------------------------------------------------------

def embedding_init(gen: torch.Generator, vocab: int, d: int, *,
                   dtype=torch.bfloat16, device=None) -> nn.ParameterDict:
    # stddev d^-0.5 keeps tied-unembedding logits O(1) at init
    tbl = torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                      device=device) * (1.0 / math.sqrt(d))
    return nn.ParameterDict({"table": _param(tbl.to(dtype))})


def embed(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    return params["table"][tokens]


def unembed(params: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ params["table"].T
