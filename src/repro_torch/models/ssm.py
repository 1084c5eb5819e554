"""Mamba2 block (SSD — state-space duality, arXiv:2405.21060).

Port of ``repro/models/ssm.py``. ``ssd_chunked`` (and ``ssd_scan_chunks``
for S >= ``SSD_SCAN_THRESHOLD``) is the ``impl="xla"`` math; under
``impl="pallas"`` the scan goes through ``repro_torch.kernels.ops.ssd_scan``,
the hand-written Hopper kernel on the card (its plain version on a CPU
tensor). As in the reference, the kernel path rounds y to the model's dtype
before the ``d_skip`` add and the xla path keeps it in fp32.

Layout follows the Mamba2 paper: d_inner = expand*d_model split into heads
of size P=head_dim; per-head scalar decay a_t = exp(dt*A); B/C shared
across heads within a group (n_groups, like GQA).
"""
from __future__ import annotations

import math
from functools import partial
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.attention import IMPLS
from repro_torch.models.layers import (
    Params, ParamTree, _dense_init, _param, rmsnorm, rmsnorm_init, shard_local,
)

Cache = Dict[str, torch.Tensor]


def ssm_dims(d_model: int, cfg: SSMConfig) -> Dict[str, int]:
    d_inner = cfg.expand * d_model
    n_heads = d_inner // cfg.head_dim
    return dict(d_inner=d_inner, n_heads=n_heads, d_state=cfg.state_dim,
                n_groups=cfg.n_groups, conv_dim=d_inner + 2 * cfg.n_groups * cfg.state_dim)


def ssm_init(gen: torch.Generator, d_model: int, cfg: SSMConfig, *,
             dtype=torch.bfloat16, device=None) -> ParamTree:
    """The reference's leaves, shapes and standard deviations; ``gate_norm``
    is a nested ``{"scale"}`` dict as there."""
    dims = ssm_dims(d_model, cfg)
    d_in, nh, ds, ng = dims["d_inner"], dims["n_heads"], dims["d_state"], dims["n_groups"]
    in_dim = 2 * d_in + 2 * ng * ds + nh  # [z, x, B, C, dt]
    f32 = {"dtype": torch.float32, "device": device}
    conv_w = torch.randn((cfg.conv_width, dims["conv_dim"]), generator=gen,
                         **f32) / math.sqrt(cfg.conv_width)
    return ParamTree({
        "w_in": _dense_init(gen, d_model, in_dim, dtype=dtype, device=device),
        "conv_w": _param(conv_w.to(dtype)),
        "conv_b": _param(torch.zeros((dims["conv_dim"],), **f32)),
        "a_log": _param(torch.log(torch.linspace(1.0, 16.0, nh, **f32))),
        "dt_bias": _param(torch.zeros((nh,), **f32)),
        "d_skip": _param(torch.ones((nh,), **f32)),
        "gate_norm": rmsnorm_init(d_in, device=device),
        "w_out": _dense_init(gen, d_in, d_model, dtype=dtype, device=device),
    })


def _split_proj(proj: torch.Tensor, d_model: int, cfg: SSMConfig):
    dims = ssm_dims(d_model, cfg)
    d_in, ds, ng = dims["d_inner"], dims["d_state"], dims["n_groups"]
    return torch.split(proj, [d_in, d_in + 2 * ng * ds, dims["n_heads"]], dim=-1)


def _pad_seq(t: torch.Tensor, before: int, after: int = 0) -> torch.Tensor:
    """``t`` with ``before`` and ``after`` zero rows on dim 1 (the sequence),
    in a new tensor of t's kind (a DTensor stays one). By ``cat``, not
    ``F.pad``: PyTorch 2.11's DTensor pad keeps the placement of one mesh
    dim only, which the next view refuses."""
    def zeros(n):
        return [t.new_zeros((t.shape[0], n) + tuple(t.shape[2:]))] if n else []
    return torch.cat(zeros(before) + [t] + zeros(after), dim=1)


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over sequence in the model's dtype, one window
    tap at a time from 0, as the reference's ``sum``. xbc: (B, S, C); w: (W, C)."""
    width, s = w.shape[0], xbc.shape[1]
    pad = _pad_seq(xbc, width - 1)
    out = sum(pad[:, i: i + s, :] * w[i] for i in range(width))
    return F.silu(out + b.to(out.dtype))


def ssd_scan_chunks(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                    B: torch.Tensor, C: torch.Tensor, chunk: int,
                    init_state: Optional[torch.Tensor] = None, constrain=None,
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD with the chunk axis looped (one chunk's intra tensors live at a
    time) instead of batched: the memory-lean path for long sequences; same
    math as ``ssd_chunked``. Forward only.

    On bf16 the intra-chunk products take bf16 operands with fp32 sums, as
    the reference's ``preferred_element_type=float32``: here bf16-rounded
    operands cast to fp32 and multiplied in fp32. ``scores`` are rounded to
    bf16 before the second product; decays and cumsums stay fp32.
    ``constrain`` (``runtime.sharding.make_activation_constraint``) keeps
    the carried state head-sharded, kind ``"ssm_state"``.
    """
    bsz, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    nc = s // chunk
    if s % chunk:
        raise ValueError(f"seq {s} is not a multiple of chunk {chunk}")
    rep = h // g

    a = -torch.exp(a_log.float())
    dta = (dt * a).reshape(bsz, nc, chunk, h)
    cdt = x.dtype if x.dtype == torch.bfloat16 else torch.float32
    xw = (x.float() * dt[..., None]).to(cdt).reshape(bsz, nc, chunk, h, p)
    Bc = B.to(cdt).reshape(bsz, nc, chunk, g, n)
    Cc = C.to(cdt).reshape(bsz, nc, chunk, g, n)
    state = (torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
             if init_state is None else init_state)

    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    ys = []
    for c in range(nc):
        dc, xc = dta[:, c], xw[:, c]                       # (b,q,h), (b,q,h,p)
        bch = torch.repeat_interleave(Bc[:, c], rep, dim=2).float()
        cch = torch.repeat_interleave(Cc[:, c], rep, dim=2).float()
        xcf = xc.float()
        cum = torch.cumsum(dc, dim=1)                      # (b,q,h)
        li = cum[:, :, None, :] - cum[:, None, :, :]       # (b,q,k,h)
        L = torch.where(mask[None, :, :, None], torch.exp(li), 0.0)
        scores = torch.einsum("bqhn,bkhn->bqkh", cch, bch) * L
        y = torch.einsum("bqkh,bkhp->bqhp", scores.to(cdt).float(), xcf)
        y = y + torch.exp(cum)[..., None] * torch.einsum("bqhn,bhpn->bqhp", cch, state)
        decay_end = torch.exp(cum[:, -1:, :] - cum)        # (b,q,h)
        state = state * torch.exp(cum[:, -1])[:, :, None, None] + torch.einsum(
            "bqhn,bqhp->bhpn", bch, xcf * decay_end[..., None])
        if constrain is not None:
            state = constrain(state, kind="ssm_state")
        ys.append(y)
    return torch.stack(ys, dim=1).reshape(bsz, s, h, p), state


# sequences at or above this length scan chunks instead of batching them
SSD_SCAN_THRESHOLD = 4096


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None, constrain=None,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD scan, chunks batched.

    x:  (batch, S, H, P)   per-head inputs
    dt: (batch, S, H)      softplus'd step sizes
    B:  (batch, S, G, N), C: (batch, S, G, N); heads are grouped G|H
    Returns (y (batch,S,H,P) fp32, final_state (batch,H,P,N) fp32).
    """
    s0 = x.shape[1]
    pad = (-s0) % chunk
    if pad:
        # zero-dt padding is inert: decay exp(0*a)=1, input dt*x=0
        x, dt, B, C = (_pad_seq(t, 0, pad) for t in (x, dt, B, C))
        y, fin = ssd_chunked(x, dt, a_log, B, C, chunk, init_state, constrain)
        return y[:, :s0], fin
    if x.shape[1] >= SSD_SCAN_THRESHOLD:
        return ssd_scan_chunks(x, dt, a_log, B, C, chunk, init_state, constrain)
    bsz, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    nc = s // chunk
    rep = h // g

    a = -torch.exp(a_log.float())                         # (H,) negative
    dta = dt * a                                          # (B, S, H) log-decay
    xw = x * dt[..., None]                                # dt-weighted input

    xc = xw.reshape(bsz, nc, chunk, h, p).float()
    dc = dta.reshape(bsz, nc, chunk, h)
    Bc = torch.repeat_interleave(B.reshape(bsz, nc, chunk, g, n), rep, dim=3).float()
    Cc = torch.repeat_interleave(C.reshape(bsz, nc, chunk, g, n), rep, dim=3).float()

    # on each rank's shards: cumsum's backward flips, which PyTorch 2.11's
    # DTensor has no strategy for
    cum = shard_local(partial(torch.cumsum, dim=2), (0, 1, 3))(dc)   # (b, nc, q, H)

    # ---- intra-chunk (dual / attention-like) ------------------------------
    # L[i,j] = exp(cum_i - cum_j) for i >= j
    li = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # (b,nc,q,q,H)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    L = torch.exp(torch.where(mask[None, None, :, :, None], li, -math.inf))
    scores = torch.einsum("bcqhn,bckhn->bcqkh", Cc, Bc) * L
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", scores, xc)

    # ---- chunk states ------------------------------------------------------
    # state_c = sum_j exp(cum_last - cum_j) * B_j x_j^T
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)     # (b,nc,q,H)
    states = torch.einsum("bcqhn,bcqhp->bchpn", Bc, xc * decay_to_end[..., None])
    chunk_decay = torch.exp(cum[:, :, -1, :])             # (b,nc,H)

    # ---- inter-chunk recurrence (loop over chunks) -------------------------
    st = (torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
          if init_state is None else init_state)
    prev = []
    for c in range(nc):
        prev.append(st)
        st = st * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                # (b, nc, H, P, N)

    # ---- inter-chunk contribution ------------------------------------------
    decay_from_start = torch.exp(cum)                     # (b,nc,q,H)
    y_inter = torch.einsum("bcqhn,bchpn->bcqhp", Cc, prev_states) \
        * decay_from_start[..., None]

    y = (y_intra + y_inter).reshape(bsz, s, h, p)
    return y, st


def _mix(params: Params, x: torch.Tensor, d_model: int, cfg: SSMConfig, impl: str,
         constrain=None):
    """The block up to the SSD scan's output: (y (B,S,D) in x's dtype,
    final SSD state, raw pre-conv xbc)."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}: {impl!r}")
    dims = ssm_dims(d_model, cfg)
    d_in, nh, ds, ng = dims["d_inner"], dims["n_heads"], dims["d_state"], dims["n_groups"]
    bsz, s, _ = x.shape

    proj = x @ params["w_in"]
    z, xbc_raw, dt = _split_proj(proj, d_model, cfg)
    xbc = _causal_conv(xbc_raw, params["conv_w"], params["conv_b"])
    xs, B, C = torch.split(xbc, [d_in, ng * ds, ng * ds], dim=-1)

    # F.softplus returns x above 20; jax.nn.softplus has no threshold and
    # differs from that by < 2e-9
    dt = F.softplus(dt.float() + params["dt_bias"])
    xs = xs.reshape(bsz, s, nh, cfg.head_dim)
    B = B.reshape(bsz, s, ng, ds)
    C = C.reshape(bsz, s, ng, ds)

    chunk = min(cfg.chunk, s)
    if impl == "pallas":
        y, final = kops.ssd_scan(xs, dt, params["a_log"], B, C, chunk=chunk)
    else:
        y, final = ssd_chunked(xs, dt, params["a_log"], B, C, chunk, constrain=constrain)
    y = y + xs.float() * params["d_skip"][:, None]
    y = y.reshape(bsz, s, d_in).to(x.dtype)
    y = rmsnorm(params["gate_norm"], y * F.silu(z))
    return y @ params["w_out"], final, xbc_raw


def ssm_apply(params: Params, x: torch.Tensor, d_model: int, cfg: SSMConfig,
              impl: str = "xla", constrain=None) -> torch.Tensor:
    """Full-sequence Mamba2 block. x: (B, S, D) -> (B, S, D)."""
    return _mix(params, x, d_model, cfg, impl, constrain)[0]


def ssm_prefill(params: Params, x: torch.Tensor, d_model: int, cfg: SSMConfig,
                impl: str = "xla") -> Tuple[torch.Tensor, Cache]:
    """Full-sequence Mamba2 that also emits the decode cache (conv tail =
    last conv_width-1 *raw* xbc rows, zero-padded on the left when S is
    shorter, and the final SSD state). The tail is a buffer of its own, so
    the cache holds nothing of the prompt's activations. It is built from
    ``xbc_raw`` by ``cat``, which allocates, so it is a tensor of the same
    kind: a DTensor on placed weights."""
    out, final, xbc_raw = _mix(params, x, d_model, cfg, impl)
    s = xbc_raw.shape[1]
    w1 = cfg.conv_width - 1
    take = min(w1, s)
    return out, {"conv": _pad_seq(xbc_raw[:, s - take:], w1 - take), "state": final}


# --------------------------------------------------------------------------
# decode (single-token recurrence)
# --------------------------------------------------------------------------

def init_ssm_cache(batch: int, d_model: int, cfg: SSMConfig, *,
                   dtype=torch.bfloat16, device=None) -> Cache:
    dims = ssm_dims(d_model, cfg)
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, dims["conv_dim"]),
                            dtype=dtype, device=device),
        "state": torch.zeros((batch, dims["n_heads"], cfg.head_dim, dims["d_state"]),
                             dtype=torch.float32, device=device),
    }


def ssm_decode_step(params: Params, x: torch.Tensor, cache: Cache, d_model: int,
                    cfg: SSMConfig) -> Tuple[torch.Tensor, Cache]:
    """x: (B, 1, D). Single-step SSM recurrence: s' = a*s + dt*B x^T.

    Unlike the reference, which returns a new cache, the cache's ``conv``
    window and ``state`` are updated in place (as the KV cache is) and the
    same dict is returned.
    """
    dims = ssm_dims(d_model, cfg)
    d_in, nh, ds, ng = dims["d_inner"], dims["n_heads"], dims["d_state"], dims["n_groups"]
    bsz = x.shape[0]

    proj = x[:, 0, :] @ params["w_in"]
    z, xbc, dt = _split_proj(proj, d_model, cfg)

    # conv cache: window of last (W-1) inputs
    conv_in = torch.cat([cache["conv"], xbc[:, None, :]], dim=1)       # (B,W,C)
    conv_out = torch.einsum("bwc,wc->bc", conv_in.float(),
                            params["conv_w"].float()) + params["conv_b"]
    xbc_act = F.silu(conv_out).to(x.dtype)
    cache["conv"].copy_(conv_in[:, 1:, :])

    xs, B, C = torch.split(xbc_act, [d_in, ng * ds, ng * ds], dim=-1)
    dt = F.softplus(dt.float() + params["dt_bias"])                     # (B, H)
    a = -torch.exp(params["a_log"].float())
    decay = torch.exp(dt * a)                                          # (B, H)

    xs = xs.reshape(bsz, nh, cfg.head_dim).float()
    rep = nh // ng
    Bh = torch.repeat_interleave(B.reshape(bsz, ng, ds), rep, dim=1).float()
    Ch = torch.repeat_interleave(C.reshape(bsz, ng, ds), rep, dim=1).float()

    dx = xs * dt[..., None]                                            # (B,H,P)
    state = cache["state"]
    state.mul_(decay[..., None, None]).add_(torch.einsum("bhp,bhn->bhpn", dx, Bh))
    y = torch.einsum("bhpn,bhn->bhp", state, Ch) + xs * params["d_skip"][:, None]
    y = y.reshape(bsz, d_in).to(x.dtype)

    y = rmsnorm(params["gate_norm"], y * F.silu(z))
    out = (y @ params["w_out"])[:, None, :]
    return out, cache
