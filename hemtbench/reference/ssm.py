"""fp32 reference of a Mamba2 stack (mamba2-2.7b, arXiv:2405.21060):
token embedding, per layer RMSNorm -> one input projection split into
z, xBC and dt; a depthwise causal convolution of width d_conv and SiLU
over xBC, split into x (heads of headdim), B and C (ngroups of d_state);
dt = softplus(dt + dt_bias), A = -exp(A_log); the state-space recurrence
h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T, y_t = C_t h_t + D x_t; then
RMSNorm(y * SiLU(z)) and the output projection, added to the residual; a
final RMSNorm and the tied embedding as the head.

The recurrence is computed exactly in chunks of ``chunk_size`` positions
(within a chunk as the masked, decayed C B^T product, across chunks
through the carried state), in fp32 with no rounding between.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F

from hemtbench.reference import matmul, padded_rows, rmsnorm


def dims(spec: dict) -> Dict[str, int]:
    s = spec["ssm_cfg"]
    d = spec["d_model"]
    d_in = s["expand"] * d
    return {"n_layers": spec["n_layer"], "d": d, "d_in": d_in, "heads": d_in // s["headdim"],
            "p": s["headdim"], "n": s["d_state"], "g": s["ngroups"], "w": s["d_conv"],
            "conv": d_in + 2 * s["ngroups"] * s["d_state"], "chunk": s["chunk_size"],
            "vocab": spec["vocab_size"]}


def normal_leaves(spec: dict) -> List[Tuple[str, Tuple[int, ...], float]]:
    """(name, shape, standard deviation) of every weight drawn from a normal
    distribution, held in the configuration's dtype."""
    m = dims(spec)
    d, d_in = m["d"], m["d_in"]
    in_dim = 2 * d_in + 2 * m["g"] * m["n"] + m["heads"]
    out = [("embed.table", (padded_rows(m["vocab"]), d), 1.0 / math.sqrt(d))]
    for i in range(m["n_layers"]):
        p = f"stack.{i}.mixer."
        out += [(p + "w_in", (d, in_dim), 1.0 / math.sqrt(d)),
                (p + "conv_w", (m["w"], m["conv"]), 1.0 / math.sqrt(m["w"])),
                (p + "w_out", (d_in, d), 1.0 / math.sqrt(d_in))]
    return out


def other_leaves(spec: dict, gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """The fp32 leaves: norm scales and D are 1, the conv bias 0; A is
    drawn from U[1, 16] and dt from logU[0.001, 0.1] (stored as the
    dt_bias whose softplus it is), as the published initialisation does."""
    m = dims(spec)
    n_layers, h = m["n_layers"], m["heads"]
    f32 = {"dtype": torch.float32, "device": device}
    a = 1.0 + 15.0 * torch.rand((n_layers, h), generator=gen, **f32)
    dt = torch.exp(math.log(1e-3) + (math.log(1e-1) - math.log(1e-3))
                   * torch.rand((n_layers, h), generator=gen, **f32))
    dt_bias = dt + torch.log(-torch.expm1(-dt))
    out = {"final_norm.scale": torch.ones(m["d"], **f32)}
    for i in range(n_layers):
        p = f"stack.{i}."
        out.update({p + "norm1.scale": torch.ones(m["d"], **f32),
                    p + "mixer.conv_b": torch.zeros(m["conv"], **f32),
                    p + "mixer.a_log": torch.log(a[i]),
                    p + "mixer.dt_bias": dt_bias[i],
                    p + "mixer.d_skip": torch.ones(h, **f32),
                    p + "mixer.gate_norm.scale": torch.ones(m["d_in"], **f32)})
    return out


def _conv(xbc: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Depthwise causal convolution: out_t = bias + sum_i w[i] xbc_{t-W+1+i}."""
    width, s = w.shape[0], xbc.shape[1]
    padded = F.pad(xbc, (0, 0, width - 1, 0))
    out = bias.float().expand_as(xbc).clone()
    for i in range(width):
        out += padded[:, i:i + s] * w[i].float()
    return out


def ssd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, B: torch.Tensor,
        C: torch.Tensor, chunk: int) -> torch.Tensor:
    """y_t = C_t h_t with h_t = exp(dt_t a) h_{t-1} + dt_t B_t x_t^T, h_0 = 0.
    x (b, s, h, p), dt (b, s, h), a (h,), B and C (b, s, g, n); fp32."""
    b, s, h, p = x.shape
    rep = h // B.shape[2]
    state = x.new_zeros((b, h, p, B.shape[3]))
    y = torch.empty_like(x)
    for c0 in range(0, s, chunk):
        c1 = min(s, c0 + chunk)
        q = c1 - c0
        xdt = x[:, c0:c1] * dt[:, c0:c1, :, None]                     # (b,q,h,p)
        Bh = B[:, c0:c1].repeat_interleave(rep, dim=2)                # (b,q,h,n)
        Ch = C[:, c0:c1].repeat_interleave(rep, dim=2)
        cum = torch.cumsum(dt[:, c0:c1] * a, dim=1)                   # (b,q,h)
        causal = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
        decay = torch.where(causal[None, :, :, None],
                            torch.exp(cum[:, :, None, :] - cum[:, None, :, :]), 0.0)
        scores = torch.einsum("bqhn,bkhn->bqkh", Ch, Bh) * decay
        y[:, c0:c1] = (torch.einsum("bqkh,bkhp->bqhp", scores, xdt)
                       + torch.einsum("bqhn,bhpn->bqhp", Ch, state)
                       * torch.exp(cum)[..., None])
        to_end = torch.exp(cum[:, -1:] - cum)                         # (b,q,h)
        state = (state * torch.exp(cum[:, -1])[:, :, None, None]
                 + torch.einsum("bkhn,bkhp->bhpn", Bh * to_end[..., None], xdt))
    return y


def logits(weights: Dict[str, torch.Tensor], spec: dict, tokens: torch.Tensor,
           first: int, mm: Callable = matmul) -> torch.Tensor:
    """fp32 logits (b, s - first, vocab) of positions ``first`` .. s-1 of
    ``tokens`` (b, s)."""
    m = dims(spec)
    eps = spec["norm_eps"]
    b, s = tokens.shape
    d_in, heads, gn = m["d_in"], m["heads"], m["g"] * m["n"]
    table = weights["embed.table"]
    x = table[tokens].float()
    for i in range(m["n_layers"]):
        p = f"stack.{i}."
        h = rmsnorm(x, weights[p + "norm1.scale"], eps)
        z, xbc, dt = torch.split(mm(h, weights[p + "mixer.w_in"]),
                                 [d_in, m["conv"], heads], dim=-1)
        xbc = F.silu(_conv(xbc, weights[p + "mixer.conv_w"], weights[p + "mixer.conv_b"]))
        xs, B, C = torch.split(xbc, [d_in, gn, gn], dim=-1)
        dt = torch.logaddexp(dt + weights[p + "mixer.dt_bias"].float(), dt.new_zeros(()))
        xs = xs.reshape(b, s, heads, m["p"])
        y = ssd(xs, dt, -torch.exp(weights[p + "mixer.a_log"].float()),
                B.reshape(b, s, m["g"], m["n"]), C.reshape(b, s, m["g"], m["n"]), m["chunk"])
        y = (y + xs * weights[p + "mixer.d_skip"].float()[:, None]).reshape(b, s, d_in)
        y = rmsnorm(y * F.silu(z), weights[p + "mixer.gate_norm.scale"], eps)
        x = x + mm(y, weights[p + "mixer.w_out"])
    h = rmsnorm(x[:, first:], weights["final_norm.scale"], eps)
    return mm(h, table[:m["vocab"]].T)
