"""Top-level model: embeddings + decoder stack + tied head, train loss,
prefill, decode.

Port of ``repro/models/model.py`` for decoder-only attention archs and
pure SSM (Mamba2) archs. The parameters are an ``nn.ModuleDict`` with the
reference's top-level keys (``embed``, ``stack``, ``final_norm``,
optionally ``unembed``); the decode state holds one cache per layer, a KV
ring buffer or an SSM ``{"conv", "state"}`` pair. ``init_params`` builds
frozen (serving) weights; the training path turns ``requires_grad`` on
(``runtime.train_loop``).
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import devices
from repro_torch.configs.base import ModelConfig, padded_vocab_size
from repro_torch.models import transformer
from repro_torch.models.layers import embed, embedding_init, rmsnorm, rmsnorm_init, unembed

State = Dict[str, Any]

NEG_INF = -1e30


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def mask_pad_logits(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Embedding tables are padded to a 256 multiple; pad-vocab logits are
    forced to -1e30 so softmax mass is exact."""
    pv = padded_vocab_size(cfg)
    if pv == cfg.vocab_size:
        return logits
    valid = torch.arange(pv, device=logits.device) < cfg.vocab_size
    return torch.where(valid, logits, NEG_INF)


def init_params(cfg: ModelConfig, seed: int = 0, *,
                device: Union[str, torch.device] = "cuda",
                dtype: Optional[torch.dtype] = None) -> nn.ModuleDict:
    """Random weights from a seeded ``torch.Generator`` on ``device``.
    ``dtype`` defaults to the config's."""
    transformer.check_ported(cfg)
    dev = devices.resolve(device)
    dt = _dtype(cfg) if dtype is None else dtype
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    pv = padded_vocab_size(cfg)
    p = nn.ModuleDict({
        "embed": embedding_init(gen, pv, cfg.d_model, dtype=dt, device=dev),
        "stack": transformer.stack_init(gen, cfg, dtype=dt, device=dev),
        "final_norm": rmsnorm_init(cfg.d_model, device=dev),
    })
    if not cfg.tie_embeddings:
        p["unembed"] = embedding_init(gen, pv, cfg.d_model, dtype=dt, device=dev)
    return p


def _head(params) -> Any:
    return params["unembed"] if "unembed" in params else params["embed"]


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device)[None].expand(b, s)


def hidden_states(params, tokens: torch.Tensor, cfg: ModelConfig, *,
                  impl: str = "xla", remat: str = "none",
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Final-norm hidden states (B,S,D) + moe aux loss (pre-unembed).
    ``remat`` ("none" | "dots" | "full") recomputes each layer in the
    backward (memory only; see ``transformer.stack_apply``)."""
    x = embed(params["embed"], tokens)
    b, s = x.shape[:2]
    x, aux = transformer.stack_apply(params["stack"], x, cfg,
                                     _positions(b, s, x.device), impl=impl, remat=remat)
    return rmsnorm(params["final_norm"], x, cfg.norm_eps), aux


def forward(params, tokens: torch.Tensor, cfg: ModelConfig, *,
            impl: str = "xla", remat: str = "none") -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (B,S,V), moe_aux_loss)."""
    x, aux = hidden_states(params, tokens, cfg, impl=impl, remat=remat)
    return unembed(_head(params), x), aux


# vocabularies at or above this size use the chunked softmax-xent (the fp32
# logits tensor of a 262k-vocab model is the single largest train buffer)
CHUNKED_XENT_VOCAB = 32_768
XENT_CHUNK = 4_096


def _xent_chunk(m_p: torch.Tensor, l_p: torch.Tensor, t_p: torch.Tensor,
                xf: torch.Tensor, tc: torch.Tensor, labels: torch.Tensor, c0: int,
                vocab_size: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One vocab chunk of the online (max, sumexp, true-logit) carry."""
    logits = torch.einsum("bsd,cd->bsc", xf, tc.float())
    gids = c0 + torch.arange(tc.shape[0], device=xf.device)     # global vocab ids
    logits = torch.where(gids < vocab_size, logits, NEG_INF)
    m_n = torch.maximum(m_p, logits.amax(dim=-1))
    l_n = l_p * torch.exp(m_p - m_n) + torch.exp(logits - m_n[..., None]).sum(-1)
    t_n = t_p + torch.where(labels[..., None] == gids, logits, 0.0).sum(-1)
    return m_n, l_n, t_n


def chunked_softmax_xent(x: torch.Tensor, table: torch.Tensor, labels: torch.Tensor,
                         vocab_size: int, chunk: int = XENT_CHUNK) -> torch.Tensor:
    """Cross-entropy without materializing (B,S,V) logits.

    Loops over vocab chunks with an online (max, sumexp, true-logit) carry;
    each chunk's logits tile (B,S,C) is recomputed in the backward
    (``torch.utils.checkpoint``, the reference's ``nothing_saveable``),
    exactly like flash attention treats its probability tile. x: (B,S,D);
    table: (V_padded, D) (pad rows masked via vocab_size). Returns per-token
    nll (B,S) fp32.
    """
    v = table.shape[0]
    nc = -(-v // chunk)
    vp = nc * chunk
    if vp != v:
        table = torch.nn.functional.pad(table, (0, 0, 0, vp - v))
    xf = x.float()
    b, s = labels.shape
    m = torch.full((b, s), NEG_INF, dtype=torch.float32, device=x.device)
    l = torch.zeros((b, s), dtype=torch.float32, device=x.device)
    t = torch.zeros((b, s), dtype=torch.float32, device=x.device)
    grad = torch.is_grad_enabled() and (x.requires_grad or table.requires_grad)
    for ci in range(nc):
        tc = table[ci * chunk:(ci + 1) * chunk]
        args = (m, l, t, xf, tc, labels, ci * chunk, vocab_size)
        m, l, t = (checkpoint(_xent_chunk, *args, use_reentrant=False) if grad
                   else _xent_chunk(*args))
    lse = torch.log(l) + m
    return lse - t


def _masked_mean(nll: torch.Tensor, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones_like(nll)
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


def loss_fn(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig, *,
            impl: str = "xla", remat: str = "none") -> torch.Tensor:
    """Next-token cross-entropy (+ MoE aux, zero until MoE is ported).
    batch keys: tokens, labels, optionally loss_mask.

    Padded vocabularies of at least ``CHUNKED_XENT_VOCAB`` take the chunked
    cross-entropy unless ``REPRO_NAIVE_LOSS`` or ``REPRO_DENSE_XENT`` is set
    in the environment; ``REPRO_NAIVE_LOSS`` also selects the log-softmax
    gather form of the dense loss, as in the reference."""
    labels = batch["labels"].long()
    if padded_vocab_size(cfg) >= CHUNKED_XENT_VOCAB \
            and not os.environ.get("REPRO_NAIVE_LOSS") \
            and not os.environ.get("REPRO_DENSE_XENT"):
        x, aux = hidden_states(params, batch["tokens"], cfg, impl=impl, remat=remat)
        nll = chunked_softmax_xent(x, _head(params)["table"], labels, cfg.vocab_size)
        return _masked_mean(nll, batch) + aux
    logits, aux = forward(params, batch["tokens"], cfg, impl=impl, remat=remat)
    logits = mask_pad_logits(logits, cfg)
    if os.environ.get("REPRO_NAIVE_LOSS"):
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
        return _masked_mean(nll, batch) + aux
    # logsumexp + select-reduce form, as the reference (every op elementwise
    # or a reduction along vocab)
    logits_f = logits.float()
    m = logits_f.amax(dim=-1, keepdim=True).detach()
    lse = torch.log(torch.exp(logits_f - m).sum(-1)) + m[..., 0]
    vocab_iota = torch.arange(logits.shape[-1], device=logits.device)
    true_logit = torch.where(labels[..., None] == vocab_iota, logits_f, 0.0).sum(-1)
    return _masked_mean(lse - true_logit, batch) + aux


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------

def prefill(params, tokens: torch.Tensor, cfg: ModelConfig, max_len: int, *,
            impl: str = "xla") -> Tuple[torch.Tensor, State]:
    """Process a prompt batch and build the decode state.

    tokens: (B, S). Returns (last-token logits (B, V), decode state with
    cache filled and length = S) — the serving prefill step.
    """
    x = embed(params["embed"], tokens)
    b, s = x.shape[:2]
    x, cache, _ = transformer.stack_prefill(params["stack"], x, cfg,
                                            _positions(b, s, x.device), max_len,
                                            impl=impl)
    x = rmsnorm(params["final_norm"], x[:, -1:, :], cfg.norm_eps)
    logits = mask_pad_logits(unembed(_head(params), x)[:, 0, :], cfg)
    return logits, {"cache": cache, "length": s}


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, *,
                      device: Union[str, torch.device] = "cuda") -> State:
    dev = devices.resolve(device)
    return {
        "cache": transformer.stack_init_cache(cfg, batch, max_len,
                                              dtype=_dtype(cfg), device=dev),
        "length": 0,
    }


def decode_step(params, state: State, token: torch.Tensor,
                cfg: ModelConfig) -> Tuple[torch.Tensor, State]:
    """token: (B,) integer. Returns (logits (B,V), new state). The caches of
    ``state`` are updated in place; ``length`` is a Python int."""
    x = embed(params["embed"], token[:, None])
    x, cache = transformer.stack_decode_step(params["stack"], state["cache"], x,
                                             state["length"], cfg)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = mask_pad_logits(unembed(_head(params), x)[:, 0, :], cfg)
    return logits, {"cache": cache, "length": state["length"] + 1}
