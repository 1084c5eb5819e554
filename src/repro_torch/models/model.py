"""Top-level model: embeddings + stack(s) + head, train loss, prefill,
decode.

Port of ``repro/models/model.py`` for attention archs (dense, MoE,
gemma3's local:global windows, whisper's encoder-decoder, pixtral's
embedding prompts), pure SSM (Mamba2) archs and hybrid attention/SSM
stacks (jamba). The parameters are an
``nn.ModuleDict`` with the reference's top-level keys (``embed``,
``stack``, ``final_norm``, optionally ``unembed``, ``encoder``,
``enc_norm`` and ``adapter``); the decode state holds one cache per
layer, a KV ring buffer or an SSM ``{"conv", "state"}`` pair.
``init_params`` builds frozen (serving) weights; the training path turns
``requires_grad`` on (``runtime.train_loop``). On ``device="meta"`` it
builds shapes and dtypes only (the dry-run's stand-ins for 100B+
configs); ``params_axes`` names each parameter's logical axes. The
embedding (``_embed``) and a serving step's head (``_last_logits``: final
norm, unembedding, pad mask) are one function each, which every pass
that has them calls, and ``repro_torch.telemetry`` spans (``embed``,
``head``).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import devices
from repro_torch.configs.base import ModelConfig, padded_vocab_size
from repro_torch.models import frontends, transformer
from repro_torch.models.layers import (
    _sinusoids, embed, embedding_init, rmsnorm, rmsnorm_init, sinusoidal_positions,
    unembed,
)
from repro_torch.telemetry import span

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
    ``dtype`` defaults to the config's. The meta device has no generator of
    its own: there a CPU generator is handed to every draw, which allocates
    nothing."""
    transformer.check_ported(cfg)
    dev = devices.resolve(device)
    dt = _dtype(cfg) if dtype is None else dtype
    gen = torch.Generator(device="cpu" if dev.type == "meta" else dev)
    gen.manual_seed(seed)
    pv = padded_vocab_size(cfg)
    p = nn.ModuleDict({
        "embed": embedding_init(gen, pv, cfg.d_model, dtype=dt, device=dev),
        "stack": transformer.stack_init(gen, cfg, cross=cfg.encoder_layers > 0,
                                        dtype=dt, device=dev),
        "final_norm": rmsnorm_init(cfg.d_model, device=dev),
    })
    if not cfg.tie_embeddings:
        p["unembed"] = embedding_init(gen, pv, cfg.d_model, dtype=dt, device=dev)
    if cfg.encoder_layers > 0:
        p["encoder"] = transformer.stack_init(gen, _encoder_cfg(cfg), dtype=dt, device=dev)
        p["enc_norm"] = rmsnorm_init(cfg.d_model, device=dev)
    if cfg.frontend != "none":
        p["adapter"] = frontends.adapter_init(gen, cfg, dtype=dt, device=dev)
    record_periods(p, cfg)
    return p


def params_axes(cfg: ModelConfig) -> Dict[str, transformer.Axes]:
    """``{parameter name: logical axes}`` for ``init_params(cfg)``'s
    parameters (the reference's ``params_axes``, keyed by the port's names)."""
    ax: Dict[str, transformer.Axes] = {"embed.table": ("vocab", "embed")}
    ax.update({f"stack.{k}": v for k, v in
               transformer.stack_axes(cfg, cross=cfg.encoder_layers > 0).items()})
    ax["final_norm.scale"] = (None,)
    if not cfg.tie_embeddings:
        ax["unembed.table"] = ("vocab", "embed")
    if cfg.encoder_layers > 0:
        ax.update({f"encoder.{k}": v for k, v in
                   transformer.stack_axes(_encoder_cfg(cfg)).items()})
        ax["enc_norm.scale"] = (None,)
    if cfg.frontend != "none":
        ax["adapter.w"] = (None, "embed")
    return ax


def record_periods(params: nn.ModuleDict, cfg: ModelConfig) -> None:
    """Record the stacks' layer periods on the model: the checkpoint
    layout's stacking (``convert.reference_paths``)."""
    params.layer_period = cfg.layer_period
    if cfg.encoder_layers > 0:
        params.encoder_period = _encoder_cfg(cfg).layer_period


def _encoder_cfg(cfg: ModelConfig) -> ModelConfig:
    return dataclasses.replace(cfg, n_layers=cfg.encoder_layers, moe=None,
                               attn_period=0, ssm=None, encoder_layers=0)


def _head(params) -> Any:
    return params["unembed"] if "unembed" in params else params["embed"]


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device)[None].expand(b, s)


def _decoder_sinusoids(cfg: ModelConfig) -> bool:
    """whisper: sinusoidal positions on the decoder too."""
    return (cfg.attention is not None and cfg.attention.rope_style == "none"
            and cfg.encoder_layers > 0)


def encode(params, enc_feats: torch.Tensor, cfg: ModelConfig, *,
           impl: str = "xla", remat: str = "none") -> torch.Tensor:
    """Whisper-style encoder over precomputed (stub) frame embeddings: the
    adapter, sinusoidal positions, the non-causal stack, then ``enc_norm``."""
    x = frontends.adapter_apply(params["adapter"], enc_feats) \
        if cfg.frontend != "none" else enc_feats
    b, s = x.shape[:2]
    x = x + sinusoidal_positions(s, cfg.d_model, device=x.device)[None].to(x.dtype)
    x, _ = transformer.stack_apply(params["encoder"], x, _encoder_cfg(cfg),
                                   _positions(b, s, x.device), causal=False,
                                   impl=impl, remat=remat)
    return rmsnorm(params["enc_norm"], x, cfg.norm_eps)


def _embed(params, tokens: Optional[torch.Tensor], cfg: ModelConfig,
           input_embeds: Optional[torch.Tensor] = None, start: int = 0) -> torch.Tensor:
    """The decoder's input (B,S,D) from tokens (B,S), or from embedding
    prompts through the adapter, at positions ``start`` onwards."""
    with span("embed"):
        if input_embeds is not None:
            x = frontends.adapter_apply(params["adapter"], input_embeds)
        else:
            x = embed(params["embed"], tokens)
        if _decoder_sinusoids(cfg):
            pos = torch.arange(start, start + x.shape[1], dtype=torch.float32, device=x.device)
            x = x + _sinusoids(pos, cfg.d_model)[None].to(x.dtype)
    return x


def _inputs(params, tokens: Optional[torch.Tensor], cfg: ModelConfig,
            input_embeds: Optional[torch.Tensor], enc_feats: Optional[torch.Tensor],
            impl: str, remat: str,
            ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """The decoder's input (B,S,D), its positions and the encoder's output
    (None without an encoder)."""
    x = _embed(params, tokens, cfg, input_embeds)
    b, s = x.shape[:2]
    enc_out = None
    if cfg.encoder_layers > 0:
        if enc_feats is None:
            raise ValueError(f"{cfg.name}: an encoder-decoder model needs enc_feats")
        enc_out = encode(params, enc_feats, cfg, impl=impl, remat=remat)
    return x, _positions(b, s, x.device), enc_out


def hidden_states(params, tokens: Optional[torch.Tensor], cfg: ModelConfig, *,
                  input_embeds: Optional[torch.Tensor] = None,
                  enc_feats: Optional[torch.Tensor] = None,
                  impl: str = "xla", remat: str = "none", constrain=None,
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Final-norm hidden states (B,S,D) + moe aux loss (pre-unembed).
    ``remat`` ("none" | "dots" | "full") recomputes each layer in the
    backward (memory only; see ``transformer.stack_apply``). ``constrain``
    is the activation sharding hook of
    ``runtime.sharding.make_activation_constraint``."""
    x, pos, enc_out = _inputs(params, tokens, cfg, input_embeds, enc_feats, impl, remat)
    if constrain is not None:
        x = constrain(x)
    x, aux = transformer.stack_apply(params["stack"], x, cfg, pos, enc_out=enc_out,
                                     impl=impl, remat=remat, constrain=constrain)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if constrain is not None:
        x = constrain(x, kind="hidden")
    return x, aux


def forward(params, tokens: Optional[torch.Tensor], cfg: ModelConfig, *,
            input_embeds: Optional[torch.Tensor] = None,
            enc_feats: Optional[torch.Tensor] = None,
            impl: str = "xla", remat: str = "none",
            constrain=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (B,S,V), moe_aux_loss)."""
    x, aux = hidden_states(params, tokens, cfg, input_embeds=input_embeds,
                           enc_feats=enc_feats, impl=impl, remat=remat,
                           constrain=constrain)
    logits = unembed(_head(params), x)
    if constrain is not None:
        logits = constrain(logits, kind="logits")
    return logits, aux


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
            impl: str = "xla", remat: str = "none", constrain=None) -> torch.Tensor:
    """Next-token cross-entropy (+ MoE aux). batch keys: tokens or
    input_embeds, labels, enc_feats for enc-dec archs, optionally loss_mask.

    Padded vocabularies of at least ``CHUNKED_XENT_VOCAB`` take the chunked
    cross-entropy unless ``REPRO_NAIVE_LOSS`` or ``REPRO_DENSE_XENT`` is set
    in the environment; ``REPRO_NAIVE_LOSS`` also selects the log-softmax
    gather form of the dense loss, as in the reference."""
    labels = batch["labels"].long()
    inputs = dict(input_embeds=batch.get("input_embeds"), enc_feats=batch.get("enc_feats"),
                  impl=impl, remat=remat, constrain=constrain)
    if padded_vocab_size(cfg) >= CHUNKED_XENT_VOCAB \
            and not os.environ.get("REPRO_NAIVE_LOSS") \
            and not os.environ.get("REPRO_DENSE_XENT"):
        x, aux = hidden_states(params, batch.get("tokens"), cfg, **inputs)
        nll = chunked_softmax_xent(x, _head(params)["table"], labels, cfg.vocab_size)
        return _masked_mean(nll, batch) + aux
    logits, aux = forward(params, batch.get("tokens"), cfg, **inputs)
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

def _last_logits(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """A serving step's head: the final norm and the unembedding of the last
    position, pad logits masked; (B, V)."""
    with span("head"):
        x = rmsnorm(params["final_norm"], x[:, -1:, :], cfg.norm_eps)
        return mask_pad_logits(unembed(_head(params), x)[:, 0, :], cfg)


def prefill(params, tokens: Optional[torch.Tensor], cfg: ModelConfig, max_len: int, *,
            enc_feats: Optional[torch.Tensor] = None,
            input_embeds: Optional[torch.Tensor] = None,
            impl: str = "xla") -> Tuple[torch.Tensor, State]:
    """Process a prompt batch and build the decode state.

    tokens: (B, S) (or input_embeds (B, S, F) for vision prompts; enc_feats
    (B, S_enc, F) for enc-dec archs). Returns (last-token logits (B, V),
    decode state with cache filled and length = S) — the serving prefill
    step. The encoder's output is not kept: decode takes it as ``enc_out``.
    """
    x, pos, enc_out = _inputs(params, tokens, cfg, input_embeds, enc_feats, impl, "none")
    s = x.shape[1]
    x, cache, _ = transformer.stack_prefill(params["stack"], x, cfg, pos, max_len,
                                            enc_out=enc_out, impl=impl)
    return _last_logits(params, x, cfg), {"cache": cache, "length": s}


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, *,
                      device: Union[str, torch.device] = "cuda") -> State:
    dev = devices.resolve(device)
    return {
        "cache": transformer.stack_init_cache(cfg, batch, max_len,
                                              dtype=_dtype(cfg), device=dev),
        "length": 0,
    }


def decode_position(state: State, device) -> torch.Tensor:
    """The position of the token a decode step of ``state`` takes, as the
    0-d int64 tensor on ``device`` that the step reads and advances in
    place: ``state["pos"]``, or a new one at ``length`` for a state that
    holds none yet (one from ``prefill`` or ``init_decode_state``, whose
    placements cover only the caches)."""
    pos = state.get("pos")
    if pos is None:
        pos = torch.full((), state["length"], dtype=torch.int64, device=device)
    return pos


def decode_step(params, state: State, token: torch.Tensor, cfg: ModelConfig, *,
                enc_out: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, State]:
    """token: (B,) integer; enc_out: the encoder's output (B, S_enc, D) for
    enc-dec archs. Returns (logits (B,V), new state). The caches of
    ``state`` are updated in place, and so is its position on the device
    (``pos``, see ``decode_position``), which the step reads instead of a
    host value; ``length`` is the same position as a Python int."""
    pos = decode_position(state, token.device)
    x = _embed(params, token[:, None], cfg, start=state["length"])
    x, cache = transformer.stack_decode_step(params["stack"], state["cache"], x, pos, cfg,
                                             enc_out=enc_out)
    logits = _last_logits(params, x, cfg)
    pos.add_(1)
    return logits, {"cache": cache, "length": state["length"] + 1, "pos": pos}
