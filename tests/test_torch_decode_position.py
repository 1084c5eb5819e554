"""The decode step's position on the device (``pos`` in the decode state,
``models.model.decode_position``): rope's angles, the ring slot, the cache
write and the ring's window mask all derive from it. Across ring wraps,
sliding windows and half rope, the served tokens and logits equal, bit for
bit, those of the step that took its position on the host (the port's
``attention_decode_step`` as it was, kept here as the oracle), and the JAX
package's within fp32 summation order."""
import dataclasses
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.models import model as jm
from repro_torch import convert
from repro_torch.configs import get_reduced
from repro_torch.models import attention as ta
from repro_torch.runtime import serve_loop
from repro_torch.runtime.serve_loop import make_prefill_step, make_serve_step

torch.set_num_threads(2)

ATOL = 1e-4
B = 2


def host_position_decode(params, x, cache: Dict[str, torch.Tensor], cache_len, cfg, *,
                         window_override: Optional[int] = None, kv_source=None):
    """The port's attention decode with its position on the host: the slot
    written at a host index, the ring's positions from a Python int."""
    b = x.shape[0]
    if kv_source is not None:
        return ta._cross_attention(params, x, kv_source, cfg), cache
    dh, hq, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    cache_len = int(cache_len)
    cap = cache["k"].shape[1]
    pos = torch.full((b, 1), cache_len, dtype=torch.int64, device=x.device)
    q = ta.apply_rope((x @ params["wq"]).reshape(b, 1, hq, dh), pos, cfg.rope_theta,
                      cfg.rope_style)
    k_new = ta.apply_rope((x @ params["wk"]).reshape(b, 1, hkv, dh), pos, cfg.rope_theta,
                          cfg.rope_style)
    v_new = (x @ params["wv"]).reshape(b, 1, hkv, dh)
    slot = cache_len % cap
    cache["k"][:, slot] = k_new[:, 0]
    cache["v"][:, slot] = v_new[:, 0]
    idx = torch.arange(cap, device=x.device)
    abs_pos = cache_len - torch.remainder(cache_len - idx, cap)
    valid = abs_pos >= 0
    window = cfg.sliding_window if window_override is None else window_override
    if window > 0:
        valid &= (cache_len - abs_pos) < window
    bias = torch.where(valid, 0.0, ta.NEG_INF)[None, None, :].expand(b, 1, cap)
    out = ta.dot_product_attention(q, cache["k"], cache["v"], bias, ta._scale(cfg))
    return out.reshape(b, 1, hq * dh) @ params["wo"], cache


# arch, attention fields changed on both sides, prompt length, max_len,
# steps, whether decode passes the smallest ring's capacity
CASES = {
    "granite": ("granite-3-8b", {}, 12, 24, 8, False),
    "granite-window-wrap": ("granite-3-8b", {"sliding_window": 4}, 9, 24, 8, True),
    "chatglm3-half-rope-wrap": ("chatglm3-6b", {}, 9, 11, 8, True),
    "gemma3-local-global-wrap": ("gemma3-12b", {}, 20, 32, 8, True),
    "deepseek": ("deepseek-coder-33b", {}, 12, 24, 6, False),
}


def _cfgs(arch, attn):
    j, t = j_get_reduced(arch), get_reduced(arch)
    return tuple(dataclasses.replace(c, dtype="float32",
                                     attention=dataclasses.replace(c.attention, **attn))
                 for c in (j, t))


def _serve(tparams, tcfg, toks, max_len, steps):
    tok, state = make_prefill_step(tcfg, max_len, impl="xla")(tparams, toks)
    serve = make_serve_step(tcfg)
    tokens, logits = [tok], []
    for _ in range(steps):
        tok, lg, state = serve(tparams, state, tok)
        tokens.append(tok)
        logits.append(lg)
    return torch.stack(tokens), torch.stack(logits), state


@pytest.mark.parametrize("case", CASES)
def test_device_position_decode_matches_host_position_and_jax(case, monkeypatch):
    arch, attn, s, max_len, steps, wraps = CASES[case]
    jcfg, tcfg = _cfgs(arch, attn)
    jparams = jm.init_params(jax.random.PRNGKey(7), jcfg)
    tparams = convert.from_jax_params(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    toks = np.random.default_rng(11).integers(1, jcfg.vocab_size, (B, s)).astype(np.int32)
    before = dict(serve_loop.decode_steps)

    tokens, logits, state = _serve(tparams, tcfg, torch.from_numpy(toks).long(), max_len, steps)
    assert state["length"] == s + steps
    assert state["pos"].dtype == torch.int64 and int(state["pos"]) == s + steps
    assert "graph" not in state
    assert {k: serve_loop.decode_steps[k] - before[k] for k in before} == \
        {"capture": 0, "replay": 0, "eager": steps}
    assert (s + steps > min(c["k"].shape[1] for c in state["cache"])) == wraps

    with monkeypatch.context() as m:
        m.setattr(ta, "attention_decode_step", host_position_decode)
        want_tokens, want_logits, _ = _serve(tparams, tcfg, torch.from_numpy(toks).long(),
                                             max_len, steps)
    assert torch.equal(tokens, want_tokens)
    assert torch.equal(logits, want_logits)

    jlogits, jstate = jm.prefill(jparams, jnp.asarray(toks), jcfg, max_len, impl="xla")
    jtok = jnp.argmax(jlogits, -1).astype(jnp.int32)
    jtokens, jlogit_steps = [np.asarray(jtok)], []
    for _ in range(steps):
        jlogits, jstate = jm.decode_step(jparams, jstate, jtok, jcfg)
        jtok = jnp.argmax(jlogits, -1).astype(jnp.int32)
        jtokens.append(np.asarray(jtok))
        jlogit_steps.append(np.asarray(jlogits))
    np.testing.assert_array_equal(tokens.numpy(), np.stack(jtokens))
    np.testing.assert_allclose(logits.numpy(), np.stack(jlogit_steps), atol=ATOL, rtol=1e-4)
