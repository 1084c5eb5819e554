"""Port attention against the JAX package's attention, fp32, same inputs.

``impl="pallas"`` runs the JAX Pallas kernel in interpret mode and the
port's plain version (CPU tensors), so both sides stay on the CPU.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import AttentionConfig as JAttentionConfig
from repro.models import attention as ja
from repro_torch.configs.base import AttentionConfig
from repro_torch.models import attention as ta

torch.set_num_threads(2)

ATOL = 2e-5     # fp32, attention outputs O(1): summation order only
D_MODEL = 32


def _cfgs(**kw):
    base = dict(n_heads=4, n_kv_heads=2, head_dim=8)
    base.update(kw)
    return JAttentionConfig(**base), AttentionConfig(**base)


def _params(seed):
    rng = np.random.default_rng(seed)
    shapes = {"wq": (D_MODEL, 32), "wk": (D_MODEL, 16), "wv": (D_MODEL, 16),
              "wo": (32, D_MODEL)}
    p = {k: rng.standard_normal(s, dtype=np.float32) / float(np.sqrt(s[0]))
         for k, s in shapes.items()}
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol,
                               rtol=1e-5)


def _qkv(seed, b, sq, sk, hq=4, hkv=2, d=8):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, hq, d), dtype=np.float32),
            rng.standard_normal((b, sk, hkv, d), dtype=np.float32),
            rng.standard_normal((b, sk, hkv, d), dtype=np.float32))


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5), (False, 0)])
def test_mask_bias_and_dot_product_attention(causal, window):
    q, k, v = _qkv(0, 2, 12, 12)
    pos = np.broadcast_to(np.arange(12), (2, 12)).copy()
    jb = ja._mask_bias(jnp.asarray(pos), jnp.asarray(pos), causal, window)
    tb = ta._mask_bias(torch.from_numpy(pos), torch.from_numpy(pos), causal, window)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    want = ja.dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    jb, 0.3)
    got = ta.dot_product_attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), tb, 0.3)
    _close(got, want)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 7), (False, 0)])
def test_chunked_attention(causal, window):
    """Blocks that do not divide the sequence exercise the padded tail."""
    q, k, v = _qkv(1, 2, 40, 40)
    kw = dict(causal=causal, window=window, scale=0.35, block_q=16, block_k=12)
    want = ja.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    got = ta.chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), **kw)
    _close(got, want)
    dense = ta.dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        ta._mask_bias(torch.arange(40)[None], torch.arange(40)[None], causal, window),
        0.35)
    _close(got, dense.numpy())


@pytest.mark.parametrize("impl", ["xla", "chunked", "pallas"])
@pytest.mark.parametrize("window", [0, 6])
def test_attention_apply(impl, window):
    jcfg, tcfg = _cfgs(sliding_window=window)
    jp, tp = _params(2)
    x = np.random.default_rng(3).standard_normal((2, 20, D_MODEL), dtype=np.float32)
    pos = np.broadcast_to(np.arange(20), (2, 20)).copy()
    want = ja.attention_apply(jp, jnp.asarray(x), jcfg, jnp.asarray(pos), impl=impl)
    got = ta.attention_apply(tp, torch.from_numpy(x), tcfg, torch.from_numpy(pos),
                             impl=impl)
    _close(got, want)


@pytest.mark.parametrize("impl", ["xla", "chunked", "pallas"])
@pytest.mark.parametrize("cache_len", [24, 7])
def test_attention_prefill(impl, cache_len):
    """cache_len 7 < S = 16 exercises the ring-layout fill."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(4)
    x = np.random.default_rng(5).standard_normal((2, 16, D_MODEL), dtype=np.float32)
    pos = np.broadcast_to(np.arange(16), (2, 16)).copy()
    jout, jcache = ja.attention_prefill(jp, jnp.asarray(x), jcfg, jnp.asarray(pos),
                                        cache_len, impl=impl)
    tout, tcache = ta.attention_prefill(tp, torch.from_numpy(x), tcfg,
                                        torch.from_numpy(pos), cache_len, impl=impl)
    _close(tout, jout)
    for key in ("k", "v"):
        assert tuple(tcache[key].shape) == (2, cache_len, 2, 8)
        _close(tcache[key], jcache[key], atol=1e-5)


def test_attention_impls_agree_in_port():
    _, tcfg = _cfgs()
    _, tp = _params(6)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (1, 18, D_MODEL), dtype=np.float32))
    pos = torch.arange(18)[None]
    outs = [ta.attention_apply(tp, x, tcfg, pos, impl=i) for i in ta.IMPLS]
    for o in outs[1:]:
        _close(o, outs[0].numpy())
    with pytest.raises(ValueError):
        ta.attention_apply(tp, x, tcfg, pos, impl="triton")


@pytest.mark.parametrize("cap,window,steps", [
    (16, 0, 10),     # no wrap
    (6, 0, 14),      # ring wrap-around: old slots are overwritten
    (16, 4, 12),     # window eviction inside a larger cache
    (4, 4, 11),      # window-sized ring, as sliding-window layers allocate
])
def test_attention_decode_step(cap, window, steps):
    jcfg, tcfg = _cfgs(sliding_window=window)
    jp, tp = _params(8)
    xs = np.random.default_rng(9).standard_normal((steps, 2, 1, D_MODEL),
                                                  dtype=np.float32)
    jcache = ja.init_kv_cache(2, cap, jcfg, dtype=jnp.float32)
    tcache = ta.init_kv_cache(2, cap, tcfg, dtype=torch.float32)
    for t in range(steps):
        jout, jcache = ja.attention_decode_step(jp, jnp.asarray(xs[t]), jcache,
                                                jnp.int32(t), jcfg)
        tout, tcache2 = ta.attention_decode_step(tp, torch.from_numpy(xs[t]), tcache,
                                                 t, tcfg)
        assert tcache2 is tcache            # updated in place
        _close(tout, jout)
        for key in ("k", "v"):
            _close(tcache[key], jcache[key], atol=1e-5)


def test_decode_rejects_multi_token_input():
    _, tcfg = _cfgs()
    _, tp = _params(10)
    cache = ta.init_kv_cache(1, 4, tcfg, dtype=torch.float32)
    with pytest.raises(ValueError):
        ta.attention_decode_step(tp, torch.zeros(1, 2, D_MODEL), cache, 0, tcfg)


def test_attention_config_is_a_copy():
    """The port's config is its own class with the reference's fields."""
    jcfg, tcfg = _cfgs()
    assert type(tcfg) is not type(jcfg)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
