"""pixtral-12b (prompts as stub patch embeddings through the vision
adapter), chatglm3-6b (half rope, GQA), deepseek-coder-33b (GQA) and
dbrx-132b (GQA, 4 experts top-2 in every layer, untied tables) in the
port against the JAX package, on the reduced configs in fp32 with the
reference's weights (``repro_torch.convert``): forward, loss, prefill and
decode on ``impl="xla"`` and ``impl="pallas"`` (the JAX side in interpret
mode, the port's kernel wrapper on its plain version on the CPU), within
ATOL 1e-4 (rel 1e-4), summation order only; and the forward on
``impl="chunked"`` for every arch of ``ARCH_IDS``. Then the twin of
``tests/test_models.py::test_arch_smoke_forward_and_train_step`` over the
port's ``ARCH_IDS``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.models import model as jm
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, get_bundle, get_config, get_reduced, padded_vocab_size
from repro_torch.models import model as tm
from repro_torch.models.frontends import stub_feature_shape
from repro_torch.runtime.train_loop import make_train_step, train_state_init

torch.set_num_threads(2)

ATOL = 1e-4
B, S, MAX_LEN = 2, 12, 32
ARCHS = ["pixtral-12b", "chatglm3-6b", "deepseek-coder-33b", "dbrx-132b"]


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=atol, rtol=1e-4)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    arch = request.param
    jcfg = dataclasses.replace(j_get_reduced(arch), dtype="float32")
    tcfg = dataclasses.replace(get_reduced(arch), dtype="float32")
    jparams = jm.init_params(jax.random.PRNGKey(1), jcfg)
    tparams = convert.from_jax_params(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    rng = np.random.default_rng(2)
    toks = rng.integers(1, jcfg.vocab_size, (B, S)).astype(np.int32)
    embeds = None
    if tcfg.frontend == "vision":
        embeds = (rng.standard_normal(stub_feature_shape(tcfg, B, S)) * 0.5).astype(np.float32)
    return jcfg, tcfg, jparams, tparams, toks, embeds


def _inputs(toks, embeds, torch_side):
    """(tokens, kwargs) of one prompt batch: embeddings when the arch has a
    vision frontend, else tokens."""
    if embeds is None:
        return (torch.from_numpy(toks).long() if torch_side else jnp.asarray(toks)), {}
    e = torch.from_numpy(embeds) if torch_side else jnp.asarray(embeds)
    return None, {"input_embeds": e}


def test_published_sizes():
    """The registry serves the reference's published sizes."""
    want = {"pixtral-12b": (40, 5120, 14336, 131072, 32, 8, 128),
            "chatglm3-6b": (28, 4096, 13696, 65024, 32, 2, 128),
            "deepseek-coder-33b": (62, 7168, 19200, 32256, 56, 8, 128),
            "whisper-medium": (24, 1024, 4096, 51865, 16, 16, 64)}
    for arch, sizes in want.items():
        c = get_config(arch)
        assert (c.n_layers, c.d_model, c.d_ff, c.vocab_size, c.attention.n_heads,
                c.attention.n_kv_heads, c.attention.head_dim) == sizes, arch
    assert get_config("chatglm3-6b").attention.rope_style == "half"
    assert get_config("whisper-medium").encoder_layers == 24
    assert get_config("pixtral-12b").frontend == "vision"


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_forward_and_loss_match_jax(pair, impl):
    jcfg, tcfg, jparams, tparams, toks, embeds = pair
    jt, jkw = _inputs(toks, embeds, False)
    tt, tkw = _inputs(toks, embeds, True)
    jlogits, _ = jm.forward(jparams, jt, jcfg, impl=impl, **jkw)
    tlogits, _ = tm.forward(tparams, tt, tcfg, impl=impl, **tkw)
    _close(tlogits, jlogits)
    labels = np.roll(toks, -1, axis=1)
    jb = {"labels": jnp.asarray(labels), **({"tokens": jt} if jt is not None else jkw)}
    tb = {"labels": torch.from_numpy(labels).long(),
          **({"tokens": tt} if tt is not None else tkw)}
    jloss = jm.loss_fn(jparams, jb, jcfg, impl=impl)
    tloss = tm.loss_fn(tparams, tb, tcfg, impl=impl)
    assert float(tloss) == pytest.approx(float(jloss), rel=1e-5)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_prefill_and_decode_match_jax(pair, impl):
    jcfg, tcfg, jparams, tparams, toks, embeds = pair
    jt, jkw = _inputs(toks, embeds, False)
    tt, tkw = _inputs(toks, embeds, True)
    jlogits, jstate = jm.prefill(jparams, jt, jcfg, MAX_LEN, impl=impl, **jkw)
    tlogits, tstate = tm.prefill(tparams, tt, tcfg, MAX_LEN, impl=impl, **tkw)
    _close(tlogits, jlogits)
    for i, c in enumerate(tstate["cache"]):
        for name in ("k", "v"):
            _close(c[name], jstate["cache"]["sub0"][name][i])
    tok = np.array(jnp.argmax(jlogits, -1), np.int32)
    for _ in range(4):
        jlogits, jstate = jm.decode_step(jparams, jstate, jnp.asarray(tok), jcfg)
        tlogits, tstate = tm.decode_step(tparams, tstate, torch.from_numpy(tok).long(), tcfg)
        _close(tlogits, jlogits)
        tok = np.array(jnp.argmax(jlogits, -1), np.int32)
    assert tstate["length"] == S + 4


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_chunked_forward_matches_jax(arch):
    """``impl="chunked"`` (streaming online-softmax attention; the Mamba
    layers take the xla math, as the reference's) against the reference's
    own chunked forward, every arch reduced in fp32: logits and aux loss."""
    jcfg = dataclasses.replace(j_get_reduced(arch), dtype="float32")
    tcfg = dataclasses.replace(get_reduced(arch), dtype="float32")
    jparams = jm.init_params(jax.random.PRNGKey(1), jcfg)
    tparams = convert.from_jax_params(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    rng = np.random.default_rng(2)
    toks = rng.integers(1, jcfg.vocab_size, (B, S)).astype(np.int32)
    kw = {}
    if tcfg.frontend == "vision":
        kw["input_embeds"] = (rng.standard_normal(stub_feature_shape(tcfg, B, S))
                              * 0.5).astype(np.float32)
        toks = None
    if tcfg.encoder_layers > 0:
        kw["enc_feats"] = (rng.standard_normal(stub_feature_shape(tcfg, B, 16))
                           * 0.5).astype(np.float32)
    jlogits, jaux = jm.forward(jparams, None if toks is None else jnp.asarray(toks), jcfg,
                               impl="chunked", **{k: jnp.asarray(v) for k, v in kw.items()})
    tlogits, taux = tm.forward(tparams, None if toks is None else torch.from_numpy(toks).long(),
                               tcfg, impl="chunked",
                               **{k: torch.from_numpy(v) for k, v in kw.items()})
    _close(tlogits, jlogits)
    assert float(taux) == pytest.approx(float(jaux), rel=1e-5, abs=1e-9)


def test_adapter_casts_features_to_the_weights_dtype():
    from repro_torch.models import frontends
    cfg = get_reduced("pixtral-12b")
    p = frontends.adapter_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    feats = torch.ones(stub_feature_shape(cfg, 1, 3))
    out = frontends.adapter_apply(p, feats)
    assert p["w"].dtype == out.dtype == torch.bfloat16
    assert out.shape == (1, 3, cfg.d_model)
    assert frontends.frontend_feature_dim(get_reduced("whisper-medium")) == 128
    assert frontends.frontend_feature_dim(cfg) == 1024


def test_sinusoidal_positions_match_jax():
    """fp32 tables; an angle near 1500 rad carries ~1.2e-4 of rounding (one
    ulp), and each package's exp may round the frequencies differently, so
    the tolerance is 2 ulp of the largest angle."""
    from repro.models.layers import sinusoidal_positions as j_sin
    from repro_torch.models.layers import sinusoidal_positions
    for n, d in ((1500, 1024), (7, 64), (3, 2)):
        atol = 2 * float(np.spacing(np.float32(n)))
        np.testing.assert_allclose(sinusoidal_positions(n, d).numpy(), np.asarray(j_sin(n, d)),
                                   atol=max(atol, 1e-6), rtol=0)


# --------------------------------------------------------------------------
# twin of test_arch_smoke_forward_and_train_step over the port's ARCH_IDS
# --------------------------------------------------------------------------

def _batch_for(cfg, seed=0):
    gen = torch.Generator().manual_seed(seed)
    batch = {"labels": torch.zeros((B, 24), dtype=torch.long)}
    if cfg.frontend == "vision":
        batch["input_embeds"] = torch.ones(stub_feature_shape(cfg, B, 24)) * 0.02
    else:
        batch["tokens"] = torch.randint(1, cfg.vocab_size, (B, 24), generator=gen)
    if cfg.encoder_layers > 0:
        batch["enc_feats"] = torch.ones(stub_feature_shape(cfg, B, 16)) * 0.05
    return batch


def test_port_serves_eight_archs():
    """All ten of the reference's archs, in its order (the name is kept
    from when eight were ported)."""
    from repro.configs import ARCH_IDS as J_ARCH_IDS
    assert ARCH_IDS == J_ARCH_IDS and len(ARCH_IDS) == 10
    assert sorted(ARCH_IDS) == sorted([
        "dbrx-132b", "granite-moe-1b-a400m", "gemma3-12b", "deepseek-coder-33b",
        "granite-3-8b", "chatglm3-6b", "jamba-1.5-large-398b", "whisper-medium",
        "mamba2-2.7b", "pixtral-12b"])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_arch_smoke_forward_and_train_step(arch):
    """Reduced config, default dtype: one forward, one train step; finite
    logits of the padded vocab, finite loss and grad norm, step 1, params
    moved."""
    cfg = get_reduced(arch)
    bundle = get_bundle(arch).replace(model=cfg)
    state = train_state_init(0, cfg, bundle, device="cpu")
    batch = _batch_for(cfg)
    with torch.no_grad():
        logits, _ = tm.forward(state.params, batch.get("tokens"), cfg,
                               input_embeds=batch.get("input_embeds"),
                               enc_feats=batch.get("enc_feats"))
    assert logits.shape == (B, 24, padded_vocab_size(cfg))
    assert torch.isfinite(logits.float()).all()
    before = {n: p.detach().clone() for n, p in state.params.named_parameters()}
    state2, metrics = make_train_step(cfg, bundle)(state, batch)
    assert np.isfinite(float(metrics["loss"])) and np.isfinite(float(metrics["grad_norm"]))
    assert state2.step == 1
    moved = max(float((p.detach().float() - before[n].float()).abs().max())
                for n, p in state2.params.named_parameters())
    assert moved > 0
