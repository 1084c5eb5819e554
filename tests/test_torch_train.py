"""Training math of the port against the JAX package: the loss and its
gradients (dense, chunked cross-entropy, remat, chunked attention), AdamW
with the reference's decay rule, the warmup-cosine schedule and the
top-k / int8 compression with error feedback.

The port gets the reference's weights through ``repro_torch.convert`` and
every random input is drawn with numpy, so both packages see the same
numbers; float32 configs, at tests/test_models.py's prefill tolerance
(5e-4) unless stated.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.models import attention as ja
from repro.models import model as jm
from repro.optim import adamw as j_adamw
from repro.optim import compression as j_comp
from repro.optim import schedule as j_sched
from repro_torch import convert
from repro_torch.configs import get_reduced
from repro_torch.models import attention as ta
from repro_torch.models import model as tm
from repro_torch.optim import adamw as t_adamw
from repro_torch.optim import compression as t_comp
from repro_torch.optim import schedule as t_sched
from repro_torch.runtime import train_loop as ttl

torch.set_num_threads(2)

ATOL = 5e-4            # tests/test_models.py::test_prefill_matches_stepwise_decode
B, S = 2, 24


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(arch, **kw):
    return (dataclasses.replace(j_get_reduced(arch), dtype="float32", **kw),
            dataclasses.replace(get_reduced(arch), dtype="float32", **kw))


def _batch(cfg, seed, b=B, s=S):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(1, cfg.vocab_size, (b, s)).astype(np.int32),
            "labels": rng.integers(1, cfg.vocab_size, (b, s)).astype(np.int32)}


def _grads_tree(model, grads, cfg):
    """Port grads (by parameter name) in the reference's tree layout."""
    gm = copy.deepcopy(model)
    with torch.no_grad():
        for n, p in gm.named_parameters():
            p.data = grads[n].detach().clone()
    return convert.to_jax_layout(gm, cfg)


def _assert_trees_close(got, want, atol, rtol=0.0):
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert len(flat_g) == len(flat_w)
    for path, g in flat_g:
        np.testing.assert_allclose(np.asarray(g, np.float32),
                                   np.asarray(flat_w[path], np.float32),
                                   atol=atol, rtol=rtol, err_msg=jax.tree_util.keystr(path))


# --- loss and gradients ---------------------------------------------------------

LOSS_CASES = [("granite-3-8b", {}, "none"), ("granite-3-8b", {}, "full"),
              ("mamba2-2.7b", {}, "none"), ("mamba2-2.7b", {}, "dots"),
              # padded vocab >= CHUNKED_XENT_VOCAB: both packages take the chunked loss
              ("granite-3-8b", {"vocab_size": 33_000}, "none")]


@pytest.mark.parametrize("arch,kw,remat", LOSS_CASES,
                         ids=[f"{a}-{k or 'base'}-{r}" for a, k, r in LOSS_CASES])
def test_loss_and_grads_match_jax(arch, kw, remat):
    jcfg, tcfg = _cfgs(arch, **kw)
    jparams = jm.init_params(jax.random.PRNGKey(4), jcfg)
    model = convert.from_jax_params(_np_tree(jparams), tcfg, device="cpu")
    for p in model.parameters():
        p.requires_grad_(True)
    batch = _batch(tcfg, 11)
    want_loss, want_g = jax.value_and_grad(jm.loss_fn)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg, remat=remat)
    loss, grads = ttl.value_and_grad(model, {k: torch.from_numpy(v) for k, v in batch.items()},
                                     tcfg, "xla", remat)
    assert float(loss) == pytest.approx(float(want_loss), abs=ATOL)
    _assert_trees_close(_grads_tree(model, grads, tcfg), _np_tree(want_g), ATOL)


def test_remat_changes_memory_not_results():
    _, tcfg = _cfgs("mamba2-2.7b")
    model = tm.init_params(tcfg, 2, device="cpu")
    for p in model.parameters():
        p.requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in _batch(tcfg, 3).items()}
    l0, g0 = ttl.value_and_grad(model, batch, tcfg, "xla", "none")
    l1, g1 = ttl.value_and_grad(model, batch, tcfg, "xla", "full")
    assert float(l0) == float(l1)
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="remat"):
        tm.loss_fn(model, batch, tcfg, remat="some")


def test_serving_weights_stay_frozen_and_training_turns_grads_on():
    from repro_torch.configs import ArchBundle
    _, tcfg = _cfgs("granite-3-8b")
    served = tm.init_params(tcfg, 0, device="cpu")
    assert not any(p.requires_grad for p in served.parameters())
    state = ttl.train_state_init(0, tcfg, ArchBundle(model=tcfg), device="cpu")
    assert all(p.requires_grad for p in state.params.parameters())
    assert not any(p.requires_grad for p in tm.init_params(tcfg, 0, device="cpu").parameters())


# --- twins of tests/test_models.py ------------------------------------------------

def test_pad_vocab_loss_exactness():
    """Pad-vocab logits must not leak probability mass into the loss."""
    cfg = dataclasses.replace(get_reduced("granite-3-8b"), vocab_size=49155 % 997 + 130)
    from repro_torch.configs import padded_vocab_size
    assert padded_vocab_size(cfg) != cfg.vocab_size
    params = tm.init_params(cfg, 0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 0).items()}
    with torch.no_grad():
        loss = tm.loss_fn(params, batch, cfg)
        logits, _ = tm.forward(params, batch["tokens"], cfg)
    lg = logits.float().numpy()[..., :cfg.vocab_size]
    lp = lg - np.log(np.exp(lg - lg.max(-1, keepdims=True)).sum(-1, keepdims=True)) \
        - lg.max(-1, keepdims=True)
    nll = -np.take_along_axis(lp, batch["labels"].long().numpy()[..., None], -1).mean()
    assert float(loss) == pytest.approx(nll, rel=1e-3)


def test_chunked_xent_matches_dense(monkeypatch):
    """Memory-lean vocab-chunked cross-entropy == dense loss, value + grad."""
    cfg = dataclasses.replace(get_reduced("granite-3-8b"), vocab_size=1234, dtype="float32")
    prm = tm.init_params(cfg, 0, device="cpu")
    for p in prm.parameters():
        p.requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 1, 2, 12).items()}

    monkeypatch.setenv("REPRO_DENSE_XENT", "1")
    l1 = tm.loss_fn(prm, batch, cfg)
    g1 = torch.autograd.grad(l1, list(prm.parameters()))
    monkeypatch.delenv("REPRO_DENSE_XENT")
    x, aux = tm.hidden_states(prm, batch["tokens"], cfg)
    nll = tm.chunked_softmax_xent(x, prm["embed"]["table"], batch["labels"].long(),
                                  cfg.vocab_size, chunk=256)
    l2 = nll.mean() + aux
    g2 = torch.autograd.grad(l2, list(prm.parameters()))
    assert float(l1.detach()) == pytest.approx(float(l2.detach()), abs=1e-4)
    assert max(float((a - b).abs().max()) for a, b in zip(g1, g2)) < 1e-4


@pytest.mark.parametrize("switch", ["REPRO_NAIVE_LOSS", "REPRO_DENSE_XENT"])
def test_loss_switches_match_jax(monkeypatch, switch):
    """Both environment switches turn the chunked loss of a >= 32768 padded
    vocab into the dense forms, in both packages."""
    jcfg, tcfg = _cfgs("granite-3-8b", vocab_size=33_000)
    jparams = jm.init_params(jax.random.PRNGKey(6), jcfg)
    model = convert.from_jax_params(_np_tree(jparams), tcfg, device="cpu")
    batch = _batch(tcfg, 12)
    monkeypatch.setenv(switch, "1")
    want = jm.loss_fn(jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    with torch.no_grad():
        got = tm.loss_fn(model, {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg)
    assert float(got) == pytest.approx(float(want), abs=ATOL)


def test_chunked_attention_gradients_match():
    rng = np.random.default_rng(0)
    qn, kn, vn = (rng.standard_normal((1, 64, 2, 16), dtype=np.float32) for _ in range(3))
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in (qn, kn, vn))
    pos = torch.arange(64)[None]

    dense = (ta.dot_product_attention(q, k, v, ta._mask_bias(pos, pos, True, 0), 0.25)
             ** 2).sum()
    g1 = torch.autograd.grad(dense, (q, k, v))
    chunk = (ta.chunked_attention(q, k, v, causal=True, window=0, scale=0.25,
                                  block_q=16, block_k=32) ** 2).sum()
    g2 = torch.autograd.grad(chunk, (q, k, v))
    for a, b in zip(g1, g2):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=3e-4)
    # and against the reference's chunked gradients on the same numbers
    def f_chunk(q, k, v):
        return jnp.sum(ja.chunked_attention(q, k, v, causal=True, window=0, scale=0.25,
                                            block_q=16, block_k=32) ** 2)

    g3 = jax.grad(f_chunk, argnums=(0, 1, 2))(jnp.asarray(qn), jnp.asarray(kn),
                                              jnp.asarray(vn))
    for a, b in zip(g2, g3):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=3e-4)


def test_long_sequence_training_takes_the_chunked_attention_path():
    """S >= CHUNKED_THRESHOLD streams through chunked attention, which must
    carry gradients, as the reference's does."""
    cfg = dataclasses.replace(get_reduced("granite-3-8b"), n_layers=1, dtype="float32")
    prm = tm.init_params(cfg, 1, device="cpu")
    for p in prm.parameters():
        p.requires_grad_(True)
    s = ta.CHUNKED_THRESHOLD
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 2, 1, s).items()}
    loss = tm.loss_fn(prm, batch, cfg)
    grads = torch.autograd.grad(loss, list(prm.parameters()))
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert float(grads[[n for n, _ in prm.named_parameters()].index(
        "stack.0.mixer.wq")].abs().max()) > 0


# --- AdamW ---------------------------------------------------------------------------

def _adamw_pair(arch, moment_dtype="float32"):
    jcfg, tcfg = _cfgs(arch)
    jparams = jm.init_params(jax.random.PRNGKey(7), jcfg)
    rng = np.random.default_rng(8)
    jgrads = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32) * 0.1,
                          _np_tree(jparams))
    model = convert.from_jax_params(_np_tree(jparams), tcfg, device="cpu")
    tgrads = dict(convert.from_jax_params(jgrads, tcfg, device="cpu").named_parameters())
    tgrads = {n: g.detach() for n, g in tgrads.items()}
    return jcfg, tcfg, jparams, jgrads, model, tgrads


@pytest.mark.parametrize("arch", ["granite-3-8b", "mamba2-2.7b"])
@pytest.mark.parametrize("grad_clip", [0.0, 1.0])
@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_two_steps_match_reference(arch, grad_clip, moment_dtype):
    jcfg, tcfg, jparams, jgrads, model, tgrads = _adamw_pair(arch)
    jst = j_adamw.adamw_init(jparams, moment_dtype)
    tst = t_adamw.adamw_init(model, moment_dtype)
    kw = dict(lr=3e-3, beta1=0.9, beta2=0.95, weight_decay=0.1, grad_clip=grad_clip)
    for _ in range(2):
        jparams, jst, jn = j_adamw.adamw_update(jax.tree.map(jnp.asarray, jgrads), jst,
                                                jparams, **kw)
        model, tst, tn = t_adamw.adamw_update(tgrads, tst, model, **kw)
        assert float(tn) == pytest.approx(float(jn), rel=1e-5)
    assert tst.step == int(jst.step) == 2
    # fp32 moments: summation order only. bf16 moments: a first moment one
    # fp32 ulp apart can round to neighbouring bf16 values (2**-8 apart), so
    # the second update may differ by lr * 2**-8 ~ 1.2e-5
    atol = 2e-6 if moment_dtype == "float32" else 3e-5
    _assert_trees_close(convert.to_jax_layout(model, tcfg), _np_tree(jparams), atol, 1e-6)
    mu = copy.deepcopy(model)
    with torch.no_grad():
        for n, p in mu.named_parameters():
            p.data = tst.mu[n].float()
    _assert_trees_close(convert.to_jax_layout(mu, tcfg),
                        jax.tree.map(lambda a: np.asarray(a, np.float32), jst.mu),
                        1e-6, 1e-5 if moment_dtype == "float32" else 2 ** -7)


def test_adamw_decays_stack_leaves_by_the_references_rank():
    """A layer's 1-D leaves are rank 2 in the reference's stacked layout and
    are decayed; the top-level final norm (1-D there too) is not."""
    _, tcfg = _cfgs("mamba2-2.7b")
    model = tm.init_params(tcfg, 0, device="cpu")
    names = dict(model.named_parameters())
    one_d_stack = [n for n, p in names.items() if n.startswith("stack.") and p.dim() == 1]
    assert {"stack.0.norm1.scale", "stack.0.mixer.a_log", "stack.0.mixer.d_skip",
            "stack.0.mixer.gate_norm.scale"} <= set(one_d_stack)
    assert all(t_adamw.decays(n, names[n]) for n in one_d_stack)
    assert t_adamw.reference_rank("stack.3.norm1.scale", names["stack.0.norm1.scale"]) == 2
    assert not t_adamw.decays("final_norm.scale", names["final_norm.scale"])
    assert t_adamw.decays("embed.table", names["embed.table"])
    before = {n: p.detach().clone() for n, p in names.items()}
    zeros = {n: torch.zeros_like(p) for n, p in names.items()}
    t_adamw.adamw_update(zeros, t_adamw.adamw_init(model), model, lr=0.5, weight_decay=0.1)
    for n, p in model.named_parameters():
        want = before[n] * (1 - 0.05) if t_adamw.decays(n, p) else before[n]
        torch.testing.assert_close(p.detach(), want, rtol=1e-6, atol=0)


# --- schedule and compression -------------------------------------------------------------

@pytest.mark.parametrize("warmup,total,floor", [(10, 50, 0.1), (0, 20, 0.0), (5, 5, 0.3)])
def test_warmup_cosine_matches_reference(warmup, total, floor):
    for step in range(0, total + 10):
        want = j_sched.warmup_cosine(jnp.asarray(step, jnp.int32), peak_lr=3e-4,
                                     warmup_steps=warmup, total_steps=total, floor=floor)
        got = t_sched.warmup_cosine(step, peak_lr=3e-4, warmup_steps=warmup,
                                    total_steps=total, floor=floor)
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(float(want), rel=1e-6, abs=1e-12), step


@pytest.mark.parametrize("scheme", ["topk", "int8"])
def test_compression_with_error_feedback_matches_reference(scheme):
    """Per reference leaf (the port stacks each layer group's gradients
    first), over three rounds of error feedback."""
    _, tcfg, _, jgrads, model, tgrads = _adamw_pair("granite-3-8b")
    jcs = j_comp.compression_init(jgrads)
    tcs = t_comp.compression_init(tgrads)
    for r in range(3):
        scale = np.float32(1.0 + r)
        jsent, jcs = j_comp.compress_decompress(
            jax.tree.map(lambda g: jnp.asarray(g * scale), jgrads), jcs, scheme=scheme,
            topk_frac=0.05)
        tsent, tcs = t_comp.compress_decompress(
            {n: g * scale for n, g in tgrads.items()}, tcs, scheme=scheme, topk_frac=0.05,
            period=tcfg.layer_period)
    _assert_trees_close(_grads_tree(model, tsent, tcfg), _np_tree(jsent), 1e-6, 1e-6)
    _assert_trees_close(_grads_tree(model, tcs.error, tcfg), _np_tree(jcs.error), 1e-6, 1e-6)


def test_compression_groups_stack_leaves_like_the_reference():
    names = ["embed.table", "stack.0.norm1.scale", "stack.1.norm1.scale",
             "stack.2.norm1.scale", "stack.3.norm1.scale", "final_norm.scale"]
    assert t_comp.reference_leaves(names, period=1) == [
        ["embed.table"], names[1:5], ["final_norm.scale"]]
    assert t_comp.reference_leaves(names, period=2) == [
        ["embed.table"], ["stack.0.norm1.scale", "stack.2.norm1.scale"],
        ["stack.1.norm1.scale", "stack.3.norm1.scale"], ["final_norm.scale"]]
    with pytest.raises(ValueError, match="unknown compression"):
        t_comp.compress_decompress({"a": torch.ones(2)},
                                   t_comp.compression_init({"a": torch.ones(2)}), scheme="x")


def test_train_step_with_compression_matches_reference():
    """One full train step (loss, grads, int8 compression with error
    feedback, schedule, AdamW) in both packages on the same params."""
    from repro.configs.base import ArchBundle as JBundle, TrainConfig as JTrain
    from repro.runtime import train_loop as jtl
    from repro_torch.configs import ArchBundle, TrainConfig
    jcfg, tcfg = _cfgs("granite-3-8b")
    tc = dict(lr=1e-3, warmup_steps=2, total_steps=10, compression="int8")
    jb, tb = JBundle(model=jcfg, train=JTrain(**tc)), ArchBundle(model=tcfg, train=TrainConfig(**tc))
    jst = jtl.train_state_init(jax.random.PRNGKey(3), jcfg, jb)
    tst = ttl.train_state_from_params(
        convert.from_jax_params(_np_tree(jst.params), tcfg, device="cpu"), tb)
    batch = _batch(tcfg, 5)
    jst, jm_ = jtl.make_train_step(jcfg, jb)(jst, {k: jnp.asarray(v) for k, v in batch.items()})
    tst, tm_ = ttl.make_train_step(tcfg, tb)(tst, {k: torch.from_numpy(v)
                                                   for k, v in batch.items()})
    assert tst.step == int(jst.step) == 1
    for key in ("loss", "grad_norm", "lr"):
        assert float(tm_[key]) == pytest.approx(float(jm_[key]), rel=1e-4), key
    _assert_trees_close(convert.to_jax_layout(tst.params, tcfg), _np_tree(jst.params), 1e-5)
