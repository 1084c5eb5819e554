"""The port's MoE FFN (``repro_torch.models.moe``) and granite-moe-1b-a400m
against the JAX package.

The same router and expert weights (the reference's ``moe_init``, moved
as numpy) and the same numpy inputs go through both packages' sort
dispatch: with drops (capacity factor 1.25), without, with skewed shard
capacities, and with tied gates, which pin the top-k order (lower expert
index first, as ``jax.lax.top_k``). Then reduced granite-moe end to end:
prefill against the reference and against stepwise decode, and one train
step, whose loss carries the aux loss. float32 at 1e-5 unless stated.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import (ArchBundle, MoEConfig, TrainConfig, get_config,
                                 get_reduced)
from repro_torch.models import model as tm
from repro_torch.models import moe as tmoe
from repro_torch.runtime import train_loop as ttl

torch.set_num_threads(2)

ARCH = "granite-moe-1b-a400m"
TOL = 1e-5
ATOL_MODEL = 5e-4      # tests/test_models.py::test_prefill_matches_stepwise_decode
D, F = 32, 48
B, S = 3, 20


@pytest.fixture(scope="module")
def J():
    """The JAX package, imported here and not at the top, so that the
    ``gpu`` test runs on a machine without JAX."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_reduced as j_get_reduced
    from repro.configs.base import ArchBundle as JBundle, MoEConfig as JMoE
    from repro.configs.base import TrainConfig as JTrain
    from repro.models import model as jm
    from repro.models import moe as jmoe
    from repro.runtime import train_loop as jtl
    return SimpleNamespace(jax=jax, jnp=jnp, get_reduced=j_get_reduced, ArchBundle=JBundle,
                           MoEConfig=JMoE, TrainConfig=JTrain, jm=jm, jmoe=jmoe, jtl=jtl)


def _np_tree(J, tree):
    return J.jax.tree.map(np.asarray, tree)


def _params(J, e, glu, seed=0, dtype=None, tie=None):
    """The reference's MoE params (numpy) and the port's copy. ``tie``
    "pairs" makes router columns 2j and 2j+1 equal, "all" every column."""
    p = _np_tree(J, J.jmoe.moe_init(J.jax.random.PRNGKey(seed), D, F,
                                    J.MoEConfig(n_experts=e, top_k=2), glu,
                                    J.jnp.float32 if dtype is None else dtype))
    if tie == "pairs":
        p["router"] = np.repeat(p["router"][:, ::2], 2, axis=1)
    elif tie == "all":
        p["router"] = np.repeat(p["router"][:, :1], e, axis=1)
    tp = {k: convert._to_torch(v, torch.device("cpu")) for k, v in p.items()}
    return p, tp


def _x(seed, dtype=np.float32, b=B, s=S):
    return np.random.default_rng(seed).standard_normal((b, s, D)).astype(dtype)


CASES = {
    "drops": dict(n_experts=4, top_k=2, capacity_factor=1.25),
    "no-drops": dict(n_experts=4, top_k=2, capacity_factor=4.0),
    "top3-drops": dict(n_experts=6, top_k=3, capacity_factor=1.0),
    "skewed": dict(n_experts=4, top_k=2, capacity_factor=1.25,
                   shard_capacities=(1.0, 1.0, 1.0, 0.4)),
    "skewed-hard": dict(n_experts=4, top_k=2, capacity_factor=1.0,
                        shard_capacities=(3.0, 0.5, 1.0, 0.1)),
    "tied-pairs": dict(n_experts=4, top_k=2, capacity_factor=1.25),
    "tied-all": dict(n_experts=4, top_k=2, capacity_factor=1.25),
}


@pytest.mark.parametrize("glu", [True, False], ids=["glu", "mlp"])
@pytest.mark.parametrize("case", list(CASES))
def test_moe_apply_matches_reference(J, case, glu):
    kw = CASES[case]
    tie = case[len("tied-"):] if case.startswith("tied") else None
    p, tp = _params(J, kw["n_experts"], glu, tie=tie)
    x = _x(1)
    act = "silu" if glu else "gelu"
    want, want_aux = J.jmoe.moe_apply(p, J.jnp.asarray(x), J.MoEConfig(**kw), act)
    got, aux = tmoe.moe_apply(tp, torch.from_numpy(x), MoEConfig(**kw), act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    assert float(aux) == pytest.approx(float(want_aux), rel=1e-6, abs=1e-9)


@pytest.mark.parametrize("case", ["drops", "tied-pairs", "tied-all", "skewed-hard"])
def test_routing_and_drops_match_reference(J, case):
    """The top-k choice, its weights and which (token, choice) pairs are
    kept, against the reference's own arithmetic on the same gates; and
    the case drops pairs at all (except where it has room)."""
    kw = CASES[case]
    tie = case[len("tied-"):] if case.startswith("tied") else None
    p, tp = _params(J, kw["n_experts"], True, tie=tie)
    x = _x(2)
    gates = J.jax.nn.softmax(J.jnp.asarray(x) @ p["router"], axis=-1)
    want_w, want_i = J.jax.lax.top_k(gates, kw["top_k"])
    top_w, top_i, _ = tmoe.route(tp, torch.from_numpy(x), MoEConfig(**kw))
    np.testing.assert_array_equal(top_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(top_w.numpy(),
                               np.asarray(want_w / want_w.sum(-1, keepdims=True)), rtol=1e-6)
    caps = tmoe.expert_capacities(MoEConfig(**kw), S)
    slot, keep, tok, _ = tmoe.dispatch_slots(top_i, torch.from_numpy(caps).long(),
                                             int(caps.max()))
    # the reference's keep rule: a pair is kept while its expert's run,
    # counted in token order, is below that expert's capacity
    flat = np.asarray(want_i).reshape(B, -1)
    for b in range(B):
        seen = np.zeros(kw["n_experts"], int)
        want_keep = []
        for e in flat[b]:
            want_keep.append(seen[e] < caps[e])
            seen[e] += 1
        order = np.argsort(flat[b], kind="stable")
        assert keep[b].tolist() == np.asarray(want_keep)[order].tolist()
        assert tok[b].tolist() == (order // kw["top_k"]).tolist()
    assert int((~keep).sum()) > 0


@pytest.mark.parametrize("case", list(CASES))
def test_no_kept_slot_repeats(J, case):
    """Kept pairs land in distinct buffer slots inside their expert's
    block; only dropped pairs share the drop slot e * cap_buf."""
    kw = CASES[case]
    tie = case[len("tied-"):] if case.startswith("tied") else None
    _, tp = _params(J, kw["n_experts"], True, tie=tie)
    cfg = MoEConfig(**kw)
    _, top_i, _ = tmoe.route(tp, torch.from_numpy(_x(3)), cfg)
    caps = tmoe.expert_capacities(cfg, S)
    cap_buf = int(caps.max())
    slot, keep, _, order = tmoe.dispatch_slots(top_i, torch.from_numpy(caps).long(), cap_buf)
    e_sorted = torch.gather(top_i.reshape(B, -1), 1, order)
    for b in range(B):
        kept = slot[b][keep[b]]
        assert kept.unique().numel() == kept.numel()
        assert bool((kept // cap_buf == e_sorted[b][keep[b]]).all())
        assert bool((kept % cap_buf < torch.from_numpy(caps).long()[e_sorted[b][keep[b]]]).all())
        assert bool((slot[b][~keep[b]] == kw["n_experts"] * cap_buf).all())


def test_moe_capacity_skew_shifts_tokens(J):
    """Twin of tests/test_models.py::test_moe_capacity_skew_shifts_tokens."""
    for tokens, caps in ((64, (1.0, 1.0, 1.0, 0.4)), (37, (3.0, 0.5, 1.0, 0.1)),
                         (1, None), (1024, (2.0, 1.0))):
        kw = dict(n_experts=len(caps) if caps else 8, top_k=2, shard_capacities=caps)
        got = tmoe.expert_capacities(MoEConfig(**kw), tokens)
        want = J.jmoe.expert_capacities(J.MoEConfig(**kw), tokens)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    even = tmoe.expert_capacities(MoEConfig(n_experts=4, top_k=2), 64)
    skew = tmoe.expert_capacities(MoEConfig(n_experts=4, top_k=2,
                                            shard_capacities=(1.0, 1.0, 1.0, 0.4)), 64)
    assert len(set(even.tolist())) == 1 and skew.sum() == even.sum()
    assert skew[3] < skew[0] and abs(skew[3] / skew[0] - 0.4) < 0.15


def test_moe_sort_dispatch_matches_dense_oracle(J):
    """Twin of tests/test_models.py::test_moe_sort_dispatch_matches_dense_oracle:
    with room for every pair, the sort dispatch equals the dense oracle,
    and the port's oracle equals the reference's."""
    cfg_kw = dict(n_experts=4, top_k=2, capacity_factor=4.0)
    p = _np_tree(J, J.jmoe.moe_init(J.jax.random.PRNGKey(0), 32, 64, J.MoEConfig(**cfg_kw), True, J.jnp.float32))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    x = np.array(J.jax.random.normal(J.jax.random.PRNGKey(1), (3, 16, 32)))
    o1, a1 = tmoe.moe_apply(tp, torch.from_numpy(x), MoEConfig(**cfg_kw))
    o2, a2 = tmoe.moe_apply_dense_fallback(tp, torch.from_numpy(x), MoEConfig(**cfg_kw))
    np.testing.assert_allclose(o1.numpy(), o2.numpy(), atol=1e-4)
    assert float(a1) == pytest.approx(float(a2))
    w2, wa2 = J.jmoe.moe_apply_dense_fallback(p, J.jnp.asarray(x), J.MoEConfig(**cfg_kw))
    np.testing.assert_allclose(o2.numpy(), np.asarray(w2), atol=TOL, rtol=TOL)
    assert float(a2) == pytest.approx(float(wa2), rel=1e-6)


def test_moe_bf16_matches_reference(J):
    """bf16 weights and activations: the combine weights the gathered rows
    in x's dtype and adds them in x's dtype, as the reference does; top-2,
    so each token's sum has one rounding whatever the order."""
    p, tp = _params(J, 4, True, dtype=J.jnp.bfloat16)
    p["router"] = p["router"].astype(np.float32)
    tp["router"] = tp["router"].float()
    x32 = _x(4)
    x = J.jnp.asarray(x32).astype(J.jnp.bfloat16)
    kw = CASES["drops"]
    want, want_aux = J.jmoe.moe_apply(p, x, J.MoEConfig(**kw))
    got, aux = tmoe.moe_apply(tp, torch.from_numpy(x32).bfloat16(), MoEConfig(**kw))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=2e-2, rtol=1e-2)
    assert float(aux) == pytest.approx(float(want_aux), rel=1e-5)


def test_moe_init_shapes_and_dtypes(J):
    cfg = MoEConfig(n_experts=4, top_k=2)
    gen = torch.Generator().manual_seed(0)
    p = tmoe.moe_init(gen, D, F, cfg, True)
    want = _np_tree(J, J.jmoe.moe_init(J.jax.random.PRNGKey(0), D, F, J.MoEConfig(n_experts=4, top_k=2), True))
    assert sorted(p.keys()) == sorted(want)
    for k, v in want.items():
        assert tuple(p[k].shape) == v.shape
        assert str(p[k].dtype).replace("torch.", "") == str(v.dtype)
    assert abs(float(p["w_up"].float().std()) - D ** -0.5) < 0.02
    assert "w_gate" not in tmoe.moe_init(gen, D, F, cfg, False)


# --------------------------------------------------------------------------
# reduced granite-moe end to end
# --------------------------------------------------------------------------

def _cfgs(J, dtype="float32", **moe_kw):
    jcfg = dataclasses.replace(J.get_reduced(ARCH), dtype=dtype)
    tcfg = dataclasses.replace(get_reduced(ARCH), dtype=dtype)
    if moe_kw:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, **moe_kw))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe, **moe_kw))
    return jcfg, tcfg


def test_registry_and_layer_kinds(J):
    full = get_config(ARCH)
    assert (full.n_layers, full.d_model, full.d_ff, full.moe.n_experts, full.moe.top_k,
            full.attention.head_dim) == (24, 1024, 512, 32, 8, 64)
    assert all(full.layer_is_moe(i) for i in range(full.n_layers))
    _, tcfg = _cfgs(J)
    params = tm.init_params(tcfg, 0, device="cpu")
    assert sorted(params["stack"][0]["ffn"].keys()) == ["router", "w_down", "w_gate", "w_up"]
    assert params["stack"][0]["ffn"]["router"].dtype == torch.float32


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_prefill_matches_jax(J, impl):
    """With the default capacity factor (drops happen at 20 tokens)."""
    jcfg, tcfg = _cfgs(J)
    jparams = J.jm.init_params(J.jax.random.PRNGKey(1), jcfg)
    tparams = convert.from_jax_params(_np_tree(J, jparams), tcfg, device="cpu")
    toks = np.random.default_rng(2).integers(1, jcfg.vocab_size, (2, S)).astype(np.int32)
    jlogits, jstate = J.jm.prefill(jparams, J.jnp.asarray(toks), jcfg, 32, impl=impl)
    tlogits, tstate = tm.prefill(tparams, torch.from_numpy(toks).long(), tcfg, 32, impl=impl)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=ATOL_MODEL, rtol=1e-4)
    for i, layer in enumerate(tstate["cache"]):
        for key in ("k", "v"):
            np.testing.assert_allclose(layer[key].numpy(),
                                       np.asarray(jstate["cache"]["sub0"][key][i]),
                                       atol=ATOL_MODEL, rtol=1e-4)
    jl, jaux = J.jm.forward(jparams, J.jnp.asarray(toks), jcfg)
    tl, taux = tm.forward(tparams, torch.from_numpy(toks).long(), tcfg)
    assert float(jaux) > 0.0
    assert float(taux) == pytest.approx(float(jaux), rel=1e-5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL_MODEL, rtol=1e-4)


def test_prefill_matches_stepwise_decode(J):
    """Twin of tests/test_models.py::test_prefill_matches_stepwise_decode
    for granite-moe inside the port (capacity factor = n_experts: no
    drops, as the reference's test sets it)."""
    _, cfg = _cfgs(J, capacity_factor=8.0)
    params = tm.init_params(cfg, 1, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(1, cfg.vocab_size, (2, 10))).long()
    logits_pf, state_pf = tm.prefill(params, toks, cfg, 32, impl="pallas")
    state = tm.init_decode_state(cfg, 2, 32, device="cpu")
    for t in range(10):
        logits_dec, state = tm.decode_step(params, state, toks[:, t], cfg)
    np.testing.assert_allclose(logits_pf.numpy(), logits_dec.numpy(), atol=ATOL_MODEL, rtol=1e-4)
    for a, b in zip(state_pf["cache"], state["cache"]):
        for key in ("k", "v"):
            assert float((a[key] - b[key]).abs().max()) < ATOL_MODEL


def test_train_step_matches_reference(J):
    """One train step of reduced granite-moe in both packages on the same
    params: the loss (with the aux loss), grad norm and updated params.
    The params are held to a tenth of the step's size (lr 1e-3): AdamW's
    first step is about lr * g / |g| per element, so an expert weight that
    few tokens reach, whose gradient is tiny, turns summation-order noise
    in its gradient into a visible share of its step."""
    jcfg, tcfg = _cfgs(J)
    tc = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    jb, tb = J.ArchBundle(model=jcfg, train=J.TrainConfig(**tc)), ArchBundle(model=tcfg, train=TrainConfig(**tc))
    jst = J.jtl.train_state_init(J.jax.random.PRNGKey(3), jcfg, jb)
    tst = ttl.train_state_from_params(
        convert.from_jax_params(_np_tree(J, jst.params), tcfg, device="cpu"), tb)
    rng = np.random.default_rng(5)
    batch = {k: rng.integers(1, tcfg.vocab_size, (2, S)).astype(np.int32)
             for k in ("tokens", "labels")}
    _, aux = J.jm.forward(jst.params, J.jnp.asarray(batch["tokens"]), jcfg)
    assert float(aux) > 1e-3          # the aux loss is a visible part of the loss
    jst, jmet = J.jax.jit(J.jtl.make_train_step(jcfg, jb))(
        jst, {k: J.jnp.asarray(v) for k, v in batch.items()})
    tst, tmet = ttl.make_train_step(tcfg, tb)(tst, {k: torch.from_numpy(v)
                                                    for k, v in batch.items()})
    for key in ("loss", "grad_norm"):
        assert float(tmet[key]) == pytest.approx(float(jmet[key]), rel=1e-4), key
    got = dict(J.jax.tree_util.tree_leaves_with_path(convert.to_jax_layout(tst.params, tcfg)))
    for path, want in J.jax.tree_util.tree_leaves_with_path(_np_tree(J, jst.params)):
        np.testing.assert_allclose(got[path], want, atol=1e-4, err_msg=J.jax.tree_util.keystr(path))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["no-drops", "skewed-hard", "top3-drops"])
def test_combine_is_the_references_scatter_add(J, case, dtype):
    """The combine equals, bit for bit, the reference's per-row
    ``out.at[tok_s].add(g)`` over the same sorted pairs, which applies its
    updates in order and rounds each add to bf16 (the CPU's ``index_add_``
    accumulates bf16 in fp32 instead), without and with drops and with
    skewed capacities."""
    cfg = MoEConfig(**CASES[case])
    gen = torch.Generator().manual_seed(3)
    b, s = 3, 40
    tdt = getattr(torch, dtype)
    x = torch.randn(b, s, D, generator=gen).to(tdt)
    gates = torch.softmax(torch.randn(b, s, cfg.n_experts, generator=gen), dim=-1)
    top_w, top_i, _ = tmoe._top_k(gates, cfg.top_k)
    caps_np = tmoe.expert_capacities(cfg, s)
    caps = torch.as_tensor(caps_np, dtype=torch.int64)
    buf, slot, keep, tok_s, w_s = tmoe._dispatch(x, top_w, top_i, caps, int(caps_np.max()))
    assert bool(keep.all()) == (case == "no-drops")
    out_buf = torch.randn(buf.shape, generator=gen).to(tdt)
    got = tmoe._combine(out_buf, slot, keep, tok_s, w_s, s)
    n = slot.shape[1]
    flat = torch.cat([out_buf.reshape(b, -1, D), out_buf.new_zeros((b, 1, D))], 1)
    g = torch.gather(flat, 1, slot[..., None].expand(b, n, D)) * \
        (w_s * keep)[..., None].to(tdt)
    jnp = J.jnp
    jdt = getattr(jnp, dtype)
    gj = jnp.asarray(g.float().numpy()).astype(jdt)
    want = J.jax.vmap(lambda o, t, u: o.at[t].add(u))(
        jnp.zeros((b, s, D), jdt), jnp.asarray(tok_s.numpy()), gj)
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


@pytest.mark.gpu
def test_moe_combine_is_the_same_on_every_run_on_card():
    """bf16 at granite-moe-1b-a400m's width, 32 experts top-8: two calls of
    ``moe_apply`` on the card give the same bits, and the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = MoEConfig(n_experts=32, top_k=8, capacity_factor=1.25)
    gen = torch.Generator().manual_seed(4)
    p = tmoe.moe_init(gen, 1024, 512, cfg, True, dtype=torch.bfloat16)
    x = (torch.randn(4, 256, 1024, generator=gen) * 0.5).to(torch.bfloat16)
    pc, xc = {k: v.cuda() for k, v in p.items()}, x.cuda()
    first, second = tmoe.moe_apply(pc, xc, cfg)[0], tmoe.moe_apply(pc, xc, cfg)[0]
    assert torch.equal(first, second)
    buf, slot, keep, tok_s, w_s = (t.cpu() for t in tmoe._dispatch(
        xc, *tmoe.route(pc, xc, cfg)[:2], torch.as_tensor(
            tmoe.expert_capacities(cfg, 256), device="cuda"),
        int(tmoe.expert_capacities(cfg, 256).max())))
    out_buf = torch.randn(buf.shape, generator=gen).to(torch.bfloat16)
    assert torch.equal(tmoe._combine(out_buf.cuda(), slot.cuda(), keep.cuda(), tok_s.cuda(),
                                     w_s.cuda(), 256).cpu(),
                       tmoe._combine(out_buf, slot, keep, tok_s, w_s, 256))


@pytest.mark.gpu
def test_moe_dispatch_on_card():
    """The sort dispatch on the card (searchsorted, scatter, gather and the
    ordered combine on CUDA tensors) against the same call on the CPU and
    the dense oracle, with drops and with skewed capacities, in fp32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator().manual_seed(0)
    for case in ("drops", "skewed-hard", "top3-drops"):
        cfg = MoEConfig(**CASES[case])
        p = tmoe.moe_init(gen, D, F, cfg, True, dtype=torch.float32)
        x = torch.from_numpy(_x(5))
        want, want_aux = tmoe.moe_apply(p, x, cfg)
        got, aux = tmoe.moe_apply({k: v.cuda() for k, v in p.items()}, x.cuda(), cfg)
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=TOL, rtol=TOL)
        assert float(aux) == pytest.approx(float(want_aux), rel=1e-5)
    roomy = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    pc, xc = {k: v.cuda() for k, v in p.items()}, x.cuda()
    np.testing.assert_allclose(tmoe.moe_apply(pc, xc, roomy)[0].cpu().numpy(),
                               tmoe.moe_apply_dense_fallback(pc, xc, roomy)[0].cpu().numpy(),
                               atol=1e-4)
