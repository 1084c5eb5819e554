"""jamba-1.5-large-398b's hybrid stack in the port against the JAX package:
one attention layer (index 4) in every 8, Mamba2 layers between, an MoE
FFN in every second layer (1, 3, 5, 7), no positional encoding.

On the reduced config (8 layers = one group) in fp32 with the reference's
weights (``repro_torch.convert``): forward and loss on ``xla``,
``chunked`` and ``pallas`` (the JAX side in interpret mode, the port's
kernel wrappers on their plain versions on the CPU), prefill and 4
decode steps with every layer's cache (layer ``i`` is the reference's
``sub{i % 8}[i // 8]``: k/v for the attention layer, conv/state for the
Mamba layers), prefill against stepwise decode, the refusals that stay,
and one train step of jamba and of dbrx-132b. ATOL 1e-4 (rel 1e-4) in
fp32 unless stated: summation order only. The JAX package is imported in
fixtures, so the ``gpu`` test runs on a machine without JAX.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import (ArchBundle, TrainConfig, get_config, get_reduced,
                                 param_count)
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.models import model as tm
from repro_torch.runtime import train_loop as ttl

torch.set_num_threads(2)

ARCH = "jamba-1.5-large-398b"
ATOL = 1e-4
ATOL_STEPWISE = 5e-4   # tests/test_models.py::test_prefill_matches_stepwise_decode
B, S, MAX_LEN = 2, 12, 32


@pytest.fixture(scope="module")
def J():
    import jax
    import jax.numpy as jnp

    from repro.configs import get_reduced as j_get_reduced
    from repro.configs.base import ArchBundle as JBundle
    from repro.configs.base import TrainConfig as JTrain
    from repro.models import model as jm
    from repro.runtime import train_loop as jtl
    return SimpleNamespace(jax=jax, jnp=jnp, get_reduced=j_get_reduced, ArchBundle=JBundle,
                           TrainConfig=JTrain, jm=jm, jtl=jtl)


def _np_tree(J, tree):
    return J.jax.tree.map(np.asarray, tree)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=atol, rtol=1e-4)


@pytest.fixture(scope="module")
def pair(J):
    jcfg = dataclasses.replace(J.get_reduced(ARCH), dtype="float32")
    tcfg = dataclasses.replace(get_reduced(ARCH), dtype="float32")
    jparams = J.jm.init_params(J.jax.random.PRNGKey(1), jcfg)
    tparams = convert.from_jax_params(_np_tree(J, jparams), tcfg, device="cpu")
    toks = np.random.default_rng(2).integers(1, jcfg.vocab_size, (B, S)).astype(np.int32)
    return jcfg, tcfg, jparams, tparams, toks


def _jax_cache_layer(jcache, i, period):
    return {k: np.asarray(v[i // period]) for k, v in jcache[f"sub{i % period}"].items()}


def test_layer_kinds_and_card_cut():
    """The published layout: attention at index 4 of each 8, MoE at the odd
    layers. The card's cut (one group, 8 of 16 experts) keeps every width
    and layer kind: 25.82 B parameters; dbrx-132b at 8 of 40 layers 27.31 B."""
    full = get_config(ARCH)
    assert (full.n_layers, full.d_model, full.d_ff, full.vocab_size) == (72, 8192, 24576, 65536)
    assert (full.attention.n_heads, full.attention.n_kv_heads, full.attention.head_dim,
            full.attention.rope_style) == (64, 8, 128, "none")
    assert (full.ssm.state_dim, full.ssm.head_dim, full.ssm.expand) == (128, 64, 2)
    assert full.layer_period == 8
    assert [full.layer_kind(i) for i in range(8)] == ["ssm"] * 4 + ["attn"] + ["ssm"] * 3
    assert [i for i in range(8) if full.layer_is_moe(i)] == [1, 3, 5, 7]
    cut = dataclasses.replace(full, n_layers=8,
                              moe=dataclasses.replace(full.moe, n_experts=8))
    assert round(param_count(cut) / 1e9, 2) == 25.82
    dbrx = get_config("dbrx-132b")
    assert (dbrx.n_layers, dbrx.d_model, dbrx.attention.n_heads, dbrx.attention.n_kv_heads,
            dbrx.moe.n_experts, dbrx.moe.top_k, dbrx.d_ff) == (40, 6144, 48, 8, 16, 4, 10752)
    assert round(param_count(dataclasses.replace(dbrx, n_layers=8)) / 1e9, 2) == 27.31


@pytest.mark.parametrize("impl", ["xla", "chunked", "pallas"])
def test_forward_and_loss_match_jax(J, pair, impl):
    jcfg, tcfg, jparams, tparams, toks = pair
    before = (fa.launches, ssd.launches)
    jlogits, jaux = J.jm.forward(jparams, J.jnp.asarray(toks), jcfg, impl=impl)
    tlogits, taux = tm.forward(tparams, torch.from_numpy(toks).long(), tcfg, impl=impl)
    assert (fa.launches, ssd.launches) == before      # CPU tensors take the plain versions
    _close(tlogits, jlogits)
    assert float(jaux) > 0.0
    assert float(taux) == pytest.approx(float(jaux), rel=1e-5)
    labels = np.roll(toks, -1, axis=1)
    jloss = J.jm.loss_fn(jparams, {"tokens": J.jnp.asarray(toks),
                                   "labels": J.jnp.asarray(labels)}, jcfg, impl=impl)
    tloss = tm.loss_fn(tparams, {"tokens": torch.from_numpy(toks).long(),
                                 "labels": torch.from_numpy(labels).long()}, tcfg, impl=impl)
    assert float(tloss) == pytest.approx(float(jloss), rel=1e-5)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_prefill_and_decode_match_jax(J, pair, impl):
    """Prefill's logits and every layer's cache, then 4 greedy decode
    steps: the logits at each, and the caches after the last."""
    jcfg, tcfg, jparams, tparams, toks = pair
    period = tcfg.layer_period
    jlogits, jstate = J.jm.prefill(jparams, J.jnp.asarray(toks), jcfg, MAX_LEN, impl=impl)
    tlogits, tstate = tm.prefill(tparams, torch.from_numpy(toks).long(), tcfg, MAX_LEN,
                                 impl=impl)
    _close(tlogits, jlogits)

    def check_caches():
        for i, layer in enumerate(tstate["cache"]):
            want = _jax_cache_layer(jstate["cache"], i, period)
            keys = {"k", "v"} if tcfg.layer_kind(i) == "attn" else {"conv", "state"}
            assert layer.keys() == want.keys() == keys, i
            for key in keys:
                _close(layer[key], want[key])

    check_caches()
    tok = np.array(J.jnp.argmax(jlogits, -1), np.int32)
    for _ in range(4):
        jlogits, jstate = J.jm.decode_step(jparams, jstate, J.jnp.asarray(tok), jcfg)
        tlogits, tstate = tm.decode_step(tparams, tstate, torch.from_numpy(tok).long(), tcfg)
        _close(tlogits, jlogits)
        tok = np.array(J.jnp.argmax(jlogits, -1), np.int32)
    assert tstate["length"] == int(jstate["length"]) == S + 4
    check_caches()


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_prefill_matches_stepwise_decode(impl):
    """Twin of tests/test_models.py::test_prefill_matches_stepwise_decode
    for the hybrid stack inside the port (capacity factor = n_experts: no
    drops, as the reference's test sets it): prefill's logits and every
    cache equal S decode steps from an empty cache."""
    cfg = get_reduced(ARCH)
    cfg = dataclasses.replace(cfg, dtype="float32", moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.n_experts)))
    params = tm.init_params(cfg, 1, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(1, cfg.vocab_size, (B, 10))).long()
    logits_pf, state_pf = tm.prefill(params, toks, cfg, MAX_LEN, impl=impl)
    state = tm.init_decode_state(cfg, B, MAX_LEN, device="cpu")
    for t in range(10):
        logits_dec, state = tm.decode_step(params, state, toks[:, t], cfg)
    _close(logits_pf, logits_dec.numpy(), atol=ATOL_STEPWISE)
    for i, (a, b) in enumerate(zip(state_pf["cache"], state["cache"])):
        assert a.keys() == b.keys()
        for key in a:
            assert float((a[key].float() - b[key].float()).abs().max()) < ATOL_STEPWISE, (i, key)


@pytest.mark.parametrize("change, why", [
    ({"ssm": None}, "needs both"),                      # an SSM layer kind, no SSM config
    ({"attention": None}, "needs both"),                # an attention period, no attention
    ({"attn_period": 0}, "attn_period 0"),              # SSM beside attention, no period
    ({"n_layers": 12}, "not whole groups"),             # one group and a half
])
def test_hybrid_refusals_stay(change, why):
    cfg = dataclasses.replace(get_reduced(ARCH), **change)
    with pytest.raises(NotImplementedError, match=why):
        tm.init_params(cfg, 0, device="cpu")


@pytest.mark.parametrize("arch", [ARCH, "dbrx-132b"])
def test_train_step_matches_reference(J, arch):
    """One train step in both packages on the same params: the loss (with
    the aux loss) and grad norm at rel 1e-4, the updated params at 1e-4, a
    tenth of the step's size (lr 1e-3): AdamW's first step is about
    lr * g / |g| per element, so an expert weight that few tokens reach,
    whose gradient is tiny, turns summation-order noise in its gradient
    into a visible share of its step (as tests/test_torch_moe.py holds
    granite-moe)."""
    jcfg = dataclasses.replace(J.get_reduced(arch), dtype="float32")
    tcfg = dataclasses.replace(get_reduced(arch), dtype="float32")
    tc = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    jb = J.ArchBundle(model=jcfg, train=J.TrainConfig(**tc))
    tb = ArchBundle(model=tcfg, train=TrainConfig(**tc))
    jst = J.jtl.train_state_init(J.jax.random.PRNGKey(3), jcfg, jb)
    tst = ttl.train_state_from_params(
        convert.from_jax_params(_np_tree(J, jst.params), tcfg, device="cpu"), tb)
    rng = np.random.default_rng(5)
    batch = {k: rng.integers(1, tcfg.vocab_size, (B, S)).astype(np.int32)
             for k in ("tokens", "labels")}
    jst, jmet = J.jax.jit(J.jtl.make_train_step(jcfg, jb))(
        jst, {k: J.jnp.asarray(v) for k, v in batch.items()})
    tst, tmet = ttl.make_train_step(tcfg, tb)(tst, {k: torch.from_numpy(v)
                                                    for k, v in batch.items()})
    for key in ("loss", "grad_norm"):
        assert float(tmet[key]) == pytest.approx(float(jmet[key]), rel=1e-4), key
    got = dict(J.jax.tree_util.tree_leaves_with_path(convert.to_jax_layout(tst.params, tcfg)))
    want = J.jax.tree_util.tree_leaves_with_path(_np_tree(J, jst.params))
    assert len(got) == len(want)
    for path, w in want:
        np.testing.assert_allclose(got[path], w, atol=1e-4, err_msg=J.jax.tree_util.keystr(path))


def test_converter_round_trip_is_bit_exact(J):
    """bf16 weights through ``from_jax_params`` and back: the same tree,
    bit for bit, period 8 with the mixed attention and Mamba ``sub{j}``
    leaves."""
    jcfg, tcfg = J.get_reduced(ARCH), get_reduced(ARCH)
    tree = _np_tree(J, J.jm.init_params(J.jax.random.PRNGKey(4), jcfg))
    back = convert.to_jax_layout(convert.from_jax_params(tree, tcfg, device="cpu"), tcfg)
    want = J.jax.tree_util.tree_leaves_with_path(tree)
    got = dict(J.jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    assert {p[1].key for p, _ in want if p[0].key == "stack"} == {f"sub{j}" for j in range(8)}
    for path, w in want:
        g = got[path]
        if w.dtype.name == "bfloat16":
            w = w.view(np.uint16)
        assert g.dtype == w.dtype and np.array_equal(g, w), J.jax.tree_util.keystr(path)


@pytest.mark.gpu
def test_hybrid_serves_on_card_through_both_kernels():
    """A narrow jamba (every kernel dimension at the real model's: attention
    heads of 128 without rope, SSM heads of 64 and state 128) served on the
    card in bf16: each prefill launches flash once (the attention layer)
    and the SSD scan seven times (the Mamba layers), all on the wgmma
    routes; decode finishes with finite logits; and in fp32 (the CUDA-core
    routes) pallas against xla prefill logits within 1e-3 rel L2."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.runtime.serve_loop import make_prefill_step, make_serve_step
    base = get_reduced(ARCH)
    cfg = dataclasses.replace(
        base, d_model=512, d_ff=256,
        attention=dataclasses.replace(base.attention, n_heads=4, n_kv_heads=2, head_dim=128),
        ssm=dataclasses.replace(base.ssm, state_dim=128, head_dim=64, chunk=64))
    params = tm.init_params(cfg, 0)
    toks = torch.randint(1, cfg.vocab_size, (3, 200),
                         generator=torch.Generator(device="cuda").manual_seed(0), device="cuda")
    before = (dict(fa.launches_by_route), dict(ssd.launches_by_route))
    tok, state = make_prefill_step(cfg, 208, impl="pallas")(params, toks)
    fa_by, ssd_by = dict(fa.launches_by_route), dict(ssd.launches_by_route)
    assert fa_by["wgmma"] - before[0]["wgmma"] == 1 and fa_by["simt"] == before[0]["simt"]
    assert ssd_by["wgmma"] - before[1]["wgmma"] == 7 and ssd_by["simt"] == before[1]["simt"]
    serve_step = make_serve_step(cfg)
    for _ in range(8):
        tok, logits, state = serve_step(params, state, tok)
        assert bool(torch.isfinite(logits).all())
    assert state["length"] == 208
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = tm.init_params(cfg32, 0)
    with torch.no_grad():
        lp, _ = tm.prefill(p32, toks, cfg32, 208, impl="pallas")
        lx, _ = tm.prefill(p32, toks, cfg32, 208, impl="xla")
    assert float((lp - lx).norm() / lx.norm()) < 1e-3


@pytest.mark.parametrize("arch", [ARCH, "dbrx-132b"])
def test_serve_demo_serves_the_reduced_config(monkeypatch, capsys, arch):
    """``python -m repro_torch.launch.serve --device cpu --arch <id>``."""
    import json
    import sys

    from repro_torch.launch import serve as tserve
    monkeypatch.setattr(sys, "argv", ["serve", "--device", "cpu", "--arch", arch,
                                      "--rounds", "2", "--gen-len", "3"])
    tserve.main()
    rounds = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["round"] for r in rounds] == [0, 1]
    assert rounds[1]["shares"] == {"rep0": 10, "rep1": 10, "rep2": 4}
