"""gemma3's 5:1 local:global attention in the port against the JAX package
on reduced gemma3-12b (6 layers: 5 local layers with a 16-token window,
then 1 global layer).

The port gets the reference's weights through ``repro_torch.convert``.
Prompts of 40 tokens are longer than the window, with ``max_len`` 48, so
the local layers' 16-slot rings wrap in prefill and again in decode.
float32 configs, at tests/test_models.py's prefill tolerance (5e-4).
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import ArchBundle, TrainConfig, get_config, get_reduced
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import model as tm
from repro_torch.runtime import train_loop as ttl

torch.set_num_threads(2)

ARCH = "gemma3-12b"
ATOL = 5e-4            # tests/test_models.py::test_prefill_matches_stepwise_decode
B, MAX_LEN = 2, 48
PERIOD = 6
LENGTHS = (10, 40)     # within the window, and past it: the rings wrap


@pytest.fixture(scope="module")
def J():
    """The JAX package, imported here and not at the top, so that the
    ``gpu`` test runs on a machine without JAX."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_reduced as j_get_reduced
    from repro.configs.base import ArchBundle as JBundle, TrainConfig as JTrain
    from repro.models import model as jm
    from repro.models import transformer as jt
    from repro.runtime import train_loop as jtl
    return SimpleNamespace(jax=jax, jnp=jnp, get_reduced=j_get_reduced, ArchBundle=JBundle,
                           TrainConfig=JTrain, jm=jm, jt=jt, jtl=jtl)


def _np_tree(J, tree):
    return J.jax.tree.map(np.asarray, tree)


def _cfgs(J, dtype="float32", **kw):
    return (dataclasses.replace(J.get_reduced(ARCH), dtype=dtype, **kw),
            dataclasses.replace(get_reduced(ARCH), dtype=dtype, **kw))


@pytest.fixture(scope="module")
def pair(J):
    jcfg, tcfg = _cfgs(J)
    jparams = J.jm.init_params(J.jax.random.PRNGKey(1), jcfg)
    tparams = convert.from_jax_params(_np_tree(J, jparams), tcfg, device="cpu")
    toks = np.random.default_rng(2).integers(1, jcfg.vocab_size,
                                             (B, max(LENGTHS) + 4)).astype(np.int32)
    return jcfg, tcfg, jparams, tparams, toks


def _jax_cache_layer(jcache, i):
    sub = jcache[f"sub{i % PERIOD}"]
    return {k: np.asarray(v[i // PERIOD]) for k, v in sub.items()}


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want),
                               atol=atol, rtol=1e-4)


def test_layer_pattern_and_cache_lengths(J):
    """Five local layers then one global; a local layer's ring holds the
    window, a global one ``max_len``, as the reference allocates them."""
    jcfg, tcfg = _cfgs(J)
    assert [tcfg.layer_is_global_attn(i) for i in range(tcfg.n_layers)] == [False] * 5 + [True]
    assert tcfg.layer_period == PERIOD
    full = get_config(ARCH)
    assert (full.n_layers, full.layer_period, full.attention.head_dim,
            full.attention.sliding_window) == (48, 6, 256, 1024)
    assert sum(full.layer_is_global_attn(i) for i in range(full.n_layers)) == 8
    state = tm.init_decode_state(tcfg, B, MAX_LEN, device="cpu")
    jcache = J.jt.stack_init_cache(jcfg, B, MAX_LEN, dtype=J.jnp.float32)
    got = [tuple(c["k"].shape) for c in state["cache"]]
    want = [_jax_cache_layer(jcache, i)["k"].shape for i in range(tcfg.n_layers)]
    assert got == want == [(B, 16, 2, 16)] * 5 + [(B, MAX_LEN, 2, 16)]


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("s", LENGTHS)
def test_prefill_matches_jax(J, pair, s, impl):
    """Logits and every layer's ring cache. ``impl="pallas"`` runs the
    flash kernel's plain version with each layer's window here, and the
    reference's Pallas kernel in interpret mode."""
    jcfg, tcfg, jparams, tparams, toks = pair
    jlogits, jstate = J.jm.prefill(jparams, J.jnp.asarray(toks[:, :s]), jcfg, MAX_LEN, impl=impl)
    tlogits, tstate = tm.prefill(tparams, torch.from_numpy(toks[:, :s]).long(), tcfg,
                                 MAX_LEN, impl=impl)
    _close(tlogits, jlogits)
    assert tstate["length"] == int(jstate["length"]) == s
    for i, layer in enumerate(tstate["cache"]):
        want = _jax_cache_layer(jstate["cache"], i)
        for key in ("k", "v"):
            assert layer[key].shape == want[key].shape
            _close(layer[key], want[key])


def test_decode_after_long_prefill_matches_jax(J, pair):
    """Prefill 40 tokens (rings wrapped), then decode 4 more in both
    packages: every step's logits and the final caches agree."""
    jcfg, tcfg, jparams, tparams, toks = pair
    s = max(LENGTHS)
    _, jstate = J.jm.prefill(jparams, J.jnp.asarray(toks[:, :s]), jcfg, MAX_LEN)
    _, tstate = tm.prefill(tparams, torch.from_numpy(toks[:, :s]).long(), tcfg, MAX_LEN)
    jstep = J.jax.jit(J.jm.decode_step, static_argnums=3)
    for t in range(s, toks.shape[1]):
        jlogits, jstate = jstep(jparams, jstate, J.jnp.asarray(toks[:, t]), jcfg)
        tlogits, tstate = tm.decode_step(tparams, tstate, torch.from_numpy(toks[:, t]).long(),
                                         tcfg)
        _close(tlogits, jlogits)
    for i, layer in enumerate(tstate["cache"]):
        want = _jax_cache_layer(jstate["cache"], i)
        for key in ("k", "v"):
            _close(layer[key], want[key])


def test_prefill_matches_stepwise_decode_past_the_window(J):
    """Twin of tests/test_models.py::test_prefill_matches_stepwise_decode
    for gemma3 inside the port, at 40 tokens against the window of 16:
    prefill's logits and rings equal 40 decode steps from empty caches."""
    _, cfg = _cfgs(J)
    params = tm.init_params(cfg, 1, device="cpu")
    s = max(LENGTHS)
    toks = torch.from_numpy(np.random.default_rng(3).integers(1, cfg.vocab_size, (B, s))).long()
    logits_pf, state_pf = tm.prefill(params, toks, cfg, MAX_LEN, impl="pallas")
    state = tm.init_decode_state(cfg, B, MAX_LEN, device="cpu")
    for t in range(s):
        logits_dec, state = tm.decode_step(params, state, toks[:, t], cfg)
    _close(logits_pf, logits_dec.numpy())
    for a, b in zip(state_pf["cache"], state["cache"]):
        for key in ("k", "v"):
            assert float((a[key] - b[key]).abs().max()) < ATOL


def test_window_changes_the_local_layers_only(J, pair):
    """Past the window the local layers see less than causal attention:
    widening their window to ``max_len`` changes the logits. Layer 0's K/V
    depend on the embeddings alone, so its 16-slot ring holds exactly the
    last 16 positions of the widened layer's position-addressed cache:
    slot i holds position 39 - ((39 - i) mod 16)."""
    _, tcfg, _, tparams, toks = pair
    s = max(LENGTHS)
    wide = dataclasses.replace(tcfg, attention=dataclasses.replace(
        tcfg.attention, sliding_window=MAX_LEN))
    tk = torch.from_numpy(toks[:, :s]).long()
    narrow_logits, narrow = tm.prefill(tparams, tk, tcfg, MAX_LEN)
    wide_logits, widened = tm.prefill(tparams, tk, wide, MAX_LEN)
    assert float((narrow_logits - wide_logits).abs().max()) > 1e-3
    ring, full = narrow["cache"][0], widened["cache"][0]
    assert ring["k"].shape[1] == 16 and full["k"].shape[1] == MAX_LEN
    pos = torch.tensor([(s - 1) - ((s - 1 - i) % 16) for i in range(16)])
    for key in ("k", "v"):
        torch.testing.assert_close(ring[key], full[key][:, pos], rtol=0, atol=0)


@pytest.mark.parametrize("n_layers", [6, 12])
def test_converter_round_trip_period_6_bf16_bits_exact(J, n_layers):
    """Six ``sub{j}`` leaves per group; with 12 layers layer i is entry
    i // 6 of ``sub{i % 6}``. bf16 leaves move bit for bit both ways."""
    jcfg, tcfg = _cfgs(J, "bfloat16", n_layers=n_layers)
    jtree = _np_tree(J, J.jm.init_params(J.jax.random.PRNGKey(5), jcfg))
    assert sorted(jtree["stack"]) == [f"sub{j}" for j in range(PERIOD)]
    model = convert.from_jax_params(jtree, tcfg, device="cpu")
    assert len(model["stack"]) == n_layers and model.layer_period == PERIOD
    for i in range(n_layers):
        want = jtree["stack"][f"sub{i % PERIOD}"]["mixer"]["wq"][i // PERIOD]
        np.testing.assert_array_equal(
            model["stack"][i]["mixer"]["wq"].view(torch.int16).numpy().view(np.uint16),
            want.view(np.uint16))
    back = convert.to_jax_layout(model, tcfg)
    flat_back = dict(J.jax.tree_util.tree_leaves_with_path(back))
    flat_want = dict(J.jax.tree_util.tree_leaves_with_path(jtree))
    assert flat_back.keys() == flat_want.keys()
    for path, want in flat_want.items():
        got = flat_back[path]
        np.testing.assert_array_equal(got, want.view(np.uint16)
                                      if want.dtype.name == "bfloat16" else want)


def test_init_params_tree_matches_reference_shapes(J):
    jcfg, tcfg = _cfgs(J, "bfloat16", n_layers=12)
    jshapes = J.jax.eval_shape(lambda: J.jm.init_params(J.jax.random.PRNGKey(0), jcfg))
    tree = convert.to_jax_layout(tm.init_params(tcfg, 0, device="cpu"), tcfg)
    want = {J.jax.tree_util.keystr(p): (tuple(a.shape), str(a.dtype))
            for p, a in J.jax.tree_util.tree_leaves_with_path(jshapes)}
    got = {J.jax.tree_util.keystr(p): (tuple(a.shape),
                                     "bfloat16" if a.dtype == np.uint16 else str(a.dtype))
           for p, a in J.jax.tree_util.tree_leaves_with_path(tree)}
    assert got == want


def test_train_step_matches_reference(J):
    """One train step of reduced gemma3 at 40 tokens (past the window) in
    both packages on the same params: loss, grad norm and updated params."""
    jcfg, tcfg = _cfgs(J)
    tc = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    jb, tb = J.ArchBundle(model=jcfg, train=J.TrainConfig(**tc)), ArchBundle(model=tcfg, train=TrainConfig(**tc))
    jst = J.jtl.train_state_init(J.jax.random.PRNGKey(3), jcfg, jb)
    tst = ttl.train_state_from_params(
        convert.from_jax_params(_np_tree(J, jst.params), tcfg, device="cpu"), tb)
    rng = np.random.default_rng(5)
    batch = {k: rng.integers(1, tcfg.vocab_size, (B, max(LENGTHS))).astype(np.int32)
             for k in ("tokens", "labels")}
    jst, jmet = J.jax.jit(J.jtl.make_train_step(jcfg, jb))(
        jst, {k: J.jnp.asarray(v) for k, v in batch.items()})
    tst, tmet = ttl.make_train_step(tcfg, tb)(tst, {k: torch.from_numpy(v)
                                                    for k, v in batch.items()})
    for key in ("loss", "grad_norm"):
        assert float(tmet[key]) == pytest.approx(float(jmet[key]), rel=1e-4), key
    got = dict(J.jax.tree_util.tree_leaves_with_path(convert.to_jax_layout(tst.params, tcfg)))
    for path, want in J.jax.tree_util.tree_leaves_with_path(_np_tree(J, jst.params)):
        np.testing.assert_allclose(got[path], want, atol=1e-5, err_msg=J.jax.tree_util.keystr(path))


@pytest.mark.gpu
def test_gemma3_windows_on_card():
    """Reduced gemma3 in fp32 on the card: a 40-token prefill runs the
    flash kernel once per layer (16-token windows on the local layers,
    none on the global one) and matches the plain version on the CPU, as
    do 4 decode steps past the wrapped rings."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = dataclasses.replace(get_reduced(ARCH), dtype="float32")
    cpu = tm.init_params(cfg, 1, device="cpu")
    card = tm.init_params(cfg, 1, device="cuda")
    card.load_state_dict(cpu.state_dict())
    s = max(LENGTHS)
    toks = torch.from_numpy(np.random.default_rng(4).integers(1, cfg.vocab_size, (B, s + 4))).long()
    before = fa.launches_by_route["simt"]
    want, state_cpu = tm.prefill(cpu, toks[:, :s], cfg, MAX_LEN, impl="pallas")
    got, state_card = tm.prefill(card, toks[:, :s].cuda(), cfg, MAX_LEN, impl="pallas")
    torch.cuda.synchronize()
    assert fa.launches_by_route["simt"] - before == cfg.n_layers
    _close(got.cpu(), want.numpy())
    for t in range(s, s + 4):
        want, state_cpu = tm.decode_step(cpu, state_cpu, toks[:, t], cfg)
        got, state_card = tm.decode_step(card, state_card, toks[:, t].cuda(), cfg)
        _close(got.cpu(), want.numpy())
