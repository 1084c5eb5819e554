"""Port model against the JAX package's model on reduced granite-3-8b.

The port gets the reference's weights through ``repro_torch.convert``, so
logits compare number by number (fp32; the tolerance covers summation
order only).
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
from repro_torch.configs import ARCH_IDS, SSMConfig, get_config, get_reduced
from repro_torch.models import model as tm
from repro_torch.models import transformer

torch.set_num_threads(2)

ARCH = "granite-3-8b"
ATOL = 1e-4
B, S, MAX_LEN = 2, 10, 32


def _cfgs(dtype="float32"):
    return (dataclasses.replace(j_get_reduced(ARCH), dtype=dtype),
            dataclasses.replace(get_reduced(ARCH), dtype=dtype))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = _cfgs()
    jparams = jm.init_params(jax.random.PRNGKey(1), jcfg)
    tparams = convert.from_jax_params(_np_tree(jparams), tcfg, device="cpu")
    toks = np.random.default_rng(2).integers(1, jcfg.vocab_size, (B, S)).astype(np.int32)
    return jcfg, tcfg, jparams, tparams, toks


def _jax_cache_layer(jcache, i, period=1):
    sub = jcache[f"sub{i % period}"]
    return {k: np.asarray(v[i // period]) for k, v in sub.items()}


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want),
                               atol=atol, rtol=1e-4)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_prefill_matches_jax(pair, impl):
    jcfg, tcfg, jparams, tparams, toks = pair
    jlogits, jstate = jm.prefill(jparams, jnp.asarray(toks), jcfg, MAX_LEN, impl=impl)
    tlogits, tstate = tm.prefill(tparams, torch.from_numpy(toks).long(), tcfg,
                                 MAX_LEN, impl=impl)
    _close(tlogits, jlogits)
    assert tstate["length"] == int(jstate["length"]) == S
    for i, layer in enumerate(tstate["cache"]):
        want = _jax_cache_layer(jstate["cache"], i)
        for key in ("k", "v"):
            _close(layer[key], want[key])


def test_decode_steps_match_jax(pair):
    jcfg, tcfg, jparams, tparams, toks = pair
    jstate = jm.init_decode_state(jcfg, B, MAX_LEN)
    tstate = tm.init_decode_state(tcfg, B, MAX_LEN, device="cpu")
    for t in range(S):
        jlogits, jstate = jm.decode_step(jparams, jstate, jnp.asarray(toks[:, t]), jcfg)
        tlogits, tstate = tm.decode_step(tparams, tstate, torch.from_numpy(toks[:, t]).long(),
                                         tcfg)
        _close(tlogits, jlogits)
    assert tstate["length"] == S


@pytest.mark.parametrize("impl", ["xla", "chunked", "pallas"])
def test_forward_matches_jax(pair, impl):
    jcfg, tcfg, jparams, tparams, toks = pair
    jlogits, _ = jm.forward(jparams, jnp.asarray(toks), jcfg, impl=impl)
    tlogits, aux = tm.forward(tparams, torch.from_numpy(toks).long(), tcfg, impl=impl)
    assert float(aux) == 0.0
    _close(tlogits, jlogits)


def test_pad_logits_masked(pair):
    jcfg, tcfg, _, tparams, toks = pair
    cfg = dataclasses.replace(tcfg, vocab_size=250)        # pads 250 -> 256
    logits, _ = tm.prefill(tparams, torch.from_numpy(toks).long(), cfg, MAX_LEN)
    assert bool((logits[:, 250:] == -1e30).all())
    assert bool(torch.isfinite(logits[:, :250]).all())


def test_prefill_matches_stepwise_decode():
    """Twin of tests/test_models.py::test_prefill_matches_stepwise_decode
    inside the port: prefill's logits and ring cache equal ten decode
    steps from an empty cache."""
    _, cfg = _cfgs()
    params = tm.init_params(cfg, 1, device="cpu")
    toks = torch.from_numpy(
        np.random.default_rng(3).integers(1, cfg.vocab_size, (B, S))).long()
    logits_pf, state_pf = tm.prefill(params, toks, cfg, MAX_LEN, impl="pallas")
    state = tm.init_decode_state(cfg, B, MAX_LEN, device="cpu")
    for t in range(S):
        logits_dec, state = tm.decode_step(params, state, toks[:, t], cfg)
    _close(logits_pf, logits_dec.numpy(), atol=5e-4)
    for a, b in zip(state_pf["cache"], state["cache"]):
        for key in ("k", "v"):
            assert float((a[key] - b[key]).abs().max()) < 5e-4


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_stack_prefill_hidden_states_equal_stack_apply(arch, impl):
    """The stack's full pass and its prefill run one layer body around the
    same mixer math, so on the same input they give the same hidden states
    and MoE aux loss bit for bit, on every reduced arch (whisper's decoder
    over an encoder output), on the dense path and on the kernels' (their
    plain versions on the CPU)."""
    cfg = get_reduced(arch)
    params = tm.init_params(cfg, 1, device="cpu")
    gen = torch.Generator().manual_seed(4)
    x = torch.randn((B, S, cfg.d_model), generator=gen).to(tm._dtype(cfg))
    pos = torch.arange(S)[None].expand(B, S)
    enc_out = None
    if cfg.encoder_layers > 0:
        enc_out = torch.randn((B, 6, cfg.d_model), generator=gen).to(x.dtype)
    with torch.no_grad():
        want, want_aux = transformer.stack_apply(params["stack"], x, cfg, pos,
                                                 enc_out=enc_out, impl=impl)
        got, cache, aux = transformer.stack_prefill(params["stack"], x, cfg, pos, MAX_LEN,
                                                    enc_out=enc_out, impl=impl)
    assert torch.equal(got, want)
    assert torch.equal(aux, want_aux)
    assert len(cache) == cfg.n_layers


def test_converter_round_trip_bf16_bits_exact():
    jcfg, tcfg = _cfgs("bfloat16")
    jcfg = dataclasses.replace(jcfg, n_layers=4)
    tcfg = dataclasses.replace(tcfg, n_layers=4)
    jtree = _np_tree(jm.init_params(jax.random.PRNGKey(5), jcfg))
    for tree in (jtree, jax.tree.map(
            lambda a: a.view(np.uint16) if a.dtype.name == "bfloat16" else a, jtree)):
        model = convert.from_jax_params(tree, tcfg, device="cpu")
        assert model["stack"][3]["mixer"]["wq"].dtype == torch.bfloat16
        assert model["final_norm"]["scale"].dtype == torch.float32
        back = convert.to_jax_layout(model, tcfg)
        flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
        flat_want = dict(jax.tree_util.tree_leaves_with_path(jtree))
        assert flat_back.keys() == flat_want.keys()
        for path, want in flat_want.items():
            got = flat_back[path]
            if want.dtype.name == "bfloat16":
                np.testing.assert_array_equal(got, want.view(np.uint16))
            else:
                np.testing.assert_array_equal(got, want)


def test_init_params_tree_matches_reference_shapes():
    jcfg, tcfg = _cfgs("bfloat16")
    jshapes = jax.eval_shape(lambda: jm.init_params(jax.random.PRNGKey(0), jcfg))
    tree = convert.to_jax_layout(tm.init_params(tcfg, 0, device="cpu"), tcfg)
    want = {jax.tree_util.keystr(p): (tuple(a.shape), str(a.dtype))
            for p, a in jax.tree_util.tree_leaves_with_path(jshapes)}
    got = {jax.tree_util.keystr(p): (tuple(a.shape),
                                     "bfloat16" if a.dtype == np.uint16 else str(a.dtype))
           for p, a in jax.tree_util.tree_leaves_with_path(tree)}
    assert got == want


def test_registry_serves_granite_only():
    """The registry serves the reference's archs (granite-3-8b and
    mamba2-2.7b among them) with the reference's published sizes, and
    raises the reference's KeyError for an unknown id. (The name is kept
    from when granite was the only ported arch.)"""
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size) == (40, 4096, 12800, 49155)
    ssm = get_config("mamba2-2.7b")
    assert (ssm.n_layers, ssm.d_model, ssm.d_ff, ssm.vocab_size) == (64, 2560, 0, 50280)
    assert (ssm.attention, ssm.ssm.state_dim, ssm.ssm.head_dim, ssm.ssm.chunk) == \
        (None, 128, 64, 256)
    with pytest.raises(KeyError, match="unknown arch 'llama-0b'; known: "):
        get_config("llama-0b")


def test_cuda_entry_points_raise_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    _, cfg = _cfgs()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tm.init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tm.init_decode_state(cfg, 1, 8)


# ids kept from the parametrization's first form; its "change1",
# {"encoder_layers": 2}, is ported now and held against the reference by
# tests/test_torch_encdec.py::test_granite_over_an_encoder_matches_jax
@pytest.mark.parametrize("change", [
    pytest.param({"attention": dataclasses.replace(get_reduced(ARCH).attention,
                                                   sliding_window=4, local_global=(5, 1))},
                 id="change0"),
    pytest.param({"attn_period": 2}, id="change2"),
    pytest.param({"ssm": SSMConfig(state_dim=16, head_dim=16, chunk=16)},  # attention + SSM
                 id="change3"),
])
def test_unported_architecture_parts_raise(change):
    cfg = dataclasses.replace(get_reduced(ARCH), **change)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        tm.init_params(cfg, 0, device="cpu")
