"""Port of the Mamba2 (SSD) path against the JAX package on reduced
mamba2-2.7b: the chunked xla scans, the block's apply / prefill / decode,
the model's logits, greedy serving, the converter through ``gate_norm``
and the serving demo.

The port gets the reference's weights through ``repro_torch.convert``, so
values compare number by number (fp32; the tolerances cover summation
order only, unless a test says otherwise).
"""
import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.models import model as jm
from repro.models import ssm as jssm
from repro.runtime import serve_loop as jsl
from repro_torch import convert
from repro_torch.configs import get_reduced
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.launch import serve as tserve
from repro_torch.models import model as tm
from repro_torch.models import ssm as tssm
from repro_torch.runtime.serve_loop import make_prefill_step, make_serve_step

torch.set_num_threads(2)

ARCH = "mamba2-2.7b"
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


def _close(got, want, atol=ATOL, rtol=1e-4):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


def _scan_inputs(seed, bsz, s, h, p, g, n):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((bsz, s, h, p), dtype=np.float32) * 0.5,
            np.log1p(np.exp(rng.standard_normal((bsz, s, h), dtype=np.float32))),
            np.log(np.linspace(1.0, 8.0, h, dtype=np.float32)),
            rng.standard_normal((bsz, s, g, n), dtype=np.float32) * 0.3,
            rng.standard_normal((bsz, s, g, n), dtype=np.float32) * 0.3,
            rng.standard_normal((bsz, h, p, n), dtype=np.float32) * 0.1)


# --------------------------------------------------------------------------
# the xla scans
# --------------------------------------------------------------------------

@pytest.mark.parametrize("bsz,s,h,p,g,n,chunk", [
    (2, 64, 4, 8, 2, 16, 16),
    (1, 50, 4, 16, 1, 8, 16),     # padding path
])
@pytest.mark.parametrize("with_init", [False, True])
def test_ssd_chunked_matches_jax(bsz, s, h, p, g, n, chunk, with_init):
    arrays = _scan_inputs(3, bsz, s, h, p, g, n)
    if not with_init:
        arrays = arrays[:5] + (None,)
    jy, jf = jssm.ssd_chunked(*(None if a is None else jnp.asarray(a) for a in arrays[:5]),
                              chunk, None if arrays[5] is None else jnp.asarray(arrays[5]))
    ty, tf = tssm.ssd_chunked(*(torch.from_numpy(a) for a in arrays[:5]), chunk,
                              None if arrays[5] is None else torch.from_numpy(arrays[5]))
    assert ty.dtype == torch.float32
    _close(ty, jy, atol=1e-5)
    _close(tf, jf, atol=1e-5)


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_ssd_scan_chunks_matches_jax(dtype, atol):
    """The long-sequence path, called directly at a small S. On bf16 both
    round scores to bf16 between the products, so a rounding tie may fall
    either way: the reference's bf16 tolerance."""
    x, dt, a_log, Bm, Cm, init = _scan_inputs(4, 2, 64, 4, 16, 2, 16)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jy, jf = jssm.ssd_scan_chunks(jnp.asarray(x, jdt), jnp.asarray(dt), jnp.asarray(a_log),
                                  jnp.asarray(Bm, jdt), jnp.asarray(Cm, jdt), 16,
                                  jnp.asarray(init))
    ty, tf = tssm.ssd_scan_chunks(torch.from_numpy(x).to(tdt), torch.from_numpy(dt),
                                  torch.from_numpy(a_log), torch.from_numpy(Bm).to(tdt),
                                  torch.from_numpy(Cm).to(tdt), 16, torch.from_numpy(init))
    _close(ty, jy, atol=atol, rtol=1e-2)
    _close(tf, jf, atol=atol, rtol=1e-2)


def test_ssd_chunked_switches_to_chunk_scan_at_threshold(monkeypatch):
    """At S >= SSD_SCAN_THRESHOLD the xla path scans chunks, as the
    reference does; both paths give the same numbers."""
    x, dt, a_log, Bm, Cm, _ = (torch.from_numpy(a) for a in _scan_inputs(5, 1, 64, 4, 8, 1, 8))
    batched = tssm.ssd_chunked(x, dt, a_log, Bm, Cm, 16)
    calls = []
    scan = tssm.ssd_scan_chunks
    monkeypatch.setattr(tssm, "SSD_SCAN_THRESHOLD", 64)
    monkeypatch.setattr(tssm, "ssd_scan_chunks", lambda *a: calls.append(1) or scan(*a))
    scanned = tssm.ssd_chunked(x, dt, a_log, Bm, Cm, 16)
    assert calls == [1]
    for got, want in zip(scanned, batched):
        _close(got, want.numpy(), atol=1e-5)


# --------------------------------------------------------------------------
# the block
# --------------------------------------------------------------------------

def _block(pair):
    jcfg, tcfg, jparams, tparams, _ = pair
    jmix = jax.tree.map(lambda a: a[0], jparams["stack"]["sub0"]["mixer"])
    return jcfg, tcfg, jmix, tparams["stack"][0]["mixer"]


def _hidden(seed, s):
    return np.random.default_rng(seed).standard_normal((B, s, 64), dtype=np.float32)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_ssm_apply_matches_jax(pair, impl):
    jcfg, tcfg, jmix, tmix = _block(pair)
    x = _hidden(6, 24)
    want = jssm.ssm_apply(jmix, jnp.asarray(x), 64, jcfg.ssm, impl=impl)
    got = tssm.ssm_apply(tmix, torch.from_numpy(x), 64, tcfg.ssm, impl=impl)
    _close(got, want, atol=1e-5)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("s", [24, 2])     # 2 < conv_width - 1: zero-padded tail
def test_ssm_prefill_matches_jax(pair, impl, s):
    jcfg, tcfg, jmix, tmix = _block(pair)
    x = _hidden(7, s)
    jout, jcache = jssm.ssm_prefill(jmix, jnp.asarray(x), 64, jcfg.ssm, impl=impl)
    tout, tcache = tssm.ssm_prefill(tmix, torch.from_numpy(x), 64, tcfg.ssm, impl=impl)
    _close(tout, jout, atol=1e-5)
    assert tcache["conv"].shape == jcache["conv"].shape
    _close(tcache["conv"], jcache["conv"], atol=1e-5)
    _close(tcache["state"], jcache["state"], atol=1e-5)


def test_ssm_decode_step_matches_jax_in_place(pair):
    """Three steps from a random cache. The port updates the cache's
    tensors in place and returns the same dict; the values follow the
    reference's new cache."""
    jcfg, tcfg, jmix, tmix = _block(pair)
    rng = np.random.default_rng(8)
    conv = rng.standard_normal((B, 3, 160), dtype=np.float32)
    state = rng.standard_normal((B, 8, 16, 16), dtype=np.float32) * 0.1
    jcache = {"conv": jnp.asarray(conv), "state": jnp.asarray(state)}
    tcache = {"conv": torch.from_numpy(conv.copy()), "state": torch.from_numpy(state.copy())}
    buffers = (tcache["conv"], tcache["state"])
    for t in range(3):
        x = _hidden(9 + t, 1)
        jout, jcache = jssm.ssm_decode_step(jmix, jnp.asarray(x), jcache, 64, jcfg.ssm)
        tout, new = tssm.ssm_decode_step(tmix, torch.from_numpy(x), tcache, 64, tcfg.ssm)
        assert new is tcache
        assert new["conv"] is buffers[0] and new["state"] is buffers[1]
        _close(tout, jout, atol=1e-5)
        _close(tcache["conv"], jcache["conv"], atol=1e-6)
        _close(tcache["state"], jcache["state"], atol=1e-5)


def test_ssm_rejects_unknown_impl(pair):
    _, tcfg, _, tmix = _block(pair)
    with pytest.raises(ValueError, match="impl"):
        tssm.ssm_apply(tmix, torch.from_numpy(_hidden(1, 4)), 64, tcfg.ssm, impl="triton")


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

def _jax_cache_layer(jcache, i):
    return {k: np.asarray(v[i]) for k, v in jcache["sub0"].items()}


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_prefill_matches_jax(pair, impl):
    jcfg, tcfg, jparams, tparams, toks = pair
    jlogits, jstate = jm.prefill(jparams, jnp.asarray(toks), jcfg, MAX_LEN, impl=impl)
    before = ssd.launches
    tlogits, tstate = tm.prefill(tparams, torch.from_numpy(toks).long(), tcfg,
                                 MAX_LEN, impl=impl)
    assert ssd.launches == before        # CPU tensors take the plain version
    _close(tlogits, jlogits)
    assert tstate["length"] == int(jstate["length"]) == S
    for i, layer in enumerate(tstate["cache"]):
        want = _jax_cache_layer(jstate["cache"], i)
        assert layer.keys() == want.keys() == {"conv", "state"}
        for key in ("conv", "state"):
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
    for i, layer in enumerate(tstate["cache"]):
        for key, want in _jax_cache_layer(jstate["cache"], i).items():
            _close(layer[key], want)


@pytest.mark.parametrize("impl", ["xla", "chunked", "pallas"])
def test_forward_matches_jax(pair, impl):
    jcfg, tcfg, jparams, tparams, toks = pair
    jlogits, _ = jm.forward(jparams, jnp.asarray(toks), jcfg, impl=impl)
    tlogits, aux = tm.forward(tparams, torch.from_numpy(toks).long(), tcfg, impl=impl)
    assert float(aux) == 0.0
    _close(tlogits, jlogits)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_prefill_matches_stepwise_decode(impl):
    """Twin of tests/test_models.py::test_prefill_matches_stepwise_decode
    for mamba2 inside the port: prefill's logits, conv tail and SSD state
    equal ten decode steps from an empty cache."""
    _, cfg = _cfgs()
    params = tm.init_params(cfg, 1, device="cpu")
    toks = torch.from_numpy(
        np.random.default_rng(3).integers(1, cfg.vocab_size, (B, S))).long()
    logits_pf, state_pf = tm.prefill(params, toks, cfg, MAX_LEN, impl=impl)
    state = tm.init_decode_state(cfg, B, MAX_LEN, device="cpu")
    for t in range(S):
        logits_dec, state = tm.decode_step(params, state, toks[:, t], cfg)
    _close(logits_pf, logits_dec.numpy(), atol=5e-4)
    for a, b in zip(state_pf["cache"], state["cache"]):
        for key in ("conv", "state"):
            assert float((a[key] - b[key]).abs().max()) < 5e-4


def test_bf16_path_gap_is_the_references_own():
    """In bf16 the pallas path rounds y before the d_skip add and the xla
    path does not; random weights amplify that with depth. The port's gap
    between its two paths stays of the size of the reference's own gap
    between its two paths (16 layers; ``-s`` prints both)."""
    jcfg, tcfg = (dataclasses.replace(c, n_layers=16) for c in _cfgs("bfloat16"))
    jparams = jm.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = convert.from_jax_params(_np_tree(jparams), tcfg, device="cpu")
    toks = np.random.default_rng(1).integers(1, jcfg.vocab_size, (4, 64)).astype(np.int32)

    def gap(logits):
        pallas, xla = (np.asarray(logits[impl], np.float32) for impl in ("pallas", "xla"))
        return float(np.linalg.norm(pallas - xla) / np.linalg.norm(xla))

    jgap = gap({impl: jm.prefill(jparams, jnp.asarray(toks), jcfg, 64, impl=impl)[0]
                for impl in ("pallas", "xla")})
    tgap = gap({impl: tm.prefill(tparams, torch.from_numpy(toks).long(), tcfg, 64,
                                 impl=impl)[0].float().numpy()
                for impl in ("pallas", "xla")})
    print(f"bf16 pallas vs xla prefill logits, rel L2: reference {jgap:.4g}, port {tgap:.4g}")
    assert tgap <= 2 * max(jgap, 1e-3)


def test_greedy_tokens_match_jax():
    jcfg, tcfg = _cfgs()
    jparams = jm.init_params(jax.random.PRNGKey(3), jcfg)
    tparams = convert.from_jax_params(_np_tree(jparams), tcfg, device="cpu")
    toks = np.random.default_rng(5).integers(1, jcfg.vocab_size, (3, 12)).astype(np.int32)
    max_len = 12 + 8

    jtok, jstate = jsl.make_prefill_step(jcfg, max_len, impl="pallas")(
        jparams, jnp.asarray(toks))
    ttok, tstate = make_prefill_step(tcfg, max_len, impl="pallas")(
        tparams, torch.from_numpy(toks).long())
    jserve, tserve_step = jsl.make_serve_step(jcfg), make_serve_step(tcfg)
    jseq, tseq = [np.asarray(jtok)], [ttok.numpy()]
    for _ in range(8):
        jtok, _, jstate = jserve(jparams, jstate, jtok)
        ttok, logits, tstate = tserve_step(tparams, tstate, ttok)
        jseq.append(np.asarray(jtok))
        tseq.append(ttok.numpy())
    assert ttok.dtype == torch.int32 and tuple(logits.shape) == (3, 256)
    np.testing.assert_array_equal(np.stack(tseq), np.stack(jseq))


def test_converter_round_trip_bf16_bits_exact():
    """bf16 leaves, fp32 leaves and the nested gate_norm scale all move
    bit for bit in both directions."""
    jcfg, tcfg = _cfgs("bfloat16")
    jtree = _np_tree(jm.init_params(jax.random.PRNGKey(5), jcfg))
    for tree in (jtree, jax.tree.map(
            lambda a: a.view(np.uint16) if a.dtype.name == "bfloat16" else a, jtree)):
        model = convert.from_jax_params(tree, tcfg, device="cpu")
        mixer = model["stack"][1]["mixer"]
        assert mixer["w_in"].dtype == torch.bfloat16
        assert mixer["gate_norm"]["scale"].dtype == torch.float32
        assert "norm2" not in model["stack"][1]
        back = convert.to_jax_layout(model, tcfg)
        flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
        flat_want = dict(jax.tree_util.tree_leaves_with_path(jtree))
        assert flat_back.keys() == flat_want.keys()
        assert any("gate_norm" in jax.tree_util.keystr(p) for p in flat_want)
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


def test_init_decode_state_matches_reference_shapes():
    jcfg, tcfg = _cfgs("bfloat16")
    jstate = jm.init_decode_state(jcfg, B, MAX_LEN)
    tstate = tm.init_decode_state(tcfg, B, MAX_LEN, device="cpu")
    assert len(tstate["cache"]) == tcfg.n_layers
    for i, layer in enumerate(tstate["cache"]):
        for key, want in _jax_cache_layer(jstate["cache"], i).items():
            assert tuple(layer[key].shape) == want.shape
            assert str(layer[key].dtype).split(".")[1] == str(want.dtype)


def test_serve_demo_runs_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", ARCH, "--device", "cpu",
                                      "--rounds", "2", "--gen-len", "3"])
    tserve.main()
    rounds = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["round"] for r in rounds] == [0, 1]
    assert rounds[0]["shares"] == {"rep0": 8, "rep1": 8, "rep2": 8}
    assert rounds[1]["shares"] == {"rep0": 10, "rep1": 10, "rep2": 4}
    assert rounds[1]["idle_s"] < rounds[0]["idle_s"]
