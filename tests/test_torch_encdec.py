"""whisper-medium's encoder-decoder path in the port against the JAX package,
on the reduced config in fp32: ``encode`` (the audio adapter, sinusoidal
positions, the non-causal stack, ``enc_norm``), ``forward``, ``loss_fn``,
``prefill`` and ``decode_step`` with ``enc_out``, on ``impl="xla"`` and
``impl="pallas"`` (the JAX side in interpret mode, the port's kernel
wrapper on its plain version, since the tensors lie on the CPU). The
weights come from the reference through ``repro_torch.convert``, so the
outputs compare number by number: ATOL 1e-4 (rel 1e-4) covers summation
order only. Also the converter and the checkpoints with encoder, cross
and adapter leaves, and granite-3-8b reduced over a 2-layer encoder with
no frontend. The JAX package is imported inside a fixture, so ``-m gpu``
runs where only torch is installed.
"""
import dataclasses
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_reduced
from repro_torch.kernels import ops as kops
from repro_torch.models import model as tm

torch.set_num_threads(2)

ARCH = "whisper-medium"
ATOL = 1e-4
B, S, S_ENC, MAX_LEN = 2, 10, 20, 32
IMPLS = ["xla", "pallas"]


@pytest.fixture(scope="module")
def J():
    """The JAX package, imported here and not at the top, so that the
    ``gpu`` test runs on a machine without JAX."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_reduced as j_get_reduced
    from repro.models import model as jm
    return SimpleNamespace(jax=jax, jnp=jnp, get_reduced=j_get_reduced, jm=jm)


def _cfgs(J, arch=ARCH, dtype="float32", **change):
    return (dataclasses.replace(J.get_reduced(arch), dtype=dtype, **change),
            dataclasses.replace(get_reduced(arch), dtype=dtype, **change))


def _np_tree(J, tree):
    return J.jax.tree.map(np.asarray, tree)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=atol, rtol=1e-4)


def _pair(J, arch=ARCH, feat_dim=None, **change):
    jcfg, tcfg = _cfgs(J, arch, **change)
    jparams = J.jm.init_params(J.jax.random.PRNGKey(1), jcfg)
    tparams = convert.from_jax_params(_np_tree(J, jparams), tcfg, device="cpu")
    rng = np.random.default_rng(2)
    toks = rng.integers(1, jcfg.vocab_size, (B, S)).astype(np.int32)
    feats = rng.standard_normal((B, S_ENC, feat_dim or 128)).astype(np.float32)
    return jcfg, tcfg, jparams, tparams, toks, feats


@pytest.fixture(scope="module")
def pair(J):
    return _pair(J)


@pytest.mark.parametrize("impl", IMPLS)
def test_encode_matches_jax(J, pair, impl):
    jax, jnp, jm = J.jax, J.jnp, J.jm
    jcfg, tcfg, jparams, tparams, _, feats = pair
    want = jm.encode(jparams, jnp.asarray(feats), jcfg, impl=impl)
    got = tm.encode(tparams, torch.from_numpy(feats), tcfg, impl=impl)
    assert got.shape == (B, S_ENC, tcfg.d_model)
    _close(got, want)


@pytest.mark.parametrize("impl", IMPLS)
def test_forward_and_loss_match_jax(J, pair, impl):
    jax, jnp, jm = J.jax, J.jnp, J.jm
    jcfg, tcfg, jparams, tparams, toks, feats = pair
    jlogits, _ = jm.forward(jparams, jnp.asarray(toks), jcfg, enc_feats=jnp.asarray(feats),
                            impl=impl)
    tlogits, _ = tm.forward(tparams, torch.from_numpy(toks).long(), tcfg,
                            enc_feats=torch.from_numpy(feats), impl=impl)
    _close(tlogits, jlogits)
    labels = np.roll(toks, -1, axis=1)
    jloss = jm.loss_fn(jparams, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
                                 "enc_feats": jnp.asarray(feats)}, jcfg, impl=impl)
    tloss = tm.loss_fn(tparams, {"tokens": torch.from_numpy(toks).long(),
                                 "labels": torch.from_numpy(labels).long(),
                                 "enc_feats": torch.from_numpy(feats)}, tcfg, impl=impl)
    assert float(tloss) == pytest.approx(float(jloss), rel=1e-5)


@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_and_decode_match_jax(J, pair, impl):
    jax, jnp, jm = J.jax, J.jnp, J.jm
    jcfg, tcfg, jparams, tparams, toks, feats = pair
    jlogits, jstate = jm.prefill(jparams, jnp.asarray(toks), jcfg, MAX_LEN,
                                 enc_feats=jnp.asarray(feats), impl=impl)
    tlogits, tstate = tm.prefill(tparams, torch.from_numpy(toks).long(), tcfg, MAX_LEN,
                                 enc_feats=torch.from_numpy(feats), impl=impl)
    _close(tlogits, jlogits)
    assert tstate["length"] == int(jstate["length"]) == S
    for i, c in enumerate(tstate["cache"]):
        for name in ("k", "v"):
            _close(c[name], jstate["cache"]["sub0"][name][i])
    jenc = jm.encode(jparams, jnp.asarray(feats), jcfg)
    tenc = tm.encode(tparams, torch.from_numpy(feats), tcfg)
    tok = np.array(jnp.argmax(jlogits, -1), np.int32)
    for _ in range(4):
        jlogits, jstate = jm.decode_step(jparams, jstate, jnp.asarray(tok), jcfg,
                                         enc_out=jenc)
        tlogits, tstate = tm.decode_step(tparams, tstate, torch.from_numpy(tok).long(), tcfg,
                                         enc_out=tenc)
        _close(tlogits, jlogits)
        tok = np.array(jnp.argmax(jlogits, -1), np.int32)
    assert tstate["length"] == S + 4


def test_prefill_matches_stepwise_decode(pair):
    """Twin of tests/test_models.py::test_prefill_matches_stepwise_decode
    for whisper: prefill over 10 tokens equals 10 decode steps from an empty
    cache, logits and caches within 5e-4, on the port alone."""
    _, tcfg, _, tparams, toks, feats = pair
    t = torch.from_numpy(toks).long()
    f = torch.from_numpy(feats)
    enc_out = tm.encode(tparams, f, tcfg)
    logits_pf, state_pf = tm.prefill(tparams, t, tcfg, MAX_LEN, enc_feats=f)
    state = tm.init_decode_state(tcfg, B, MAX_LEN, device="cpu")
    for i in range(S):
        logits_dec, state = tm.decode_step(tparams, state, t[:, i], tcfg, enc_out=enc_out)
    torch.testing.assert_close(logits_dec, logits_pf, atol=5e-4, rtol=0)
    for a, b in zip(state_pf["cache"], state["cache"]):
        for name in ("k", "v"):
            torch.testing.assert_close(b[name], a[name], atol=5e-4, rtol=0)


def test_encoder_runs_the_kernel_non_causal(pair, monkeypatch):
    """impl="pallas": the encoder's layers call the flash kernel with
    causal off, the decoder's with causal on; cross-attention never."""
    _, tcfg, _, tparams, toks, feats = pair
    calls = []
    real = kops.flash_attention

    def spy(q, k, v, **kw):
        calls.append((kw["causal"], q.shape[1], k.shape[1]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(kops, "flash_attention", spy)
    tm.forward(tparams, torch.from_numpy(toks).long(), tcfg,
               enc_feats=torch.from_numpy(feats), impl="pallas")
    enc, dec = tcfg.encoder_layers, tcfg.n_layers
    assert calls == [(False, S_ENC, S_ENC)] * enc + [(True, S, S)] * dec


def test_cross_attention_decode_leaves_the_cache_untouched(pair):
    from repro_torch.models import attention as attn
    _, tcfg, _, tparams, _, _ = pair
    p = tparams["stack"][0]["cross"]
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(B, 1, tcfg.d_model, generator=gen)
    enc = torch.randn(B, S_ENC, tcfg.d_model, generator=gen)
    cache = attn.init_kv_cache(B, 8, tcfg.attention, dtype=torch.float32)
    out, back = attn.attention_decode_step(p, x, cache, 3, tcfg.attention, kv_source=enc)
    assert back is cache and not cache["k"].any() and not cache["v"].any()
    want = attn.attention_apply(p, x, tcfg.attention, None, kv_source=enc, impl="pallas")
    torch.testing.assert_close(out, want, rtol=0, atol=0)


def test_serve_steps_take_enc_feats_and_enc_out(J, pair):
    """The serving steps with the reference's signatures: prefill_step(params,
    tokens, enc_feats), serve_step(params, state, tokens, enc_out)."""
    jax, jnp, jm = J.jax, J.jnp, J.jm
    from repro.runtime import serve_loop as jsl
    from repro_torch.runtime import serve_loop as tsl
    jcfg, tcfg, jparams, tparams, toks, feats = pair
    jtok, jstate = jsl.make_prefill_step(jcfg, MAX_LEN)(jparams, jnp.asarray(toks),
                                                        jnp.asarray(feats))
    ttok, tstate = tsl.make_prefill_step(tcfg, MAX_LEN)(tparams, torch.from_numpy(toks).long(),
                                                        torch.from_numpy(feats))
    assert np.array_equal(ttok.numpy(), np.asarray(jtok))
    jenc = jm.encode(jparams, jnp.asarray(feats), jcfg)
    tenc = tm.encode(tparams, torch.from_numpy(feats), tcfg)
    for _ in range(3):
        jtok, jlogits, jstate = jsl.make_serve_step(jcfg)(jparams, jstate, jtok, jenc)
        ttok, tlogits, tstate = tsl.make_serve_step(tcfg)(tparams, tstate, ttok, tenc)
        _close(tlogits, jlogits)
        assert np.array_equal(ttok.numpy(), np.asarray(jtok))


def test_enc_dec_needs_enc_feats(pair):
    _, tcfg, _, tparams, toks, _ = pair
    with pytest.raises(ValueError, match="needs enc_feats"):
        tm.forward(tparams, torch.from_numpy(toks).long(), tcfg)


@pytest.mark.parametrize("arch", ["whisper-medium", "pixtral-12b"])
def test_serve_demo_refuses_encoder_and_frontend_archs(arch):
    """As the reference's demo: the serve demo targets decoder-only archs."""
    import sys

    from repro_torch.launch import serve
    argv = sys.argv
    sys.argv = ["serve", "--arch", arch, "--device", "cpu"]
    try:
        with pytest.raises(SystemExit, match="decoder-only"):
            serve.main()
    finally:
        sys.argv = argv


# --------------------------------------------------------------------------
# converter and checkpoints
# --------------------------------------------------------------------------

def test_converter_round_trips_bf16_bit_for_bit(J):
    jax, jnp, jm = J.jax, J.jnp, J.jm
    jcfg, tcfg = _cfgs(J, dtype="bfloat16")
    jparams = _np_tree(J, jm.init_params(jax.random.PRNGKey(4), jcfg))
    model = convert.from_jax_params(jparams, tcfg, device="cpu")
    assert model.encoder_period == 1 and len(model["encoder"]) == tcfg.encoder_layers
    assert sorted(model["stack"][0].keys()) == ["cross", "ffn", "mixer", "norm1", "norm2",
                                                "norm_cross"]
    back = convert.to_jax_layout(model, tcfg)
    flat_j = dict(jax.tree_util.tree_flatten_with_path(jparams)[0])
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert sorted(map(jax.tree_util.keystr, flat_j)) == sorted(map(jax.tree_util.keystr, flat_b))
    for path, a in flat_j.items():
        b = flat_b[path]
        a = a.view(np.uint16) if a.dtype.name == "bfloat16" else a
        np.testing.assert_array_equal(b, a, err_msg=jax.tree_util.keystr(path))


def test_init_params_has_the_references_tree(J):
    """The port's init gives the reference's leaves, shapes and dtypes."""
    jax, jnp, jm = J.jax, J.jnp, J.jm
    jcfg, tcfg = _cfgs(J, dtype="bfloat16")
    jshapes = jax.eval_shape(lambda: jm.init_params(jax.random.PRNGKey(0), jcfg))
    tree = convert.to_jax_layout(tm.init_params(tcfg, 0, device="cpu"), tcfg)
    want = {jax.tree_util.keystr(p): (tuple(a.shape), str(a.dtype))
            for p, a in jax.tree_util.tree_leaves_with_path(jshapes)}
    got = {jax.tree_util.keystr(p): (tuple(a.shape),
                                     "bfloat16" if a.dtype == np.uint16 else str(a.dtype))
           for p, a in jax.tree_util.tree_leaves_with_path(tree)}
    assert got == want


def _train_pair(J):
    from repro.configs import ArchBundle as JBundle
    from repro.configs import TrainConfig as JTrain
    from repro_torch.configs import ArchBundle, TrainConfig
    tc = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jcfg, tcfg = _cfgs(J, dtype="float32")
    return (jcfg, JBundle(model=jcfg, train=JTrain(**tc))), \
        (tcfg, ArchBundle(model=tcfg, train=TrainConfig(**tc)))


def _batch(seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, 256, (B, S)).astype(np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, axis=1),
            "enc_feats": rng.standard_normal((B, S_ENC, 128)).astype(np.float32)}


def _npz(path):
    with np.load(os.path.join(path, "arrays.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    with open(os.path.join(path, "meta.json")) as f:
        return arrays, json.load(f)


def test_train_step_matches_reference(J):
    """One full train step (loss, grads, schedule, AdamW with decay on the
    encoder's stacked leaves) in both packages on the same params. The
    gradients hold at atol 1e-6 (rel 1e-4); the updated params at atol
    5e-5, 5 % of the lr: AdamW's first step moves an element by about
    lr * g / (|g| + 1e-8), so an element whose gradient is near 1e-8 moves
    by a share of lr that summation order can change."""
    jax, jnp, jm = J.jax, J.jnp, J.jm
    from repro.runtime import train_loop as jtl
    from repro_torch.runtime import train_loop as ttl
    (jcfg, jb), (tcfg, tb) = _train_pair(J)
    jst = jtl.train_state_init(jax.random.PRNGKey(3), jcfg, jb)
    tst = ttl.train_state_from_params(
        convert.from_jax_params(_np_tree(J, jst.params), tcfg, device="cpu"), tb)
    batch = _batch(5)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    jgrads = _np_tree(J, jax.grad(lambda p: jm.loss_fn(p, jbatch, jcfg))(jst.params))
    _, tgrads = ttl.value_and_grad(tst.params, tbatch, tcfg, "xla", "none")
    for path, names in convert.reference_paths(tst.params, tcfg.layer_period).items():
        got = np.stack([tgrads[n].numpy() for n in names])
        want = jgrads
        for key in path:
            want = want[key]
        np.testing.assert_allclose(got.reshape(want.shape), want, atol=1e-6, rtol=1e-4,
                                   err_msg=str(path))
    jst, jmet = jtl.make_train_step(jcfg, jb)(jst, jbatch)
    tst, tmet = ttl.make_train_step(tcfg, tb)(tst, tbatch)
    for key in ("loss", "grad_norm", "lr"):
        assert float(tmet[key]) == pytest.approx(float(jmet[key]), rel=1e-4), key
    got = dict(jax.tree_util.tree_flatten_with_path(convert.to_jax_layout(tst.params, tcfg))[0])
    for path, want in jax.tree_util.tree_flatten_with_path(_np_tree(J, jst.params))[0]:
        np.testing.assert_allclose(got[path], want, atol=5e-5, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


def test_checkpoints_round_trip_across_packages(J, tmp_path):
    """The reference's whisper TrainState after a step restores in the port
    and gives the same npz back; the port's restores in the reference leaf
    for leaf."""
    jax, jnp, jm = J.jax, J.jnp, J.jm
    from repro.checkpoint import restore_checkpoint as j_restore
    from repro.checkpoint import save_checkpoint as j_save
    from repro.runtime import train_loop as jtl
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.runtime import train_loop as ttl
    (jcfg, jb), (tcfg, tb) = _train_pair(J)
    jst = jtl.train_state_init(jax.random.PRNGKey(0), jcfg, jb)
    jst, _ = jtl.make_train_step(jcfg, jb)(jst, {k: jnp.asarray(v)
                                                 for k, v in _batch(1).items()})
    ref_path = j_save(str(tmp_path / "ref"), 1, jst)
    step, tst, _ = restore_checkpoint(ref_path, ttl.train_state_init(7, tcfg, tb, device="cpu"))
    assert step == 1 and tst.step == 1
    port_path = save_checkpoint(str(tmp_path / "port"), 1, tst)
    (ra, rmeta), (pa, pmeta) = _npz(ref_path), _npz(port_path)
    assert sorted(pa) == sorted(ra) and pmeta == rmeta
    assert any(k.startswith("params/encoder/sub0/") for k in ra)
    assert "params/adapter/w" in ra and "params/stack/sub0/cross/wq" in ra
    for k in ra:
        np.testing.assert_array_equal(pa[k], ra[k], err_msg=k)
    _, back, _ = j_restore(port_path, jtl.train_state_init(jax.random.PRNGKey(9), jcfg, jb))
    for path, want in jax.tree_util.tree_flatten_with_path(_np_tree(J, jst.params))[0]:
        got = dict(jax.tree_util.tree_flatten_with_path(_np_tree(J, back.params))[0])[path]
        np.testing.assert_array_equal(got, want, err_msg=jax.tree_util.keystr(path))


# --------------------------------------------------------------------------
# an encoder without a frontend (moved out of the refusal test)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("impl", IMPLS)
def test_granite_over_an_encoder_matches_jax(J, impl):
    """granite-3-8b reduced with ``encoder_layers=2`` and no frontend: the
    reference's ``encode`` runs without an adapter on d_model features, and
    the decoder (rope, no sinusoids) attends to it through cross layers."""
    jax, jnp, jm = J.jax, J.jnp, J.jm
    jcfg, tcfg, jparams, tparams, toks, _ = _pair(J, "granite-3-8b", encoder_layers=2)
    feats = np.random.default_rng(3).standard_normal((B, S_ENC, tcfg.d_model)) \
        .astype(np.float32) * 0.5
    jlogits, _ = jm.forward(jparams, jnp.asarray(toks), jcfg, enc_feats=jnp.asarray(feats),
                            impl=impl)
    tlogits, _ = tm.forward(tparams, torch.from_numpy(toks).long(), tcfg,
                            enc_feats=torch.from_numpy(feats), impl=impl)
    _close(tlogits, jlogits)
    jl, jstate = jm.prefill(jparams, jnp.asarray(toks), jcfg, MAX_LEN,
                            enc_feats=jnp.asarray(feats), impl=impl)
    tl, tstate = tm.prefill(tparams, torch.from_numpy(toks).long(), tcfg, MAX_LEN,
                            enc_feats=torch.from_numpy(feats), impl=impl)
    _close(tl, jl)
    jenc = jm.encode(jparams, jnp.asarray(feats), jcfg)
    tenc = tm.encode(tparams, torch.from_numpy(feats), tcfg)
    tok = np.array(jnp.argmax(jl, -1), np.int32)
    jl, _ = jm.decode_step(jparams, jstate, jnp.asarray(tok), jcfg, enc_out=jenc)
    tl, _ = tm.decode_step(tparams, tstate, torch.from_numpy(tok).long(), tcfg, enc_out=tenc)
    _close(tl, jl)


@pytest.mark.gpu
def test_whisper_encoder_on_card():
    """On the card, in bf16: the encoder's non-causal layers run the flash
    kernel on the wgmma route at 1500 frames (11 full 128-key tiles and a
    ragged 92-key one), against the xla path within 5e-2 rel L2."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import flash_attention as fa
    cfg = dataclasses.replace(get_reduced(ARCH), dtype="bfloat16", max_source_positions=1500,
                              d_model=1024, attention=dataclasses.replace(
                                  get_reduced(ARCH).attention, n_heads=16, n_kv_heads=16,
                                  head_dim=64))
    params = tm.init_params(cfg, 0)
    feats = torch.randn((2, 1500, 128), generator=torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    before = dict(fa.launches_by_route)
    with torch.no_grad():
        got = tm.encode(params, feats, cfg, impl="pallas").float()
        want = tm.encode(params, feats, cfg, impl="xla").float()
    assert fa.launches_by_route["wgmma"] - before["wgmma"] == cfg.encoder_layers
    assert fa.launches_by_route["simt"] == before["simt"]
    assert float((got - want).norm() / want.norm()) < 5e-2
