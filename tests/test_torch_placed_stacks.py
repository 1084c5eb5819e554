"""Every arch's placed path on a one-process gloo (1, 1) mesh, on the CPU.

Each of the 10 reduced archs in fp32, its params placed by
``runtime.sharding.param_shardings`` (its train state by
``train_state_shardings``, its prompts and batches by
``batch_shardings``, its decode caches by ``cache_shardings``), gives on
``impl="xla"`` and ``impl="pallas"`` the unplaced port's results bit for
bit: the forward (with and without the activation hook), a prefill and 4
decode steps, and ``loss_fn``'s loss and gradients with the train step
they feed. On one rank every local shard is the whole tensor, so nothing
but the DTensor dispatch differs. The MoE stacks (granite-moe-1b-a400m,
dbrx-132b, jamba-1.5-large-398b) run the sort dispatch on each rank's own
rows, and the SSM stacks (mamba2-2.7b, jamba) build the conv tail of their
decode caches from the placed activations. The placed forward also
matches the JAX package at fp32 1e-4 on the reference's weights
(``convert.from_jax_params``), as ``tests/test_torch_sharding.py`` holds
granite. On the one-process fake (16, 16) mesh the ``moe_buffer`` hook
places the dispatch buffers with experts over "model". JAX and the
reference are imported in fixtures only, so the ``gpu`` test runs on the
card without JAX; every process group lives in a fixture or a context
that destroys it.
"""
import copy
import dataclasses
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from repro_torch import convert
from repro_torch.configs import ARCH_IDS, get_bundle, get_reduced
from repro_torch.launch.mesh import host_mesh, production_mesh
from repro_torch.models import model as tm
from repro_torch.models import moe
from repro_torch.models.frontends import stub_feature_shape
from repro_torch.runtime import sharding as sh
from repro_torch.runtime.serve_loop import make_prefill_step, make_serve_step
from repro_torch.runtime.train_loop import (make_train_step, train_state_from_params,
                                            value_and_grad)

torch.set_num_threads(2)

ATOL = 1e-4                     # tests/test_torch_sharding.py's, with rtol 1e-4
B, S, ENC_S, MAX_LEN, DECODE_STEPS = 2, 12, 16, 32, 4
IMPLS = ("xla", "pallas")


@pytest.fixture(scope="module")
def J():
    """The JAX reference: its models and configs."""
    import jax

    from repro import configs
    from repro.models import model
    return types.SimpleNamespace(jax=jax, configs=configs, model=model)


@pytest.fixture
def gloo_mesh():
    with host_mesh("cpu") as mesh:
        yield mesh
    assert not dist.is_initialized()


def _full(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def _cfg(arch):
    return dataclasses.replace(get_reduced(arch), dtype="float32")


def _inputs(cfg, seed=2):
    """numpy prompts of one batch: tokens, or stub patch embeddings for a
    vision arch; stub audio frames for an encoder-decoder arch."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(1, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.frontend == "vision":
        out["input_embeds"] = (rng.standard_normal(stub_feature_shape(cfg, B, S))
                               * 0.5).astype(np.float32)
    if cfg.encoder_layers > 0:
        out["enc_feats"] = (rng.standard_normal(stub_feature_shape(cfg, B, ENC_S))
                            * 0.5).astype(np.float32)
    return out


def _torch_inputs(cfg, arrays):
    """(tokens or None, keyword inputs) as the model's entry points take them."""
    kw = {k: torch.from_numpy(v) for k, v in arrays.items() if k != "tokens"}
    tokens = None if "input_embeds" in kw else torch.from_numpy(arrays["tokens"]).long()
    return tokens, kw


def _place_params(params, cfg, mesh, mcfg):
    placed = sh.place(copy.deepcopy(params), mesh, sh.param_shardings(cfg, mesh, mcfg))
    assert all(isinstance(p, DTensor) for p in placed.parameters())
    return placed


def _place_batch(batch, cfg, mesh, mcfg):
    return sh.place(batch, mesh, sh.batch_shardings(cfg, mesh, mcfg, batch))


# --------------------------------------------------------------------------
# forward, serving and training, placed against unplaced, bit for bit
# --------------------------------------------------------------------------

@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_placed_forward_is_bit_equal(gloo_mesh, arch, impl):
    cfg, mcfg = _cfg(arch), get_bundle(arch).mesh
    params = tm.init_params(cfg, 1, device="cpu")
    placed = _place_params(params, cfg, gloo_mesh, mcfg)
    tokens, kw = _torch_inputs(cfg, _inputs(cfg))
    want, want_aux = tm.forward(params, tokens, cfg, impl=impl, **kw)
    pkw = _place_batch(kw, cfg, gloo_mesh, mcfg)
    constrain = sh.make_activation_constraint(gloo_mesh, mcfg, B, S)
    with sh.mesh_context(placed):
        got, aux = tm.forward(placed, tokens, cfg, impl=impl, **pkw)
        hooked, _ = tm.forward(placed, tokens, cfg, impl=impl, constrain=constrain, **pkw)
    assert isinstance(got, DTensor)
    assert torch.equal(_full(got), want) and torch.equal(_full(hooked), want)
    assert torch.equal(_full(aux), want_aux)


def _serve(cfg, params, arrays, impl, mcfg, mesh=None):
    """A prefill and DECODE_STEPS greedy decode steps as users call them;
    on ``mesh`` the prompts and the decode state are placed."""
    tokens, kw = _torch_inputs(cfg, arrays)
    if mesh is not None:
        kw = _place_batch(kw, cfg, mesh, mcfg)
        if tokens is not None:
            tokens = _place_batch({"tokens": tokens}, cfg, mesh, mcfg)["tokens"]
    if "input_embeds" in kw:
        with torch.no_grad(), sh.mesh_context(params):
            logits, state = tm.prefill(params, None, cfg, MAX_LEN, impl=impl,
                                       input_embeds=kw["input_embeds"])
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
    else:
        tok, state = make_prefill_step(cfg, MAX_LEN, impl=impl)(params, tokens,
                                                               kw.get("enc_feats"))
    enc_out = None
    if cfg.encoder_layers > 0:
        with torch.no_grad(), sh.mesh_context(params):
            enc_out = tm.encode(params, kw["enc_feats"], cfg, impl=impl)
    if mesh is not None:
        state = sh.place(state, mesh, sh.cache_shardings(cfg, mesh, mcfg, state, B))
        assert all(isinstance(c[k], DTensor) for c in state["cache"] for k in c)
    serve_step = make_serve_step(cfg)
    out = [tok]
    for _ in range(DECODE_STEPS):
        tok, logits, state = serve_step(params, state, tok, enc_out)
        out += [tok, logits]
    assert state["length"] == S + DECODE_STEPS
    out += [t for c in state["cache"] for t in c.values()]
    return [_full(t) for t in out]


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_placed_serving_is_bit_equal(gloo_mesh, arch, impl):
    """Tokens, every decode step's logits and the final caches (the SSM
    conv windows and states updated in place on placed caches)."""
    cfg, mcfg = _cfg(arch), get_bundle(arch).mesh
    params = tm.init_params(cfg, 1, device="cpu")
    placed = _place_params(params, cfg, gloo_mesh, mcfg)
    arrays = _inputs(cfg)
    want = _serve(cfg, params, arrays, impl, mcfg)
    got = _serve(cfg, placed, arrays, impl, mcfg, gloo_mesh)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_placed_loss_grads_and_train_step_are_bit_equal(gloo_mesh, arch, impl):
    """``loss_fn`` and its gradients on placed params and a placed batch,
    then one ``make_train_step`` step of a placed train state: loss, grad
    norm and every updated param and moment."""
    cfg = _cfg(arch)
    bundle = get_bundle(arch).replace(model=cfg)
    params = tm.init_params(cfg, 1, device="cpu")
    arrays = _inputs(cfg)
    tokens, kw = _torch_inputs(cfg, arrays)
    batch = {"labels": torch.from_numpy(arrays["tokens"]).long(), **kw}
    if tokens is not None:
        batch["tokens"] = tokens
    plain = train_state_from_params(copy.deepcopy(params), bundle)
    placed = train_state_from_params(copy.deepcopy(params), bundle)
    placed = sh.place(placed, gloo_mesh,
                      sh.train_state_shardings(cfg, gloo_mesh, bundle.mesh, placed))
    pbatch = _place_batch(batch, cfg, gloo_mesh, bundle.mesh)
    constrain = sh.make_activation_constraint(gloo_mesh, bundle.mesh, B, S)

    loss, grads = value_and_grad(plain.params, batch, cfg, impl, "none")
    with sh.mesh_context(placed.params):
        ploss, pgrads = value_and_grad(placed.params, pbatch, cfg, impl, "none", constrain)
    assert torch.equal(_full(ploss), loss)
    assert set(pgrads) == set(grads)
    for name, g in grads.items():
        assert torch.equal(_full(pgrads[name]), g), name

    plain, metrics = make_train_step(cfg, bundle, impl=impl)(plain, batch)
    placed, pmetrics = make_train_step(cfg, bundle, impl=impl, constrain=constrain)(placed,
                                                                                    pbatch)
    assert placed.step == plain.step == 1
    for key in ("loss", "grad_norm"):
        assert torch.equal(_full(pmetrics[key]), metrics[key]), key
    want = dict(sh.named_tensors(plain))
    got = dict(sh.named_tensors(placed))
    assert set(got) == set(want)
    for name, t in got.items():
        assert isinstance(t, DTensor), name
        assert torch.equal(_full(t.detach()), want[name].detach()), name


# --------------------------------------------------------------------------
# against the JAX package
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_placed_forward_matches_jax(J, gloo_mesh, arch):
    jcfg = dataclasses.replace(J.configs.get_reduced(arch), dtype="float32")
    cfg, mcfg = _cfg(arch), get_bundle(arch).mesh
    jparams = J.model.init_params(J.jax.random.PRNGKey(3), jcfg)
    params = convert.from_jax_params(J.jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    placed = _place_params(params, cfg, gloo_mesh, mcfg)
    arrays = _inputs(cfg, seed=4)
    tokens, kw = _torch_inputs(cfg, arrays)
    with sh.mesh_context(placed):
        got, aux = tm.forward(placed, tokens, cfg, **_place_batch(kw, cfg, gloo_mesh, mcfg))
    jnp = J.jax.numpy
    jtok = None if tokens is None else jnp.asarray(arrays["tokens"])
    want, want_aux = J.model.forward(jparams, jtok, jcfg,
                                     **{k: jnp.asarray(v) for k, v in arrays.items()
                                        if k != "tokens"})
    np.testing.assert_allclose(_full(got).numpy(), np.asarray(want), atol=ATOL, rtol=1e-4)
    assert float(_full(aux)) == pytest.approx(float(want_aux), rel=1e-5, abs=1e-9)


# --------------------------------------------------------------------------
# the dispatch buffers on a mesh with a "model" axis
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_experts", [16, 8])
def test_moe_buffer_hook_keeps_experts_over_model(n_experts):
    """On the fake (16, 16) mesh: the dispatch runs on each data rank's own
    rows. With 16 experts (the expert dim divides "model") the
    ``moe_buffer`` hook places both buffers (B, E, cap, D) with the batch
    over "data" and the experts over "model", one expert a rank, and the
    expert products run on those shards; with 8 the experts cannot split
    over "model", the weights split their FFN dim instead, the buffers are
    placed by batch only and the products run as DTensor einsums. The
    output comes back batch-sharded."""
    cfg = _cfg("granite-moe-1b-a400m")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, n_experts=n_experts))
    split = n_experts == 16
    mcfg = get_bundle("granite-moe-1b-a400m").mesh
    batch, seq = 32, 8
    seen = []
    with production_mesh() as mesh:
        params = sh.place(tm.init_params(cfg, 0, device="cpu"), mesh,
                          sh.param_shardings(cfg, mesh, mcfg))
        ffn = params["stack"][0]["ffn"]
        assert ffn["w_up"].placements == (Replicate(), Shard(0 if split else 2))
        assert moe._experts_local(DTensor.from_local(
            torch.zeros(2, 1, 1, cfg.d_model), mesh, [Shard(0), Shard(1) if split else Replicate()],
            run_check=False), [ffn[k] for k in ("w_up", "w_gate", "w_down")]) == split
        constrain = sh.make_activation_constraint(mesh, mcfg, batch, seq)

        def hook(h, kind="residual"):
            out = constrain(h, kind)
            seen.append((kind, tuple(h.shape), out.placements, tuple(out.to_local().shape)))
            return out

        x = distribute_tensor(torch.randn(batch, seq, cfg.d_model,
                                          generator=torch.Generator().manual_seed(0)),
                              mesh, [Shard(0), Replicate()])
        with sh.mesh_context(params):
            out, aux = moe.moe_apply(ffn, x, cfg.moe, cfg.act, hook)
        assert isinstance(out, DTensor) and out.placements == (Shard(0), Replicate())
        assert out.shape == (batch, seq, cfg.d_model)
    assert not dist.is_initialized()
    cap = seen[0][1][2]
    assert [s[0] for s in seen] == ["moe_buffer"] * 2
    for kind, shape, placements, local in seen:
        assert shape == (batch, n_experts, cap, cfg.d_model)
        assert placements == (Shard(0), Shard(1) if split else Replicate())
        assert local == (batch // 16, 1 if split else n_experts, cap, cfg.d_model)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "mamba2-2.7b"])
def test_placed_moe_and_ssm_stacks_through_the_kernels_on_the_card(arch):
    """Reduced granite-moe and mamba2 in bf16 on a (1, 1) NCCL mesh:
    prefill through the flash or SSD kernel (wgmma) and decode on placed
    params and caches equal the unplaced run bit for bit, with the
    kernel launched once per layer of its kind."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd

    cfg = get_reduced(arch)
    mcfg = get_bundle(arch).mesh
    dev = torch.device("cuda")
    params = tm.init_params(cfg, 0, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    prefill_step, serve_step = make_prefill_step(cfg, 72, impl="pallas"), make_serve_step(cfg)
    kernel = ssd if cfg.ssm is not None else fa

    def run(p, mesh=None):
        tok, state = prefill_step(p, tokens)
        if mesh is not None:
            state = sh.place(state, mesh, sh.cache_shardings(cfg, mesh, mcfg, state, 2))
        out = [tok]
        for _ in range(4):
            tok, logits, state = serve_step(p, state, tok)
            out += [tok, logits]
        return [_full(t) for t in out]

    want = run(params)
    with host_mesh(dev) as mesh:
        placed = sh.place(params, mesh, sh.param_shardings(cfg, mesh, mcfg))
        before = kernel.launches_by_route["wgmma"]
        got = run(placed, mesh)
        assert kernel.launches_by_route["wgmma"] - before == cfg.n_layers
    assert not dist.is_initialized()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
