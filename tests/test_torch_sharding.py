"""The port's ``runtime/sharding.py`` against the reference's, on the CPU.

The rule engine (``_spec_for``, ``axis_rules``) number for number against
``tests/test_sharding_data.py``'s cases on the same stub mesh and against
the reference on hypothesis-drawn shapes and rules; then the placements of
params, train state, decode caches and batch inputs of all 10 archs on
the port's one-process fake (16, 16) and (2, 16, 16) meshes, leaf for leaf
(through ``convert.reference_paths``) against the reference's own
``*_shardings`` functions run on a stub mesh of the same shape over
``jax.eval_shape`` trees, fallback lists included. Then the placed path on
a one-process gloo (1, 1) mesh: a reduced granite forward and serving
round on placed params equal to the unplaced port at 0 and to JAX at
fp32 1e-4, the
activation hook, ``reshard_restore`` onto placements, and the kernel
wrappers' refusal of a shard. JAX and the reference are imported in
fixtures only, so the ``gpu`` test runs on the card without JAX. Every
process group lives in a fixture and is destroyed at its teardown.
"""
import copy
import dataclasses
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist
from hypothesis import given, settings, strategies as st
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch import convert
from repro_torch.configs import ARCH_IDS, get_bundle, get_reduced
from repro_torch.configs.shapes import SHAPES
from repro_torch.kernels import ops
from repro_torch.launch import specs as tspecs
from repro_torch.launch.mesh import host_mesh, production_mesh
from repro_torch.models import model as tm
from repro_torch.runtime import elastic
from repro_torch.runtime import sharding as sh
from repro_torch.runtime.serve_loop import make_prefill_step, make_serve_step

torch.set_num_threads(2)

ATOL = 1e-4
MESH_SHAPES = {"single": {"data": 16, "model": 16},
               "multi": {"pod": 2, "data": 16, "model": 16}}


class StubMesh:
    """Duck-typed mesh for the pure spec logic (``tests/test_sharding_data.py``)."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.devices = np.empty(tuple(shape.values()))


MESH = StubMesh(MESH_SHAPES["single"])
MESH3 = StubMesh(MESH_SHAPES["multi"])
RULES = {"embed": ("data",), "heads": ("model",), "vocab": ("model",),
         "batch": ("pod", "data"), "layers": None}


@pytest.fixture(scope="module")
def J():
    """The JAX reference: its sharding module, models, specs and configs."""
    import jax
    from jax.sharding import PartitionSpec

    from repro import configs
    from repro.launch import specs
    from repro.models import model
    from repro.runtime import sharding, train_loop
    return types.SimpleNamespace(jax=jax, P=PartitionSpec, configs=configs, specs=specs,
                                 model=model, sharding=sharding, train_loop=train_loop)


@pytest.fixture
def fake_mesh(request):
    """The production mesh of ``request.param`` on a fake group, destroyed
    at teardown."""
    with production_mesh(multi_pod=request.param == "multi") as mesh:
        yield mesh
    assert not dist.is_initialized()


@pytest.fixture
def gloo_mesh():
    with host_mesh("cpu") as mesh:
        yield mesh
    assert not dist.is_initialized()


# --------------------------------------------------------------------------
# the rule engine, number for number
# --------------------------------------------------------------------------

SPEC_CASES = [
    # test_spec_basic
    ((4096, 6144), ("embed", "heads"), MESH, RULES, ("data", "model")),
    # test_spec_divisibility_fallback: 49155 not divisible by 16
    ((49155, 4096), ("vocab", "embed"), MESH, RULES, (None, "data")),
    # test_spec_duplicate_axis_dropped: model axis used once only
    ((64, 64), ("a", "b"), MESH, {"a": ("model",), "b": ("model",)}, ("model", None)),
    # test_spec_multi_axis_prefix_fallback: 16 divides pod(2), not pod*data(32)
    ((16, 128), ("batch", None), MESH3, RULES, ("pod", None)),
]


@pytest.mark.parametrize("case", range(len(SPEC_CASES)))
def test_spec_for_matches_reference_cases(J, case):
    shape, names, mesh, rules, want = SPEC_CASES[case]
    got = sh._spec_for(shape, names, mesh, rules, None)
    assert got == want
    assert got == tuple(J.sharding._spec_for(shape, names, mesh, rules, None))


def test_axis_rules_kv_fallback():
    cfg = get_bundle("granite-3-8b").model     # kv=8 < model 16
    rules = sh.axis_rules(cfg, MESH, get_bundle("granite-3-8b").mesh)
    assert rules["kv_heads_cache"] is None
    assert rules["cache_seq"] == ("model",)
    rules_w = sh.axis_rules(get_bundle("whisper-medium").model, MESH,
                            get_bundle("whisper-medium").mesh)
    assert rules_w["kv_heads_cache"] == ("model",)   # kv=16 == model 16


def test_placements_split_in_mesh_order_and_not_over_one_rank():
    """A spec's axes become Shard on their mesh dims in mesh order; a
    one-rank mesh dim splits nothing and stays Replicate."""
    mesh = StubMesh({"pod": 2, "data": 16, "model": 16})
    assert sh.placements((("pod", "data"), "model"), mesh) == (Shard(0), Shard(0), Shard(1))
    assert sh.placements((None, ("data", "model")), mesh) == (Replicate(), Shard(1), Shard(1))
    with pytest.raises(ValueError, match="mesh order"):
        sh.placements((("model", "data"),), mesh)
    thin = StubMesh({"pod": 1, "data": 16, "model": 1})
    assert sh.placements((("pod", "data"), "model"), thin) == (Replicate(), Shard(0),
                                                                Replicate())
    assert sh.placements(("data", "model"), StubMesh({"data": 1, "model": 1})) == \
        (Replicate(), Replicate())


NAMES = st.sampled_from([None, "embed", "heads", "vocab", "batch", "layers", "a", "b"])
AXES = st.sampled_from([None, ("data",), ("model",), ("pod", "data"), ("data", "model"),
                        ("pod", "data", "model"), ("pod",), ("model", "data")])
DIMS = st.sampled_from([1, 2, 3, 8, 16, 24, 32, 48, 64, 96, 256, 512, 49155, 4096])


@settings(max_examples=60, deadline=None)
@given(shape=st.lists(DIMS, min_size=1, max_size=4),
       names=st.lists(NAMES, min_size=1, max_size=5),
       rule_axes=st.lists(AXES, min_size=8, max_size=8),
       multi=st.booleans())
def test_spec_for_matches_reference_drawn(J, shape, names, rule_axes, multi):
    """Drawn shapes, names (more or fewer than the dims) and rules: the same
    spec and the same fallback notes as the reference."""
    rules = dict(zip(["embed", "heads", "vocab", "batch", "layers", "a", "b", "c"],
                     rule_axes))
    mesh = MESH3 if multi else MESH
    rep_t, rep_j = sh.ShardingReport(), J.sharding.ShardingReport()
    got = sh._spec_for(tuple(shape), tuple(names), mesh, rules, rep_t, "x")
    want = J.sharding._spec_for(tuple(shape), tuple(names), mesh, rules, rep_j, "x")
    assert got == tuple(want)
    assert rep_t.fallbacks == rep_j.fallbacks


@pytest.mark.parametrize("fake_mesh", ["single", "multi"], indirect=True)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_axis_rules_match_reference(J, fake_mesh, arch):
    kind = "multi" if "pod" in fake_mesh.mesh_dim_names else "single"
    stub = StubMesh(MESH_SHAPES[kind])
    jb, tb = J.configs.get_bundle(arch), get_bundle(arch)
    want = J.sharding.axis_rules(jb.model, stub, jb.mesh)
    assert sh.axis_rules(tb.model, fake_mesh, tb.mesh) == want
    assert sh.axis_rules(tb.model, stub, tb.mesh) == want


# --------------------------------------------------------------------------
# placements leaf for leaf against the reference's *_shardings functions
# --------------------------------------------------------------------------

def _flat_specs(J, tree):
    """{key path tuple: spec} of a tree of PartitionSpecs."""
    flat, _ = J.jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, J.P))
    return {tuple(str(getattr(k, "key", getattr(k, "name", getattr(k, "idx", k))))
                  for k in path): tuple(spec) for path, spec in flat}


@pytest.fixture
def ref_specs(J, monkeypatch):
    """The reference's ``*_shardings`` functions on a stub mesh, returning
    PartitionSpecs (NamedSharding needs a real jax mesh of that many
    devices)."""
    monkeypatch.setattr(J.sharding, "NamedSharding", lambda mesh, spec: spec)
    return J.sharding


_META = {}


def _meta_params(arch):
    if arch not in _META:
        _META[arch] = tm.init_params(get_bundle(arch).model, device="meta")
    return _META[arch]


def _to_ref(model, period):
    """port parameter name -> (reference key path, whether it is stacked)."""
    out = {}
    for path, names in convert.reference_paths(model, period).items():
        for n in names:
            out[n] = (path, convert.is_stacked(path))
    return out


def _ref_note(note, to_ref):
    """A port fallback note in the reference's words: its leaf path and a
    stacked leaf's dim counted past the leading layer-group axis."""
    name, rest = note.split(" ", 1)
    dim, tail = rest.split("=", 1)
    path, stacked = to_ref[name]
    return f"{'/'.join(path)} dim{int(dim[3:]) + int(stacked)}={tail}"


def _check_params(J, got, want, to_ref, mesh, prefix=""):
    assert len(got) == len(to_ref)
    for name, pl in got.items():
        path, stacked = to_ref[name[len(prefix):]]
        spec = want[path]
        if stacked:
            assert spec[0] is None        # the scanned "layers" axis is never sharded
            spec = spec[1:]
        assert pl == sh.placements(spec, mesh), name


KINDS = ["params", "train", "cache_decode", "cache_long", "batch"]


@pytest.mark.parametrize("fake_mesh", ["single", "multi"], indirect=True)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_placements_match_reference(J, ref_specs, fake_mesh, arch, kind):
    mesh_kind = "multi" if "pod" in fake_mesh.mesh_dim_names else "single"
    stub = StubMesh(MESH_SHAPES[mesh_kind])
    jb, tb = J.configs.get_bundle(arch), get_bundle(arch)
    jcfg, tcfg = jb.model, tb.model
    key = J.jax.random.PRNGKey(0)
    rep_t, rep_j = sh.ShardingReport(), ref_specs.ShardingReport()
    to_ref = _to_ref(_meta_params(arch), tcfg.layer_period)
    if kind == "params":
        want = _flat_specs(J, ref_specs.param_shardings(jcfg, stub, jb.mesh, rep_j))
        got = sh.param_shardings(tcfg, fake_mesh, tb.mesh, rep_t)
        _check_params(J, got, want, to_ref, fake_mesh)
    elif kind == "train":
        abstract = J.jax.eval_shape(lambda k: J.train_loop.train_state_init(k, jcfg, jb), key)
        want = _flat_specs(J, ref_specs.train_state_shardings(jcfg, stub, jb.mesh, abstract,
                                                              rep_j))
        state = tspecs.train_state_abstract(tcfg, tb)
        got = sh.train_state_shardings(tcfg, fake_mesh, tb.mesh, state, rep_t)
        for field, ref_field in (("params.", "params"), ("opt.mu.", "mu"), ("opt.nu.", "nu")):
            part = {n: v for n, v in got.items() if n.startswith(field)}
            sub = {p[1:] if p[0] == ref_field else p[2:]: s for p, s in want.items()
                   if p[0] == ref_field or p[:2] == ("opt", ref_field)}
            _check_params(J, part, sub, to_ref, fake_mesh, field)
        ef = {n: v for n, v in got.items() if n.startswith("ef.")}
        assert len(ef) == sum(p[0] == "ef" for p in want)
        assert all(v == sh.replicated(fake_mesh) for v in ef.values())
        assert len(got) == 3 * len(to_ref) + len(ef)
    elif kind.startswith("cache"):
        shape = SHAPES["decode_32k" if kind == "cache_decode" else "long_500k"]
        b, length = shape.global_batch, tspecs.decode_cache_len(tcfg, shape)
        abstract = J.jax.eval_shape(lambda: J.model.init_decode_state(jcfg, b, length))
        want = _flat_specs(J, ref_specs.cache_shardings(jcfg, stub, jb.mesh, abstract, b,
                                                        rep_j))
        state = tm.init_decode_state(tcfg, b, length, device="meta")
        got = sh.cache_shardings(tcfg, fake_mesh, tb.mesh, state, b, rep_t)
        assert len(got) == 2 * tcfg.n_layers
        period = tcfg.layer_period
        for name, pl in got.items():
            _, i, leaf = name.split(".")
            spec = want[("cache", f"sub{int(i) % period}", leaf)]
            assert spec[0] is None
            assert pl == sh.placements(spec[1:], fake_mesh), name
        to_ref = {f"cache.{i}.{leaf}": (("cache", f"sub{i % period}", leaf), True)
                  for i in range(tcfg.n_layers) for leaf in state["cache"][i]}
    else:
        for shape_name in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
            shape = SHAPES[shape_name]
            if shape.kind == "decode":
                jb_abs = {"t": J.jax.ShapeDtypeStruct((shape.global_batch,), "int32")}
                tb_abs = {"t": torch.empty((shape.global_batch,), device="meta")}
            else:
                jb_abs = J.specs.batch_specs(jcfg, shape)
                tb_abs = tspecs.batch_specs(tcfg, shape)
            assert {k: tuple(v.shape) for k, v in tb_abs.items()} == \
                {k: tuple(v.shape) for k, v in jb_abs.items()}
            want = ref_specs.batch_shardings(jcfg, stub, jb.mesh, jb_abs)
            got = sh.batch_shardings(tcfg, fake_mesh, tb.mesh, tb_abs)
            assert got == {k: sh.placements(tuple(v), fake_mesh) for k, v in want.items()}
        # a long-context single row: the sequence dim goes over "data"
        row = {"tokens": (1, SHAPES["long_500k"].seq_len)}
        want = ref_specs.batch_shardings(
            jcfg, stub, jb.mesh, {k: J.jax.ShapeDtypeStruct(v, "int32") for k, v in row.items()},
            long_context=True)
        got = sh.batch_shardings(tcfg, fake_mesh, tb.mesh,
                                 {k: torch.empty(v, device="meta") for k, v in row.items()},
                                 long_context=True)
        assert got == {k: sh.placements(tuple(v), fake_mesh) for k, v in want.items()}
        assert got["tokens"][list(fake_mesh.mesh_dim_names).index("data")] == Shard(1)
    assert sorted({_ref_note(n, to_ref) for n in rep_t.fallbacks}) == \
        sorted(set(rep_j.fallbacks))


def test_long_cache_rewrite_falls_back_where_the_reference_does(ref_specs, J):
    """long_500k's batch 1: KV pages go over "data" (and "model" where kv
    heads cannot use it); jamba's and mamba2's conv tails take the same
    rewrite and fall back to replication, noted as the reference notes them."""
    with production_mesh() as mesh:
        cfg = get_bundle("jamba-1.5-large-398b").model
        shape = SHAPES["long_500k"]
        state = tm.init_decode_state(cfg, 1, tspecs.decode_cache_len(cfg, shape),
                                     device="meta")
        rep = sh.ShardingReport()
        got = sh.cache_shardings(cfg, mesh, get_bundle("jamba-1.5-large-398b").mesh, state,
                                 1, rep)
    attn = next(i for i in range(cfg.n_layers) if cfg.layer_kind(i) == "attn")
    # kv heads 8 on a 16-way model axis: the pages split over data x model
    assert got[f"cache.{attn}.k"] == (Shard(1), Shard(1))
    ssm_layers = [i for i in range(cfg.n_layers) if cfg.layer_kind(i) == "ssm"]
    assert rep.fallbacks == [f"cache.{i}.conv dim1=3 not divisible by ('data', 'model') "
                             "-> replicated" for i in ssm_layers]


# --------------------------------------------------------------------------
# the placed path on a one-rank gloo mesh
# --------------------------------------------------------------------------

def _full(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


@pytest.fixture(scope="module")
def granite_pair(J):
    """Reduced granite in fp32 with the reference's weights in both packages."""
    jcfg = dataclasses.replace(J.configs.get_reduced("granite-3-8b"), dtype="float32")
    tcfg = dataclasses.replace(get_reduced("granite-3-8b"), dtype="float32")
    jparams = J.model.init_params(J.jax.random.PRNGKey(3), jcfg)
    tparams = convert.from_jax_params(J.jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    toks = np.random.default_rng(4).integers(1, jcfg.vocab_size, (2, 12)).astype(np.int32)
    return jcfg, tcfg, jparams, tparams, toks


def test_placed_forward_matches_unplaced_and_jax(J, gloo_mesh, granite_pair):
    jcfg, tcfg, jparams, tparams, toks = granite_pair
    mcfg = get_bundle("granite-3-8b").mesh
    placed = sh.place(copy.deepcopy(tparams), gloo_mesh,
                      sh.param_shardings(tcfg, gloo_mesh, mcfg))
    assert all(isinstance(p, DTensor) for p in placed.parameters())
    tok = torch.from_numpy(toks).long()
    plain, _ = tm.forward(tparams, tok, tcfg)
    with sh.mesh_context(placed):
        got, _ = tm.forward(placed, tok, tcfg)
        constrain = sh.make_activation_constraint(gloo_mesh, mcfg, 2, 12)
        hooked, _ = tm.forward(placed, tok, tcfg, constrain=constrain)
        loss = tm.loss_fn(placed, {"tokens": tok, "labels": tok}, tcfg, constrain=constrain)
    assert torch.equal(_full(got), plain)
    assert torch.equal(_full(hooked), plain)
    assert torch.equal(_full(loss), tm.loss_fn(tparams, {"tokens": tok, "labels": tok}, tcfg))
    want, _ = J.model.forward(jparams, J.jax.numpy.asarray(toks), jcfg)
    np.testing.assert_allclose(_full(got).numpy(), np.asarray(want), atol=ATOL, rtol=1e-4)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_placed_serving_round_is_bit_equal(gloo_mesh, granite_pair, impl):
    """Prefill and decode steps on placed params, prompts and caches give
    the unplaced port's tokens and logits exactly (``impl="pallas"`` runs
    the kernel wrapper's plain version on the CPU, unwrapping whole
    DTensors)."""
    _, tcfg, _, tparams, toks = granite_pair
    mcfg = get_bundle("granite-3-8b").mesh
    placed = sh.place(copy.deepcopy(tparams), gloo_mesh,
                      sh.param_shardings(tcfg, gloo_mesh, mcfg))
    prefill_step, serve_step = make_prefill_step(tcfg, 16, impl=impl), make_serve_step(tcfg)

    def run(params, tokens, mesh=None):
        tok, state = prefill_step(params, tokens)
        if mesh is not None:
            state = sh.place(state, mesh, sh.cache_shardings(tcfg, mesh, mcfg, state, 2))
            assert all(isinstance(c[k], DTensor) for c in state["cache"] for k in c)
        out = [tok]
        for _ in range(4):
            tok, logits, state = serve_step(params, state, tok)
            out += [tok, logits]
        return [_full(t) for t in out]

    tokens = torch.from_numpy(toks).long()
    batch = {"tokens": tokens}
    placed_tokens = sh.place(batch, gloo_mesh, sh.batch_shardings(tcfg, gloo_mesh, mcfg,
                                                                  batch))["tokens"]
    for a, b in zip(run(placed, placed_tokens, gloo_mesh), run(tparams, tokens)):
        assert torch.equal(a, b)


def test_reshard_restore_places_the_state_on_the_mesh(gloo_mesh):
    """``shardings=(mesh, placements)``: every tensor of the restored train
    state becomes a DTensor on the mesh with its placements from
    ``train_state_shardings``."""
    from repro_torch.configs import ArchBundle, TrainConfig
    from repro_torch.runtime.train_loop import train_state_init

    cfg = dataclasses.replace(get_reduced("granite-3-8b"), n_layers=1)
    bundle = ArchBundle(model=cfg, train=TrainConfig())
    st = train_state_init(0, cfg, bundle, device="cpu")
    want = {n: t.clone() for n, t in sh.named_tensors(st)}

    class _Full:
        def restore_latest(self, state_like):
            return 3, state_like, {}

    pl = sh.train_state_shardings(cfg, gloo_mesh, bundle.mesh, st)
    step, got = elastic.reshard_restore(_Full(), st, (gloo_mesh, pl))
    assert step == 3 and got.step == st.step
    placed = dict(sh.named_tensors(got))
    assert set(placed) == set(pl) == set(want)
    for name, t in placed.items():
        assert isinstance(t, DTensor) and t.placements == pl[name], name
        assert torch.equal(t.full_tensor(), want[name])


def test_constrain_hooks_are_fed_where_the_reference_feeds_them():
    """A recording hook sees the reference's kinds at its points: the
    residual at each layer group's end (and the embeddings), the hidden
    states, the logits, jamba's MoE dispatch buffers and, in the chunk loop
    of long sequences, the SSD state; an identity hook changes nothing."""
    from repro_torch.models import ssm

    cfg = dataclasses.replace(get_reduced("jamba-1.5-large-398b"), dtype="float32")
    params = tm.init_params(cfg, 2, device="cpu")
    tok = torch.from_numpy(np.random.default_rng(6).integers(1, cfg.vocab_size, (2, 8))).long()
    seen = []

    def hook(h, kind="residual"):
        seen.append((kind, tuple(h.shape)))
        return h

    want, want_aux = tm.forward(params, tok, cfg)
    got, aux = tm.forward(params, tok, cfg, constrain=hook)
    assert torch.equal(got, want) and torch.equal(aux, want_aux)
    groups = cfg.n_layers // cfg.layer_period
    moe_layers = sum(cfg.layer_is_moe(i) for i in range(cfg.n_layers))
    kinds = [k for k, _ in seen]
    assert kinds.count("residual") == 1 + groups
    assert kinds.count("moe_buffer") == 2 * moe_layers
    assert kinds[-2:] == ["hidden", "logits"]
    assert seen[-1][1] == tuple(want.shape)
    g = torch.Generator().manual_seed(7)
    x, dt = torch.randn(1, 4096, 2, 4, generator=g), torch.rand(1, 4096, 2, generator=g)
    B, C = torch.randn(1, 4096, 1, 4, generator=g), torch.randn(1, 4096, 1, 4, generator=g)
    seen.clear()
    y, state = ssm.ssd_chunked(x, dt, torch.zeros(2), B, C, 256, constrain=hook)
    assert seen == [("ssm_state", (1, 2, 4, 4))] * 16
    y0, state0 = ssm.ssd_chunked(x, dt, torch.zeros(2), B, C, 256)
    assert torch.equal(y, y0) and torch.equal(state, state0)


def test_constraint_kinds_place_as_the_reference_specs():
    """Each kind's placements on the (16, 16) mesh, the checked dims
    falling back to batch-only where "model" does not divide them."""
    mcfg = dataclasses.replace(get_bundle("granite-3-8b").mesh, sequence_parallel=True)
    with production_mesh() as mesh:
        constrain = sh.make_activation_constraint(mesh, mcfg, 32, 64)

        def placed(shape, kind):
            h = DTensor.from_local(torch.zeros(shape), mesh, [Replicate(), Replicate()],
                                   run_check=False)
            return constrain(h, kind).placements

        assert placed((32, 64, 8), "residual") == (Shard(0), Shard(1))
        assert placed((32, 64, 8), "hidden") == (Shard(0), Replicate())
        assert placed((32, 64, 32), "logits") == (Shard(0), Shard(2))
        assert placed((32, 64, 8), "logits") == (Shard(0), Replicate())     # 8 % 16
        assert placed((32, 16, 4, 8), "moe_buffer") == (Shard(0), Shard(1))
        assert placed((32, 8, 4, 8), "ssm_state") == (Shard(0), Replicate())
    assert not dist.is_initialized()


def test_constraint_refuses_a_plain_tensor_on_many_ranks():
    mcfg = get_bundle("granite-3-8b").mesh
    with production_mesh() as mesh:
        assert sh.make_activation_constraint(mesh, mcfg, 15, 64) is None   # 15 % 16
        constrain = sh.make_activation_constraint(mesh, mcfg, 32, 64)
        with pytest.raises(ValueError, match="plain tensor"):
            constrain(torch.zeros(32, 64, 8))


def test_kernel_wrappers_unwrap_only_whole_shards():
    """A DTensor whose local shard is the whole tensor goes to the kernel's
    (here plain) version and comes back replicated; a shard is refused."""
    g = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(1, 8, 2, 16, generator=g) for _ in range(3))
    want = ops.flash_attention(q, k, v)
    with production_mesh() as mesh:
        split = [DTensor.from_local(t, mesh, [Shard(2), Replicate()], run_check=False)
                 for t in (q, k, v)]
        with pytest.raises(ValueError, match="not whole"):
            ops.flash_attention(*split)
        with pytest.raises(ValueError, match="not whole"):
            ops.skewed_bucket(DTensor.from_local(torch.arange(8), mesh,
                                                 [Shard(0), Replicate()], run_check=False),
                              torch.tensor([1.0, 1.0]))
    with host_mesh("cpu") as mesh:
        whole = [DTensor.from_local(t, mesh, [Shard(0), Shard(2)], run_check=False)
                 for t in (q, k, v)]
        got = ops.flash_attention(*whole)
        assert isinstance(got, DTensor) and got.placements == (Replicate(), Replicate())
        assert torch.equal(got.to_local(), want)


@pytest.mark.gpu
def test_placed_granite_through_the_flash_kernel_on_the_card():
    """Reduced granite in bf16 on a (1, 1) NCCL mesh: prefill through the
    flash kernel (wgmma) and decode on placed params equal the unplaced
    run bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels import flash_attention as fa

    cfg = get_reduced("granite-3-8b")
    mcfg = get_bundle("granite-3-8b").mesh
    dev = torch.device("cuda")
    params = tm.init_params(cfg, 0, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    prefill_step, serve_step = make_prefill_step(cfg, 72, impl="pallas"), make_serve_step(cfg)

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
        before = fa.launches_by_route["wgmma"]
        got = run(placed, mesh)
        assert fa.launches_by_route["wgmma"] - before == cfg.n_layers
    assert not dist.is_initialized()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
