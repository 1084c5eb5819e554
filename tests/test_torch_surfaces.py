"""The reference's last pure-Python pieces in the port, against the JAX
package: ``configs/shapes.py`` (and its re-export from ``repro_torch.configs``),
``launch/cluster.py`` (the paper's Fig 6 offer loop), ``optim.compression.wire_bytes``
and the ``repro_torch.core`` package surface. The copies are verbatim apart
from their imports, and each is held to the original by a twin."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.launch.cluster import ClusterState, SliceInfo
from repro_torch.optim.compression import wire_bytes

torch.set_num_threads(2)

ROOT = os.path.join(os.path.dirname(__file__), "..", "src")
COPIES = ["configs/shapes.py", "configs/dbrx_132b.py", "configs/jamba_1_5_large_398b.py",
          "launch/cluster.py"]


@pytest.mark.parametrize("path", COPIES)
def test_copies_are_verbatim_apart_from_imports(path):
    with open(os.path.join(ROOT, "repro", path)) as f:
        want = f.read().replace("from repro.", "from repro_torch.")
    with open(os.path.join(ROOT, "repro_torch", path)) as f:
        assert f.read() == want


def test_shapes_match_the_reference_for_every_arch():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert list(tconfigs.SHAPES) == list(jconfigs.SHAPES)
    for name, shape in jconfigs.SHAPES.items():
        assert dataclasses.astuple(tconfigs.SHAPES[name]) == dataclasses.astuple(shape)
    assert [s.name for s in tconfigs.ALL_SHAPES] == [s.name for s in jconfigs.ALL_SHAPES]
    for const in ("TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K"):
        assert dataclasses.astuple(getattr(tconfigs, const)) == \
            dataclasses.astuple(getattr(jconfigs, const))
    for arch in jconfigs.ARCH_IDS:
        tcfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg), arch
        for name in jconfigs.SHAPES:
            assert tconfigs.shape_skip_reason(tcfg, tconfigs.SHAPES[name]) == \
                jconfigs.shape_skip_reason(jcfg, jconfigs.SHAPES[name]), (arch, name)
        assert [s.name for s in tconfigs.applicable_shapes(tcfg)] == \
            [s.name for s in jconfigs.applicable_shapes(jcfg)]
    # the sub-quadratic archs (local windows or SSM layers) keep long_500k,
    # the others skip it
    keep = {a for a in tconfigs.ARCH_IDS
            if "long_500k" in [s.name for s in tconfigs.applicable_shapes(tconfigs.get_config(a))]}
    assert keep == {"gemma3-12b", "jamba-1.5-large-398b", "mamba2-2.7b"}


def test_registry_surface_matches_the_reference():
    assert tconfigs.all_bundles().keys() == jconfigs.all_bundles().keys()
    for arch, bundle in tconfigs.all_bundles().items():
        assert dataclasses.asdict(bundle.mesh) == dataclasses.asdict(jconfigs.get_bundle(arch).mesh)
    with pytest.raises(KeyError) as got:
        tconfigs.get_config("llama-0b")
    with pytest.raises(KeyError) as want:
        jconfigs.get_config("llama-0b")
    assert str(got.value) == str(want.value)


def test_cluster_state_offer_report_cycle():
    """Twin of tests/test_integration_extra.py::test_cluster_state_offer_report_cycle:
    offers carry speed estimates; missed heartbeats remove slices from
    offers."""
    cs = ClusterState([SliceInfo("s0", 256), SliceInfo("s1", 256)],
                      heartbeat_timeout=2.0)
    cs.report("s0", grains_done=8, elapsed=1.0, now=1.0)
    cs.report("s1", grains_done=8, elapsed=2.0, now=1.0)
    offer = cs.offers()
    speeds = {s.name: s.speed for s in offer.slices}
    assert speeds["s0"] == pytest.approx(8.0)
    assert speeds["s1"] == pytest.approx(4.0)
    cs.report("s0", grains_done=8, elapsed=1.0, now=4.0)
    assert cs.check() == ["s1"]
    assert [s.name for s in cs.offers().slices] == ["s0"]
    cs.remove_slice("s1")
    cs.add_slice(SliceInfo("s2", 256, preemptible=True))
    assert "s2" in {s.name for s in cs.offers().slices}


def test_cluster_state_follows_the_reference_step_for_step():
    """The same reports, checks and fleet changes through both packages:
    equal offers (names, speeds, clock) and dead lists at every step."""
    from repro.launch.cluster import ClusterState as JState
    from repro.launch.cluster import SliceInfo as JInfo

    names = ["a", "b", "c"]
    t = ClusterState([SliceInfo(n, 4, preemptible=n == "c") for n in names],
                     alpha=0.25, heartbeat_timeout=3.0)
    j = JState([JInfo(n, 4, preemptible=n == "c") for n in names], alpha=0.25,
               heartbeat_timeout=3.0)
    rng = np.random.default_rng(0)
    for step in range(12):
        for n in names[: 3 if step < 6 else 2]:       # c falls silent at step 6
            done, el = int(rng.integers(0, 9)), float(rng.uniform(0.5, 2.0))
            t.report(n, done, el, now=float(step))
            j.report(n, done, el, now=float(step))
        assert t.check() == j.check()
        to, jo = t.offers(), j.offers()
        assert to.at == jo.at
        assert [dataclasses.astuple(s) for s in to.slices] == \
            [dataclasses.astuple(s) for s in jo.slices]
        if step == 8:
            for c in (t, j):
                c.remove_slice("c")
            t.add_slice(SliceInfo("d", 2))
            j.add_slice(JInfo("d", 2))


@pytest.mark.parametrize("arch", ["granite-3-8b", "jamba-1.5-large-398b"])
@pytest.mark.parametrize("scheme", ["none", "int8", "topk"])
def test_wire_bytes_match_the_reference(arch, scheme):
    """On the same params: the reference counts its stacked tree, the port
    its per-layer tensors grouped by the reference's leaves (for int8, one
    4-byte scale per leaf: jamba's period-8 stack is the case where
    counting the port's tensors would be off)."""
    from repro.models import model as jm
    from repro.optim.compression import wire_bytes as j_wire_bytes

    jcfg, tcfg = jconfigs.get_reduced(arch), tconfigs.get_reduced(arch)
    jparams = jm.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = convert.from_jax_params(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    want = j_wire_bytes(jparams, scheme)
    assert wire_bytes(tparams, scheme, period=tcfg.layer_period) == want
    assert wire_bytes(dict(tparams.named_parameters()), scheme,
                      period=tcfg.layer_period) == want
    if scheme == "int8" and tcfg.layer_period > 1:
        assert wire_bytes(tparams, scheme) != want      # ungrouped counts every layer


def test_wire_bytes_ordering():
    """Twin of tests/test_runtime.py::test_wire_bytes_ordering."""
    g = {"w": torch.zeros((1000,), dtype=torch.float32)}
    assert wire_bytes(g, "topk", 0.01) < wire_bytes(g, "int8") < wire_bytes(g, "none")
    with pytest.raises(ValueError):
        wire_bytes(g, "fp4")


def test_core_exports_the_references_names():
    import repro.core as jcore
    import repro_torch.core as tcore

    def public(mod):
        return {n for n in vars(mod) if not n.startswith("_")
                and not isinstance(getattr(mod, n), type(os))}

    want = (public(jcore) - {"bucket_of_jnp"}) | {"bucket_of_torch"}
    assert public(tcore) == want
    caps = tcore.integer_capacities([1.0, 0.4], 997)
    h = np.arange(-50, 5000, 7, dtype=np.int32)
    np.testing.assert_array_equal(tcore.bucket_of_torch(torch.from_numpy(h),
                                                          torch.from_numpy(caps)).numpy(),
                                  np.asarray(jcore.bucket_of_jnp(jnp.asarray(h), caps)))


# --------------------------------------------------------------------------
# the reference's last top-level names, and completeness
# --------------------------------------------------------------------------

def test_layernorm_matches_the_reference():
    """fp32 and bf16 inputs, the reference's init and random scale/bias."""
    from repro.models import layers as jl
    from repro_torch.models import layers as tl

    rng = np.random.default_rng(11)
    d = 48
    jp, tp = jl.layernorm_init(d), tl.layernorm_init(d, device="cpu")
    assert sorted(tp.keys()) == sorted(jp) and all(not p.requires_grad for p in tp.values())
    for k in jp:
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
    params = {k: rng.standard_normal(d).astype(np.float32) for k in ("scale", "bias")}
    x = (rng.standard_normal((3, 5, d)) * 2.0 + 0.5).astype(np.float32)
    got = tl.layernorm({k: torch.from_numpy(v) for k, v in params.items()}, torch.from_numpy(x))
    want = jl.layernorm({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    gb = tl.layernorm(tp, torch.from_numpy(x).to(torch.bfloat16), eps=1e-6)
    wb = jl.layernorm(jp, jnp.asarray(x, jnp.bfloat16), eps=1e-6)
    assert gb.dtype == torch.bfloat16
    np.testing.assert_allclose(gb.float().numpy(), np.asarray(wb, np.float32), atol=2e-2)


def test_constant_schedule_matches_the_reference():
    from repro.optim import schedule as js
    from repro_torch.optim import schedule as ts

    for step in (0, 7, torch.tensor(3)):
        got = ts.constant(step, lr=3e-4)
        want = js.constant(jnp.asarray(int(step)), lr=3e-4)
        assert got.dtype == torch.float32 and got.shape == ()
        assert float(got) == float(want)


def test_replica_state_matches_the_reference():
    from repro.runtime.serve_loop import ReplicaState as JReplicaState
    from repro_torch.runtime.serve_loop import ReplicaState

    def fields(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert fields(ReplicaState) == fields(JReplicaState)
    r = ReplicaState("rep0")
    r.active += 2
    assert dataclasses.astuple(r) == dataclasses.astuple(JReplicaState("rep0", active=2))


def _top_level_names(path):
    """Top-level defs, classes and assignments to names of a module."""
    import ast

    with open(path) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            for target in (node.targets if isinstance(node, ast.Assign) else [node.target]):
                elts = target.elts if isinstance(target, (ast.Tuple, ast.List)) else [target]
                out.update(e.id for e in elts if isinstance(e, ast.Name))
    return out


# reference modules whose port has another name
RENAMED_MODULES = {"launch/hlo_cost.py": "launch/op_cost.py"}
# the op_cost module counts FLOPs on meta tensors where hlo_cost parses
# XLA's HLO text: none of hlo_cost's names has a meaning there
NO_NAMEWISE_COUNTERPART = {"launch/hlo_cost.py"}
PYTREE = "a JAX pytree type alias; the port's trees are modules and dicts"
# (reference module, name) -> the port's counterpart in the same module
# ("module:name" where it lives elsewhere), or why there is none
NAME_EXCEPTIONS = {
    **{(m, "Pytree"): PYTREE for m in ("models/model.py", "models/transformer.py",
                                       "optim/adamw.py", "optim/compression.py",
                                       "runtime/serve_loop.py", "runtime/train_loop.py")},
    ("kernels/flash_attention.py", "_attn_kernel"): "the Pallas body; csrc/flash_attention.cu",
    ("kernels/ssd_scan.py", "_ssd_kernel"): "the Pallas body; csrc/ssd_scan.cu",
    ("kernels/skewed_bucket.py", "_bucket_kernel"): "the Pallas body; csrc/skewed_bucket.cu",
    ("kernels/flash_attention.py", "_round_up"): "pads to Pallas blocks; the CUDA kernel "
                                                 "takes ragged lengths",
    ("kernels/skewed_bucket.py", "_round_up"): "pads to Pallas blocks; the CUDA kernel "
                                               "takes ragged lengths",
    ("kernels/skewed_bucket.py", "_is_static"): "tells traced jnp capacities from static "
                                                "ones; torch runs eagerly",
    ("kernels/ops.py", "_interpret_default"): "Pallas interpret mode; a wrapper takes the "
                                              "plain version on CPU tensors",
    ("kernels/flash_attention.py", "NEG_INF"): "kernels/ref.py:NEG_INF",
    ("core/batched.py", "pull_scan_jax"): "pull_scan_torch",
    ("core/skewed_hash.py", "bucket_of_jnp"): "bucket_of_torch",
    ("launch/specs.py", "_sds"): "jax.ShapeDtypeStruct; the port's specs are meta tensors",
    ("launch/dryrun.py", "_mem_dict"): "XLA's memory_analysis; the port sums placed bytes",
    ("checkpoint/checkpointer.py", "_flatten"): "jax tree paths; the port walks its "
                                                "trees in _entries",
    ("checkpoint/checkpointer.py", "_path_str"): "jax tree path entries",
    ("runtime/train_loop.py", "_loss_with_aux"): "jax.value_and_grad's target; "
                                                 "value_and_grad calls loss_fn",
    ("models/transformer.py", "_layer_axes"): "layer_axes",
    ("models/model.py", "_sin_row"): "models/layers.py:_sinusoids",
    ("analysis/rules/hl005_tracer_safety.py", "_decorator_static_argnames"):
        "jit's static_argnames; torch's tracing entries take none",
}


def _port_has(module, counterpart):
    """``counterpart`` ("name", or "module:name") is a top-level name of the port."""
    path, _, name = counterpart.rpartition(":")
    return name in _top_level_names(os.path.join(ROOT, "repro_torch", path or module))


def test_every_reference_name_has_a_counterpart_in_the_port():
    """An AST walk of both packages: each top-level name of a module of
    ``src/repro/`` is in the port's module of the same path, or in
    ``NAME_EXCEPTIONS`` with its counterpart or its reason. A name added
    to the reference without a port fails here, as does an exception the
    port no longer needs."""
    ref_root = os.path.join(ROOT, "repro")
    missing, stale, used = [], [], set()
    for dirpath, _, files in os.walk(ref_root):
        for fname in sorted(files):
            if not fname.endswith(".py"):
                continue
            module = os.path.relpath(os.path.join(dirpath, fname), ref_root).replace(os.sep, "/")
            port_path = os.path.join(ROOT, "repro_torch", RENAMED_MODULES.get(module, module))
            assert os.path.exists(port_path), f"no counterpart of {module}"
            if module in NO_NAMEWISE_COUNTERPART:
                continue
            have = _top_level_names(port_path)
            for name in sorted(_top_level_names(os.path.join(dirpath, fname)) - have):
                key = (module, name)
                if key not in NAME_EXCEPTIONS:
                    missing.append(f"{module}:{name}")
                    continue
                used.add(key)
                counterpart = NAME_EXCEPTIONS[key]
                if " " not in counterpart and not _port_has(module, counterpart):
                    stale.append(f"{module}:{name} -> {counterpart}")
    assert missing == [], f"reference names without a port: {missing}"
    assert stale == [], f"counterparts not found: {stale}"
    assert sorted(set(NAME_EXCEPTIONS) - used) == [], "exceptions the port no longer needs"
