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
