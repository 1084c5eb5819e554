"""The port's launch tools against the reference's, on the CPU.

``launch/specs.py``'s meta-device stand-ins against the reference's
``jax.eval_shape`` trees for every (arch x shape) cell, in shape and dtype;
``launch/op_cost.py``'s FLOP count against ``launch/hlo_cost.parse_hlo``
over the compiled reference for reduced prefill and decode steps of every
arch, exactly, and its two shortcuts (dense paths, layer groups) against
the plain count; ``launch/roofline.py`` and ``launch/report.py`` as twins
of the reference's with the H100's constants swapped in; the dry-run on a
few cells of both meshes; and every new or changed port module imported
first in a fresh interpreter, touching no process group and no
``XLA_FLAGS``. The reference's ``launch/dryrun.py`` is never imported: it
sets ``XLA_FLAGS`` for its whole process.
"""
import dataclasses
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_bundle as j_get_bundle
from repro.configs import get_reduced as j_get_reduced
from repro.launch import report as j_report
from repro.launch import roofline as j_roofline
from repro.launch import specs as j_specs
from repro.launch.hlo_cost import parse_hlo
from repro.models import model as jm
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, get_bundle, get_reduced
from repro_torch.configs.shapes import ALL_SHAPES, SHAPES, shape_skip_reason
from repro_torch.launch import dryrun, op_cost, report, roofline
from repro_torch.launch import specs as t_specs
from repro_torch.launch.mesh import host_mesh, production_mesh
from repro_torch.models import model as tm
from repro_torch.models.frontends import frontend_feature_dim
from repro_torch.runtime import sharding as sh

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
B, S, MAX_LEN = 2, 64, 80


def _dtype(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).split(".")[1]
    return jnp.dtype(x.dtype).name


def _sig(x):
    return tuple(x.shape), _dtype(x)


def _params_match(tparams, jtree, cfg):
    """Every port parameter is its reference leaf (a stacked leaf: one entry
    of its leading layer-group axis) in shape and dtype."""
    flat = {tuple(str(k.key) for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(jtree)[0]}
    named = dict(tparams.named_parameters()) if isinstance(tparams, torch.nn.Module) \
        else tparams
    paths = convert.reference_paths(tm.init_params(cfg, device="meta"), cfg.layer_period)
    assert set(paths) == set(flat)
    for path, names in paths.items():
        want = flat[path]
        shape = want.shape[1:] if convert.is_stacked(path) else want.shape
        if convert.is_stacked(path):
            assert want.shape[0] == len(names)
        for n in names:
            assert _sig(named[n]) == (tuple(shape), _dtype(want)), n


@pytest.mark.parametrize("shape_name", [s.name for s in ALL_SHAPES])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_meta_specs_match_reference(arch, shape_name):
    tb, jb = get_bundle(arch), j_get_bundle(arch)
    cfg, shape = tb.model, SHAPES[shape_name]
    got = t_specs.input_specs(cfg, tb, shape)
    want = j_specs.input_specs(jb.model, jb, _jshape(shape_name))
    assert set(got) == set(want)
    for t in jax.tree_util.tree_leaves(got, is_leaf=lambda x: isinstance(x, torch.Tensor)):
        assert not isinstance(t, torch.Tensor) or t.device.type == "meta"
    if shape.kind == "train":
        st, jst = got["state"], want["state"]
        _params_match(st.params, jst.params, cfg)
        _params_match(st.opt.mu, jst.opt.mu, cfg)
        _params_match(st.opt.nu, jst.opt.nu, cfg)
        assert st.step == 0 and jst.step.shape == ()
        assert len(st.ef) == len(jax.tree_util.tree_leaves(jst.ef))
    else:
        _params_match(got["params"], want["params"], cfg)
    if shape.kind == "decode":
        assert t_specs.decode_cache_len(cfg, shape) == j_specs.decode_cache_len(jb.model,
                                                                                _jshape(shape_name))
        period = cfg.layer_period
        for i, layer in enumerate(got["dstate"]["cache"]):
            for leaf, t in layer.items():
                ref = want["dstate"]["cache"][f"sub{i % period}"][leaf]
                assert _sig(t) == (tuple(ref.shape[1:]), _dtype(ref)), (i, leaf)
        assert _sig(got["token"]) == _sig(want["token"])
        assert (got["enc_out"] is None) == (want["enc_out"] is None)
        if got["enc_out"] is not None:
            assert _sig(got["enc_out"]) == _sig(want["enc_out"])
    else:
        assert {k: _sig(v) for k, v in got["batch"].items()} == \
            {k: _sig(v) for k, v in want["batch"].items()}


def _jshape(name):
    from repro.configs.shapes import SHAPES as J_SHAPES
    return J_SHAPES[name]


# --------------------------------------------------------------------------
# FLOPs against the reference's HLO count
# --------------------------------------------------------------------------

def _step_inputs(arch):
    """Abstract inputs of a reduced prefill/decode step in both packages."""
    jc, tc = j_get_reduced(arch), get_reduced(arch)
    jkw, tkw = {}, {}
    jtok = jax.ShapeDtypeStruct((B, S), jnp.int32)
    ttok = torch.empty((B, S), dtype=torch.int32, device="meta")
    feat = frontend_feature_dim(tc) if tc.frontend != "none" else 0
    if tc.frontend == "vision":
        jkw["input_embeds"] = jax.ShapeDtypeStruct((B, S, feat), jnp.float32)
        tkw["input_embeds"] = torch.empty((B, S, feat), device="meta")
        jtok = ttok = None
    if tc.encoder_layers:
        jkw["enc_feats"] = jax.ShapeDtypeStruct((B, tc.max_source_positions, feat), jnp.float32)
        tkw["enc_feats"] = torch.empty((B, tc.max_source_positions, feat), device="meta")
    return jc, tc, jtok, ttok, jkw, tkw


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_op_cost_flops_equal_hlo_flops(arch, kind):
    """The FLOPs ``FlopCounterMode`` counts over the port's meta step equal
    the reference's loop-adjusted HLO dot FLOPs of the compiled step, at
    (2, 64) prompts and an 80-slot cache."""
    jc, tc, jtok, ttok, jkw, tkw = _step_inputs(arch)
    jparams = jax.eval_shape(lambda k: jm.init_params(k, jc), jax.random.PRNGKey(0))
    tparams = tm.init_params(tc, device="meta")
    with torch.no_grad():
        if kind == "prefill":
            compiled = jax.jit(lambda p, t, kw: jm.prefill(p, t, jc, MAX_LEN, **kw)).lower(
                jparams, jtok, jkw).compile()
            _, got = op_cost.count_flops(tm.prefill, tparams, ttok, tc, MAX_LEN, **tkw)
        else:
            jstate = jax.eval_shape(lambda: jm.init_decode_state(jc, B, MAX_LEN))
            tstate = tm.init_decode_state(tc, B, MAX_LEN, device="meta")
            jenc = tenc = None
            if tc.encoder_layers:
                dt = tm._dtype(tc)
                jenc = jax.ShapeDtypeStruct((B, tc.max_source_positions, tc.d_model),
                                            jnp.dtype(str(dt).split(".")[1]))
                tenc = torch.empty((B, tc.max_source_positions, tc.d_model), dtype=dt,
                                   device="meta")
            compiled = jax.jit(lambda p, s, t, e: jm.decode_step(p, s, t, jc, enc_out=e)).lower(
                jparams, jstate, jax.ShapeDtypeStruct((B,), jnp.int32), jenc).compile()
            _, got = op_cost.count_flops(tm.decode_step, tparams, tstate,
                                         torch.empty((B,), dtype=torch.int32, device="meta"),
                                         tc, enc_out=tenc)
    want = parse_hlo(compiled.as_text()).flops
    assert got > 0 and got == want


@pytest.mark.parametrize("arch,kind", [("granite-3-8b", "prefill"), ("mamba2-2.7b", "prefill"),
                                       ("jamba-1.5-large-398b", "train"),
                                       ("whisper-medium", "prefill"),
                                       ("gemma3-12b", "decode")])
def test_count_by_groups_is_the_full_count(arch, kind):
    """Counting one and two layer groups and extending linearly gives the
    count of the whole stack (three groups; whisper also three encoder
    layers), train steps' remat and backward included."""
    cfg = get_reduced(arch)
    cfg = dataclasses.replace(cfg, n_layers=3 * cfg.layer_period,
                              encoder_layers=3 if cfg.encoder_layers else 0)
    bundle = get_bundle(arch).replace(model=cfg)
    shape = ShapeCell(kind)
    full = op_cost.count_flops(shape.run, bundle)[1]
    by_groups = op_cost.count_by_groups(
        lambda c: op_cost.count_flops(shape.run, bundle.replace(model=c))[1], cfg)
    assert by_groups == full > 0


class ShapeCell:
    """A small step of ``kind`` over a reduced bundle, on meta tensors."""

    def __init__(self, kind, seq=32):
        self.kind, self.seq = kind, seq

    def run(self, bundle):
        cfg = bundle.model
        b = 2
        feat = frontend_feature_dim(cfg) if cfg.frontend != "none" else 0
        enc = torch.empty((b, cfg.max_source_positions, feat), device="meta") \
            if cfg.encoder_layers else None
        if self.kind == "decode":
            params = tm.init_params(cfg, device="meta")
            state = tm.init_decode_state(cfg, b, self.seq, device="meta")
            enc_out = None if enc is None else torch.empty(
                (b, cfg.max_source_positions, cfg.d_model), dtype=tm._dtype(cfg), device="meta")
            with torch.no_grad():
                return tm.decode_step(params, state, torch.empty((b,), dtype=torch.int32,
                                                                 device="meta"), cfg,
                                      enc_out=enc_out)
        tok = torch.empty((b, self.seq), dtype=torch.int32, device="meta")
        if self.kind == "prefill":
            with torch.no_grad():
                return tm.prefill(tm.init_params(cfg, device="meta"), tok, cfg, self.seq,
                                  enc_feats=enc)
        from repro_torch.runtime.train_loop import train_state_init, value_and_grad
        st = train_state_init(0, cfg, bundle, device="meta")
        batch = {"tokens": tok, "labels": tok}
        if enc is not None:
            batch["enc_feats"] = enc
        return value_and_grad(st.params, batch, cfg, "xla", bundle.mesh.remat)


@pytest.mark.parametrize("arch", ["granite-3-8b", "mamba2-2.7b"])
def test_dense_paths_count_the_block_products(arch):
    """Without a gradient, the batched attention and SSD math do the same
    products as the block loops at a sequence length that is a multiple of
    the blocks (4096: chunked attention's 512/1024 and the SSD scan's
    chunks)."""
    bundle = get_bundle(arch).replace(model=dataclasses.replace(get_reduced(arch), n_layers=1))
    cell = ShapeCell("prefill", seq=4096)
    blocks = op_cost.count_flops(cell.run, bundle)[1]
    with op_cost.dense_paths():
        dense = op_cost.count_flops(cell.run, bundle)[1]
    assert dense == blocks > 0


# --------------------------------------------------------------------------
# roofline and report twins
# --------------------------------------------------------------------------

H100 = {"PEAK_FLOPS": roofline.PEAK_FLOPS, "HBM_BW": roofline.HBM_BW,
        "ICI_BW": roofline.ICI_BW, "DCN_BW": roofline.DCN_BW}


@pytest.mark.parametrize("flops,nbytes,ici,dcn", [
    (1e15, 1e9, 1e9, 0.0), (1e12, 5e11, 2e9, 1e8), (3e9, 1e6, 9e11, 5e10), (0.0, 1e9, 0.0, 0.0)])
@pytest.mark.parametrize("arch", ["granite-3-8b", "jamba-1.5-large-398b"])
@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k", "decode_32k"])
def test_roofline_is_the_reference_with_h100_constants(monkeypatch, arch, shape_name,
                                                       flops, nbytes, ici, dcn):
    for name, value in H100.items():
        monkeypatch.setattr(j_roofline, name, value)
    want = j_roofline.compute_roofline(
        j_get_bundle(arch).model, _jshape(shape_name), n_chips=256, hlo_flops=flops,
        hlo_bytes=nbytes, ici_bytes=ici, dcn_bytes=dcn)
    got = roofline.compute_roofline(
        get_bundle(arch).model, SHAPES[shape_name], n_chips=256, flops=flops,
        bytes_accessed=nbytes, ici_bytes=ici, dcn_bytes=dcn)
    w, g = want.as_dict(), got.as_dict()
    w["flops_per_dev"] = w.pop("hlo_flops_per_dev")
    assert g == w
    if want.bottleneck != "collective":
        assert roofline.improvement_hint(got) == j_roofline.improvement_hint(want)
    # collective bytes not measured: no collective term, no guess
    blind = roofline.compute_roofline(
        get_bundle(arch).model, SHAPES[shape_name], n_chips=256, flops=flops,
        bytes_accessed=nbytes, ici_bytes=None, dcn_bytes=None)
    assert blind.collective_s is None and blind.dcn_s is None
    assert blind.bottleneck == ("compute" if got.compute_s >= got.memory_s else "memory")


def test_roofline_constants_are_the_h100_data_sheet():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW) == (989e12, 3.35e12)
    assert roofline.PEAK_FLOPS != j_roofline.PEAK_FLOPS


def _records(tmp_path):
    cells = [("granite-3-8b", "decode_32k"), ("granite-3-8b", "long_500k"),
             ("mamba2-2.7b", "long_500k"), ("granite-moe-1b-a400m", "prefill_32k"),
             ("whisper-medium", "decode_32k")]
    out = str(tmp_path / "dry")
    recs = [dryrun.run_cell(a, s, m, out, echo=False) for a, s in cells
            for m in ("single", "multi")]
    return recs, out


@pytest.fixture(scope="module")
def dry(tmp_path_factory):
    before = os.environ.get("XLA_FLAGS")
    recs, out = _records(tmp_path_factory.mktemp("dryrun"))
    assert os.environ.get("XLA_FLAGS") == before
    assert not dist.is_initialized()
    return recs, out


def test_dryrun_cells(dry):
    """An attention, an SSM, an MoE and an encoder-decoder arch on both
    meshes: ok with the per-device argument bytes of their placements, the
    step's FLOPs, the roofline's compute and memory terms, the collective
    term not measured; granite's long_500k skipped with the reference's
    reason."""
    recs, out = dry
    by = {(r["arch"], r["shape"], r["mesh"]): r for r in recs}
    skipped = by[("granite-3-8b", "long_500k", "single")]
    assert skipped["status"] == "skipped"
    assert skipped["reason"] == shape_skip_reason(get_bundle("granite-3-8b").model,
                                                  SHAPES["long_500k"])
    for (arch, shape_name, mesh), r in by.items():
        if r["status"] == "skipped":
            continue
        assert r["status"] == "ok", r.get("error")
        n = 512 if mesh == "multi" else 256
        assert r["n_chips"] == n
        oc = r["op_cost"]
        assert oc["flops_per_device"] == oc["flops"] / n and oc["flops"] > 0
        assert all(oc[k] is None for k in op_cost.NOT_MEASURED)
        assert r["memory_analysis"]["argument_size_in_bytes"] == \
            sum(r["argument_bytes_by_role"].values())
        ro = r["roofline"]
        assert ro["collective_s"] is None
        assert ro["compute_s"] == pytest.approx(oc["flops_per_device"] / roofline.PEAK_FLOPS)
        assert ro["memory_s"] == pytest.approx(
            r["memory_analysis"]["argument_size_in_bytes"] / roofline.HBM_BW)
        with open(os.path.join(out, f"{arch}__{shape_name}__{mesh}.json")) as f:
            assert json.load(f) == r
    # the same count on both meshes; the mesh only splits it
    a, b = by[("granite-3-8b", "decode_32k", "single")], by[("granite-3-8b", "decode_32k",
                                                            "multi")]
    assert a["op_cost"]["flops"] == b["op_cost"]["flops"]
    # mamba2's long_500k: the conv tails' cache_seq2 fallbacks, as the reference notes them
    m = by[("mamba2-2.7b", "long_500k", "single")]
    assert len(m["sharding_fallbacks"]) == get_bundle("mamba2-2.7b").model.n_layers


def test_dryrun_argument_bytes_are_the_local_shards(dry):
    """granite's decode_32k parameter bytes per device equal the sum of
    each parameter's bytes over the devices its placements split it over."""
    recs, _ = dry
    r = next(x for x in recs if (x["arch"], x["shape"], x["mesh"]) ==
             ("granite-3-8b", "decode_32k", "multi"))
    cfg, mcfg = get_bundle("granite-3-8b").model, get_bundle("granite-3-8b").mesh
    with production_mesh(multi_pod=True) as mesh:
        pl = sh.param_shardings(cfg, mesh, mcfg)
        sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    want = 0
    for name, p in tm.init_params(cfg, device="meta").named_parameters():
        split = 1
        for axis, placement in zip(sizes, pl[name]):
            split *= sizes[axis] if placement.is_shard() else 1
        assert p.numel() % split == 0
        want += p.numel() * p.element_size() // split
    assert r["argument_bytes_by_role"]["params"] == want


def test_report_is_the_reference_report_over_port_records(dry):
    recs, out = dry
    loaded = report.load(out)
    assert len(loaded) == len(recs)
    assert report.summary(loaded) == j_report.summary(
        [{"status": r["status"], "tag": r["tag"]} for r in loaded])
    for mesh in ("single", "multi"):
        table = report.dryrun_table(loaded, mesh).splitlines()
        assert len(table) == 2 + sum(r["mesh"] == mesh for r in loaded)
        roof = report.roofline_table(loaded, mesh)
        assert "not measured" in roof and "skipped(full-attn)" in roof


def test_dryrun_main_exits_clean_and_counts(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["dryrun", "--arch", "mamba2-2.7b", "--shape",
                                      "decode_32k", "--mesh", "single",
                                      "--out", str(tmp_path)])
    dryrun.main()
    assert "dry-run: 1 ok, 0 skipped, 0 errors" in capsys.readouterr().out
    assert not dist.is_initialized()


def test_meshes_are_built_and_destroyed():
    for multi, shape in ((False, (16, 16)), (True, (2, 16, 16))):
        with production_mesh(multi_pod=multi) as mesh:
            assert tuple(mesh.shape) == shape and dist.get_world_size() == mesh.size()
            with pytest.raises(RuntimeError, match="exists already"):
                host_mesh("cpu").__enter__()
        assert not dist.is_initialized()
    with host_mesh("cpu") as mesh:
        assert tuple(mesh.shape) == (1, 1) and dist.get_backend() == "gloo"
    assert not dist.is_initialized()


def test_local_shape_refuses_an_uneven_split():
    with production_mesh() as mesh:
        assert op_cost.local_shape((32, 48), sh.placements(("data", "model"), mesh),
                                   mesh) == (2, 3)
        with pytest.raises(ValueError, match="does not split"):
            op_cost.local_shape((30, 48), sh.placements(("data", None), mesh), mesh)


# --------------------------------------------------------------------------
# imports
# --------------------------------------------------------------------------

MODULES = ["repro_torch.runtime", "repro_torch.runtime.sharding", "repro_torch.runtime.elastic",
           "repro_torch.runtime.serve_loop", "repro_torch.runtime.train_loop",
           "repro_torch.runtime.hemt_driver", "repro_torch.launch.mesh",
           "repro_torch.launch.specs", "repro_torch.launch.roofline",
           "repro_torch.launch.op_cost", "repro_torch.launch.dryrun",
           "repro_torch.launch.report", "repro_torch.models.model",
           "repro_torch.models.transformer", "repro_torch.kernels.ops"]


@pytest.fixture(scope="module")
def fresh_imports():
    """Each module imported first in its own fresh interpreter, three at a
    time (a light load beside the suite's other workers); module ->
    (return code, stderr)."""
    code = ("import os, sys; before = os.environ.get('XLA_FLAGS'); "
            "import importlib; importlib.import_module(sys.argv[1]); "
            "import torch.distributed as d; "
            "assert not d.is_initialized(); assert os.environ.get('XLA_FLAGS') == before; "
            "assert 'jax' not in sys.modules and 'repro' not in sys.modules")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    def run(module):
        done = subprocess.run([sys.executable, "-c", code, module], env=env,
                              stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
                              timeout=300)
        return done.returncode, done.stderr

    with ThreadPoolExecutor(3) as pool:
        return dict(zip(MODULES, pool.map(run, MODULES)))


@pytest.mark.parametrize("module", MODULES)
def test_module_imports_first_in_a_fresh_interpreter(fresh_imports, module):
    """No import cycle whichever module comes first, no process group, no
    ``XLA_FLAGS`` and no JAX."""
    rc, err = fresh_imports[module]
    assert rc == 0, err[-2000:]
