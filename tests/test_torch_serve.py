"""Port serving: HeMTBatcher twins, greedy-token parity with the JAX
package, the demo CLI on the CPU, and the port's import boundary."""
import ast
import dataclasses
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.models import model as jm
from repro.runtime import serve_loop as jsl
from repro_torch import convert
from repro_torch.configs import get_reduced
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve as tserve
from repro_torch.runtime.serve_loop import HeMTBatcher, make_prefill_step, make_serve_step

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


# --------------------------------------------------------------------------
# HeMTBatcher twins of tests/test_runtime.py
# --------------------------------------------------------------------------

def test_hemt_batcher_learns_replica_speeds():
    b = HeMTBatcher(["r0", "r1"], alpha=0.0, min_share=1)
    first = b.dispatch(10)
    assert first == {"r0": 5, "r1": 5}
    b.observe("r0", 100, 1.0)
    b.observe("r1", 100, 2.5)              # 0.4x replica
    second = b.dispatch(14)
    assert second == {"r0": 10, "r1": 4}
    assert b.predicted_sync_delay(second) < b.predicted_sync_delay(first)


def test_hemt_batcher_min_share_floor_under_extreme_skew():
    b = HeMTBatcher(["fast", "crawl"], alpha=0.0, min_share=1)
    b.observe("fast", 1000, 1.0)
    b.observe("crawl", 10, 1.0)
    shares = b.dispatch(20)
    assert shares["crawl"] == 1 and shares["fast"] == 19
    b0 = HeMTBatcher(["fast", "crawl"], alpha=0.0)
    b0.observe("fast", 1000, 1.0)
    b0.observe("crawl", 10, 1.0)
    assert b0.dispatch(20)["crawl"] == 0


def test_hemt_batcher_full_forget_tracks_drift():
    b = HeMTBatcher(["a", "b"], alpha=0.0)
    b.observe("a", 100, 1.0)
    b.observe("b", 100, 1.0)
    assert b.dispatch(12) == {"a": 6, "b": 6}
    b.observe("a", 100, 1.0)
    b.observe("b", 25, 1.0)
    assert b.dispatch(10) == {"a": 8, "b": 2}
    s = HeMTBatcher(["a", "b"], alpha=0.9)
    s.observe("a", 100, 1.0)
    s.observe("b", 100, 1.0)
    s.observe("a", 100, 1.0)
    s.observe("b", 25, 1.0)
    assert s.dispatch(10)["b"] >= 4
    with pytest.raises(ValueError):
        HeMTBatcher(["a"], alpha=1.0)


def test_hemt_batcher_resize_mid_stream():
    b = HeMTBatcher(["a", "b", "c"], alpha=0.0)
    b.observe("a", 200, 1.0)
    b.observe("b", 100, 1.0)
    b.observe("c", 10, 1.0)
    b.resize(["a", "b"])
    assert b.replicas == ["a", "b"]
    assert b.dispatch(12) == {"a": 8, "b": 4}
    b.resize(["a", "b", "c"])
    assert b.dispatch(12) == {"a": 5, "b": 3, "c": 4}


def test_hemt_batcher_deterministic_split_under_ties():
    b = HeMTBatcher([f"r{i}" for i in range(4)], alpha=0.0)
    for r in b.replicas:
        b.observe(r, 100, 1.0)
    first = b.dispatch(10)
    assert all(b.dispatch(10) == first for _ in range(5))
    assert sum(first.values()) == 10
    assert sorted(first.values()) == [2, 2, 3, 3]
    e = HeMTBatcher([f"r{i}" for i in range(4)], mode="even")
    assert e.dispatch(10) == {"r0": 3, "r1": 3, "r2": 2, "r3": 2}


def test_hemt_batcher_straggling_flags_below_median():
    b = HeMTBatcher(["a", "b", "c"], alpha=0.0)
    assert b.straggling() == []
    b.observe("a", 100, 1.0)
    b.observe("b", 90, 1.0)
    b.observe("c", 30, 1.0)
    assert b.straggling(factor=2.0) == ["c"]
    assert b.straggling(factor=4.0) == []
    with pytest.raises(ValueError):
        b.straggling(factor=0.5)


@pytest.mark.parametrize("mode", ["hemt", "even"])
def test_hemt_batcher_dispatch_log_matches_reference(mode):
    """The same observation stream gives the reference's shares and
    predicted finishes, round for round."""
    names = ["r0", "r1", "r2"]
    port = HeMTBatcher(names, mode=mode, min_share=1)
    ref = jsl.HeMTBatcher(names, mode=mode, min_share=1)
    rng = np.random.default_rng(4)
    for _ in range(6):
        assert port.dispatch(24) == ref.dispatch(24)
        for r in names:
            tokens, secs = int(rng.integers(10, 200)), float(rng.uniform(0.5, 3.0))
            port.observe(r, tokens, secs)
            ref.observe(r, tokens, secs)
    assert [(d.shares, d.predicted_finish) for d in port.log] == \
        [(d.shares, d.predicted_finish) for d in ref.log]


# --------------------------------------------------------------------------
# greedy serving parity with the JAX package
# --------------------------------------------------------------------------

def test_greedy_tokens_match_jax():
    jcfg = dataclasses.replace(j_get_reduced("granite-3-8b"), dtype="float32")
    tcfg = dataclasses.replace(get_reduced("granite-3-8b"), dtype="float32")
    jparams = jm.init_params(jax.random.PRNGKey(3), jcfg)
    tparams = convert.from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                                      device="cpu")
    toks = np.random.default_rng(5).integers(1, jcfg.vocab_size, (3, 12)).astype(np.int32)
    max_len = 12 + 8

    jtok, jstate = jsl.make_prefill_step(jcfg, max_len, impl="pallas")(
        jparams, jnp.asarray(toks))
    before = fa.launches
    ttok, tstate = make_prefill_step(tcfg, max_len, impl="pallas")(
        tparams, torch.from_numpy(toks).long())
    assert fa.launches == before         # CPU tensors take the plain version
    jserve, tserve_step = jsl.make_serve_step(jcfg), make_serve_step(tcfg)
    jseq, tseq = [np.asarray(jtok)], [ttok.numpy()]
    for _ in range(8):
        jtok, _, jstate = jserve(jparams, jstate, jtok)
        ttok, logits, tstate = tserve_step(tparams, tstate, ttok)
        jseq.append(np.asarray(jtok))
        tseq.append(ttok.numpy())
    assert ttok.dtype == torch.int32 and tuple(logits.shape) == (3, 256)
    np.testing.assert_array_equal(np.stack(tseq), np.stack(jseq))


# --------------------------------------------------------------------------
# the demo CLI and the import boundary
# --------------------------------------------------------------------------

def test_serve_demo_runs_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["serve", "--device", "cpu", "--rounds", "2",
                                      "--gen-len", "3"])
    tserve.main()
    rounds = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["round"] for r in rounds] == [0, 1]
    assert rounds[0]["shares"] == {"rep0": 8, "rep1": 8, "rep2": 8}
    assert rounds[1]["shares"] == {"rep0": 10, "rep1": 10, "rep2": 4}
    assert rounds[1]["idle_s"] < rounds[0]["idle_s"]


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def test_port_imports_nothing_of_jax_or_the_reference():
    files = _port_files()
    assert len(files) > 10 and (ROOT / "chip_smoke.py").exists()
    banned = {"jax", "jaxlib", "repro", "flax", "optax"}
    for path in files:
        tree = ast.parse(path.read_text(encoding="utf-8"), str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                roots = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots = [node.module.split(".")[0]]
            else:
                continue
            bad = banned.intersection(roots)
            assert not bad, f"{path.relative_to(ROOT)}:{node.lineno} imports {bad}"
