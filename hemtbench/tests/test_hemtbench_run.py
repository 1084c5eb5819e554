"""A whole run on the CPU at reduced cells: the result line's keys, the
check passing on the port as it is and failing under each fault the
serving path can have, and BENCHMARK.json against the contract."""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from hemtbench import bench, port
from hemtbench.tests import reduced

ROOT = Path(__file__).resolve().parents[2]
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]
CELLS = ["granite-3-8b.long-prompt", "mamba2-2.7b.long-prompt"]


def run(name, trace=False, seed=2**31 + 9, seconds=0.001, control=False):
    c = reduced.cell(name, trace)
    return bench.serve(c, seed, seconds, trace, "cpu", time.perf_counter(), control=control)


@pytest.mark.parametrize("name", CELLS)
def test_dry_run_prints_the_contract_line(name, capsys):
    result = run(name)
    bench.emit(result)
    out, err = capsys.readouterr()
    last = json.loads(out.strip().splitlines()[-1])
    assert list(last) == KEYS
    assert last["correct"] is True and last["failed"] == 0 and last["attempted"] > 0
    want = {m["name"] for m in bench.cell(bench.load_benchmark(), name, False).metrics}
    assert set(last["metrics"]) == want
    assert {"setup_s", "tokens_per_s", "round_ms"} <= want
    assert all(set(v) == {"value", "unit"} for v in last["metrics"].values())
    assert set(last["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    lines = err.strip().splitlines()[-3:]
    assert [ln.split()[1] for ln in lines] == ["failed", "gap_max", "logit_err"]
    assert all("limit" in ln for ln in lines)


def test_traced_dry_run_reads_the_host_side_layers():
    result = run("granite-3-8b.long-prompt", trace=True)
    assert set(result["metrics"]) == {"dispatch_idle_share", "decode_ms_per_step"}


def _faulty(fault):
    serving = port.serving

    def broken(cfg, max_len, impl="pallas"):
        prefill, decode = serving(cfg, max_len, impl)

        def prefill_half(params, tokens):
            half = max(1, tokens.shape[0] // 2)
            tok, state = prefill(params, tokens[:half].repeat(2, 1)[:tokens.shape[0]])
            return tok, state

        def decode_altered(params, state, tok):
            nxt, logits, state = decode(params, state, tok)
            return (nxt + 1) % cfg.vocab_size, logits, state

        def decode_stale(params, state, tok):
            saved = [{k: v.clone() for k, v in c.items()} for c in state["cache"]]
            nxt, logits, new = decode(params, state, tok)
            for c, s in zip(new["cache"], saved):
                for k in c:
                    c[k].copy_(s[k])
            return nxt, logits, {**new, "length": state["length"]}

        return {"half_batch": (prefill_half, decode),
                "token_altered": (prefill, decode_altered),
                "state_unchanged": (prefill, decode_stale)}[fault]
    return broken


@pytest.mark.parametrize("fault", ["half_batch", "token_altered", "state_unchanged"])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_serving_path_is_not_correct(name, fault, monkeypatch):
    limits = reduced.cell(name).limits
    monkeypatch.setattr(port, "serving", _faulty(fault))
    result = run(name)
    assert result["failed"] == 0
    assert result["correct"] is False
    assert any(result["checks"][k]["value"] > limits[k] for k in ("gap_max", "logit_err"))


@pytest.mark.parametrize("seed", [2**31 + 21, 22, 2**33 + 23])
@pytest.mark.parametrize("name", CELLS)
def test_the_control_in_the_programs_place_is_not_correct(name, seed):
    """The fp8-e4m3 control, held to the cell's limits by the program's
    own rule, comes out not correct where the program comes out correct."""
    result = run(name, seed=seed, control=True)
    control = result["control"]
    assert result["correct"] is True
    assert control["correct"] is False
    assert set(control["checks"]) == set(result["checks"])
    assert any(v["value"] > v["limit"] for v in control["checks"].values())
    assert control["checks"]["logit_err"]["value"] == control["readings"]["control_logit_err"]


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the run would serve the full cell")
    proc = subprocess.run([sys.executable, "hemtbench/run.py", "--workload", CELLS[0],
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300, check=False)
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr
    assert not [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]


def test_jax_is_found_by_whole_top_level_names():
    assert bench.forbidden_modules(["repro_torch.models", "torch", "reproduce", "jaxx"]) == []
    assert bench.forbidden_modules(["repro.core", "jaxlib.xla", "flax", "jax"]) == \
        ["flax", "jax", "jaxlib", "repro"]


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_the_contract():
    b = bench.load_benchmark()
    assert list(b) == ["command", "paths", "run_seconds", "configs", "workloads",
                       "end_to_end", "per_layer"]
    assert b["command"] == ["python3", "hemtbench/run.py"] and b["paths"] == ["hemtbench"]
    assert 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in b[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        spec = json.loads((ROOT / c["file"]).read_text())
        for key in c["reduced"]:
            assert key in spec["published"] and spec[key] != spec["published"][key]
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and all(0 < m["bound"] <= 0.25 for m in e2e.values())
    for w in b["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (ROOT / "hemtbench" / "limits" / f"{w['name']}.json").exists()
        reported = {n for n, m in e2e.items() if w["name"] in m.get("workloads", [w["name"]])}
        assert "setup_s" in reported and len(reported) > 1
        assert any(w["name"] in m["workloads"] for m in b["per_layer"])
    for m in b["per_layer"]:
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])
    for m in [*b["end_to_end"], *b["per_layer"]]:
        assert (ROOT / "hemtbench" / "metrics" / f"{m['name']}.py").exists()
        assert m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
