"""The benchmark's arithmetic on hand-made records: tails over requests,
rates over the whole span, the fleet clock, idle shares, the trace's
busy union and idle gaps."""
from __future__ import annotations

import importlib.util
from pathlib import Path

import pytest

from hemtbench import stats, trace
from hemtbench.counts import dense

METRICS = Path(__file__).resolve().parents[1] / "metrics"
PEAKS = {"flops_bf16": 1e12, "bytes_per_s": 1e9}


def read(metric, rec):
    spec = importlib.util.spec_from_file_location("m_" + metric.replace(".", "_"),
                                                  METRICS / f"{metric}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(rec)


def test_percentile_interpolates_as_numpy():
    assert stats.percentile([1, 2, 3, 4, 5], 50) == 3
    assert stats.percentile(list(range(1, 101)), 95) == pytest.approx(95.05)
    assert stats.percentile([7.0], 95) == 7.0


def test_fleet_round_divides_by_speed():
    r = stats.fleet_round({"a": 1.0, "b": 1.0}, {"a": 1.0, "b": 0.5})
    assert r == {"makespan_s": 2.0, "idle_s": 1.0, "capacity_s": 4.0}
    r2 = stats.fleet_round({"a": 2.0, "b": 1.0}, {"a": 1.0, "b": 0.5})
    assert stats.idle_share([r, r2]) == pytest.approx(1.0 / 8.0)


def test_union_clip_gaps():
    busy = stats.union([(5, 7), (0, 2), (1, 3), (6, 9)])
    assert busy == [(0, 3), (5, 9)]
    assert stats.clip(busy, 1, 6) == [(1, 3), (5, 6)]
    assert stats.gaps(busy, -1, 12) == [(-1, 0), (3, 5), (9, 12)]


def record():
    batches = [{"batch": 2, "prompt_len": 3, "prefill_s": 0.5, "decode_s": 1.0, "steps": 4,
                "speed": 1.0},
               {"batch": 1, "prompt_len": 5, "prefill_s": 0.25, "decode_s": 0.2, "steps": 4,
                "speed": 0.4}]
    rounds = [stats.fleet_round({"a": 1.5, "b": 0.45}, {"a": 1.0, "b": 0.5})]
    spec = {"num_hidden_layers": 1, "hidden_size": 4, "intermediate_size": 8,
            "num_attention_heads": 2, "num_key_value_heads": 1, "head_dim": 2, "vocab_size": 10}
    return {"batches": batches, "rounds": rounds, "span_s": 2.5, "setup_s": 9.0,
            "traffic": {"output_len": 5}, "spec": spec, "counts": dense, "peaks": PEAKS,
            "launches": {"flash_attention": 2},
            "trace": {"busy_s": 1.5, "window_s": 2.0,
                      "kernels": {"void flash_fwd_wgmma_kernel<128>": (2, 1e-6), "gemm": (4, 1.0)}}}


def test_end_to_end_readers():
    rec = record()
    assert read("setup_s", rec) == 9.0
    assert read("tokens_per_s", rec) == pytest.approx((2 * (3 + 5) + (5 + 5)) / 2.5)
    # three requests on the fleet clock: two at 500 ms, one at 250 ms / 0.4
    assert read("ttft_p95_ms", rec) == pytest.approx(500.0 + 0.9 * 125.0)
    assert read("round_ms", rec) == pytest.approx(1500.0)


def test_per_layer_readers():
    rec = record()
    assert read("decode_ms_per_step", rec) == pytest.approx(1e3 * 1.2 / 8)
    assert read("dispatch_idle_share", rec) == pytest.approx(100 * 0.6 / 3.0)
    assert read("device_idle_share", rec) == pytest.approx(25.0)
    flops = dense.prefill_flops(rec["spec"], 2, 3) + dense.prefill_flops(rec["spec"], 1, 5)
    assert read("prefill_mfu", rec) == pytest.approx(100 * flops / 0.75 / 1e12)
    bound = sum(max(f / 1e12, b / 1e9) for f, b in
                (dense.flash_cost(rec["spec"], 2, 3), dense.flash_cost(rec["spec"], 1, 5)))
    assert read("flash_roofline", rec) == pytest.approx(100 * bound / 1e-6)


def test_readers_find_nothing_where_nothing_was_read():
    rec = record()
    rec["launches"] = {"flash_attention": 3}          # the port counted other launches
    assert read("flash_roofline", rec) is None
    assert read("ssd_roofline", rec) is None          # a dense model runs no SSD kernel
    rec["trace"] = None
    for name in ("flash_roofline", "device_idle_share"):
        assert read(name, rec) is None
    rec["peaks"] = None                               # a card not in peaks.json
    assert read("prefill_mfu", rec) is None


def test_trace_summary_labels_idle_time_by_host_span():
    ns = 1_000_000_000
    events = [("k1", 0, ns), ("k2", ns // 2, 2 * ns), ("memcpy", 5 * ns, 6 * ns),
              ("late", 20 * ns, 21 * ns)]
    spans = [("decode", 2 * ns, 4 * ns), ("prefill", 0, 2 * ns), ("observe", 4 * ns, 5 * ns)]
    s = trace.summary(events, spans, 0, 8 * ns)
    assert s["busy_s"] == pytest.approx(3.0) and s["window_s"] == pytest.approx(8.0)
    assert s["kernels"]["k2"] == (1, 1.5)
    idle = {name.split(":")[0]: t for name, t in s["idle_gaps"]}
    assert idle == {"decode": pytest.approx(3.0), "between spans": pytest.approx(2.0)}
    assert s["device_ops"][0] == ["k2", 1.5]
    assert trace.summary(events, spans, 10 * ns, 12 * ns) is None


@pytest.mark.parametrize("speed", [1.0, 0.5, 0.4])
def test_first_token_waits_on_its_own_replica(speed):
    rec = record()
    rec["batches"] = [{**rec["batches"][0], "speed": speed}]
    assert read("ttft_p95_ms", rec) == pytest.approx(500.0 / speed)
