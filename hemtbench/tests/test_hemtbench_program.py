"""The join of the program's spans with the device trace
(``hemtbench/program.py``) on hand-made spans and events, and the
program's spans through a whole window on the CPU at reduced cells."""
from __future__ import annotations

import time

import pytest
import torch
from repro_torch.telemetry import Span, recording

from hemtbench import bench, program, trace
from hemtbench.tests import reduced

CELLS = ["granite-3-8b.long-prompt", "mamba2-2.7b.long-prompt"]


def spans():
    """A dispatch, a prefill (batch 0) and two decode steps of it, each
    step a norm and an attention span, then the observation."""
    return [
        Span("dispatch", 0, 10, None, None, {"round": 0}),
        Span("prefill", 10, 100, None, 0, {"rows": 2, "prompt_len": 8}),
        Span("attn", 20, 90, 1, 0, {"layer": 0}),
        Span("decode_step", 200, 300, None, 0, {"rows": 2, "step": 0}),
        Span("norm", 210, 220, 3, 0, {"layer": 0}),
        Span("attn", 220, 280, 3, 0, {"layer": 0}),
        Span("decode_step", 300, 420, None, 0, {"rows": 2, "step": 1}),
        Span("norm", 300, 330, 6, 0, {"layer": 0}),
        Span("attn", 330, 400, 6, 0, {"layer": 0}),
        Span("observe", 500, 510, None, None,
             {"replica": "r0", "tokens": 6, "observed_s": 2.0, "predicted_s": 2.5}),
        Span("observe", 520, 530, None, None, {"replica": "r1", "tokens": 6, "observed_s": 1.0}),
    ]


EVENTS = [("prefill_kernel", 15, 95), ("k", 205, 215), ("k", 225, 230), ("k", 290, 310),
          ("k", 335, 340), ("k", 430, 490), ("late", 505, 515)]


def test_paths_and_the_innermost_span():
    sp = spans()
    assert program.paths(sp)[:6] == ["dispatch", "prefill", "prefill/attn", "decode_step",
                                     "decode_step/norm", "decode_step/attn"]
    times, index = program.innermost(sp)
    at = [program._at(t, times, index) for t in (5, 50, 150, 200, 215, 250, 285, 300, 410, 505)]
    assert at == [0, 2, None, 3, 4, 5, 3, 7, 6, 9]


def test_program_idle_labels_each_gap_by_the_span_open_at_its_end():
    gaps = program.idle_gaps(EVENTS, 0, 600)
    assert gaps == [(0, 15), (95, 205), (215, 225), (230, 290), (310, 335), (340, 430),
                    (490, 505), (515, 600)]
    idle = {p: (n, pytest.approx(t)) for p, n, t, _ in program.program_idle(gaps, spans())}
    assert idle == {"prefill": (1, 15e-9), "decode_step": (2, 170e-9),
                    "decode_step/attn": (2, 35e-9), "outside any span": (2, 175e-9),
                    "observe": (1, 15e-9)}
    # of the idle time inside the harness's decode phase [100, 500), what spans label
    assert program.labelled_share(gaps, spans(), [(100, 500)]) == \
        pytest.approx(100 * (110 + 10 + 60 + 25 + 15) / (110 + 10 + 60 + 25 + 90 + 15))


def test_total_program_idle_is_the_traces_idle_time():
    gaps = program.idle_gaps(EVENTS, 0, 600)
    s = trace.summary(EVENTS, [("decode", 100, 500)], 0, 600)
    total = sum(t for _, _, t, _ in program.program_idle(gaps, spans()))
    assert total == pytest.approx(s["window_s"] - s["busy_s"])


def test_decode_kernels_count_from_the_first_step_to_the_observation():
    assert program.decode_kernels(EVENTS, spans()) == [(0, 5, 2)]
    assert program.decode_kernels_per_step(EVENTS, spans()) == 2.5
    assert program.decode_kernels(EVENTS, spans()[:9]) == []     # no observation yet
    assert program.decode_kernels_per_step(EVENTS, spans()[:9]) is None


def test_host_side_numbers():
    sp = spans()
    assert program.decode_issue_ms_per_step(sp) == pytest.approx((100 + 120) / 2 / 1e6)
    assert program.dispatch_estimate_err(sp) == pytest.approx(25.0)
    assert program.dispatch_estimate_err(sp[:9]) is None
    kinds = program.host_ms_by_kind(sp)
    assert kinds == pytest.approx({"norm": 20 / 1e6, "attn": 65 / 1e6, "self": 25 / 1e6})
    assert sum(kinds.values()) == pytest.approx(program.decode_issue_ms_per_step(sp))
    assert program.faults(sp, output_len=3) == []
    assert program.faults(sp, output_len=4) == ["batch 0: 2 decode steps"]
    bad = sp[:8] + [sp[8]._replace(start=320)] + sp[9:]
    assert program.faults(bad, output_len=3) == \
        ["decode_step 6: child 8 (attn) outside or overlapping"]


@pytest.mark.parametrize("name", CELLS)
def test_a_windows_spans_on_the_cpu(name):
    """Every batch of a window has output_len - 1 decode steps under its
    prefill's batch id, each made up of its layer kinds and self time."""
    c = reduced.cell(name, trace=True)
    server = bench.Server(c, 2**31 + 9, torch.device("cpu"))
    server.warm_up()
    with recording(time.time_ns) as rec:
        win = server.window(0.001, trace=False)
    sp = rec.spans
    out_len = c.traffic["output_len"]
    assert program.faults(sp, out_len) == []
    prefills = [s for s in sp if s.name == "prefill"]
    assert len(prefills) == len(win["batches"])
    assert [s.attrs["rows"] for s in prefills] == [b["batch"] for b in win["batches"]]
    assert sorted(program._decode_steps(sp)) == [s.batch for s in prefills]
    assert program.decode_issue_ms_per_step(sp) > 0
    assert program.dispatch_estimate_err(sp) > 0
    kinds = program.host_ms_by_kind(sp)
    mixer = "attn" if c.spec["family"] == "dense" else "ssm"
    assert {"embed", "norm", mixer, "head", "self"} <= set(kinds)
    assert sum(kinds.values()) == pytest.approx(program.decode_issue_ms_per_step(sp))
    observes = [s for s in sp if s.name == "observe"]
    assert len(observes) == len(win["batches"])
    assert all("predicted_s" in s.attrs for s in observes)      # warm-up met every replica
    assert [s.attrs["round"] for s in sp if s.name == "dispatch"] == \
        [r["round"] for r in win["rounds"]]
