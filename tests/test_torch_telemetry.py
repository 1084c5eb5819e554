"""The port's spans (``repro_torch.telemetry``) on the serving path, on the
CPU at the reduced configs: free and inert with no recording open, a
correct tree with one open, and the batcher's estimate beside what it
then observed."""
import itertools

import pytest
import torch

from repro_torch import telemetry
from repro_torch.configs import get_reduced
from repro_torch.models.model import forward, init_params
from repro_torch.runtime import serve_loop
from repro_torch.runtime.serve_loop import HeMTBatcher, make_prefill_step, make_serve_step

ARCHS = {"granite-3-8b": "attn", "mamba2-2.7b": "ssm"}
STEPS = 3


class CountingClock:
    def __init__(self):
        self.calls = 0

    def __call__(self) -> int:
        self.calls += 1
        return self.calls


def serve(arch, steps=STEPS):
    cfg = get_reduced(arch)
    params = init_params(cfg, 0, device="cpu")
    prompts = torch.randint(0, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(1))
    tok, state = make_prefill_step(cfg, 8 + steps + 1, impl="pallas")(params, prompts)
    decode = make_serve_step(cfg)
    tokens, logits = [tok], []
    for _ in range(steps):
        tok, lg, state = decode(params, state, tok)
        tokens.append(tok)
        logits.append(lg)
    return cfg, torch.stack(tokens), torch.stack(logits)


def children(spans, index):
    return [s for s in spans if s.parent == index]


@pytest.mark.parametrize("arch", ARCHS)
def test_no_recording_reads_no_clock_and_changes_nothing(arch):
    clock = CountingClock()
    with telemetry.recording(clock) as rec:
        _, tokens_on, logits_on = serve(arch)
    calls, recorded = clock.calls, len(rec.spans)
    assert calls > 0 and recorded > 0
    _, tokens_off, logits_off = serve(arch)
    assert clock.calls == calls and len(rec.spans) == recorded
    assert torch.equal(tokens_on, tokens_off)
    assert torch.equal(logits_on, logits_off)
    assert telemetry.span("decode_step") is telemetry.span("prefill")
    assert telemetry.new_batch() is None and telemetry.batch_step([]) == (None, None)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_prefill_and_its_steps_give_the_span_tree(arch):
    with telemetry.recording(CountingClock()) as rec:
        cfg, _, _ = serve(arch)
    spans = rec.spans
    assert all(s.end is not None and s.start <= s.end for s in spans)
    for s in spans:
        if s.parent is not None:
            p = spans[s.parent]
            assert p.start <= s.start and s.end <= p.end and s.batch == p.batch
    roots = [i for i, s in enumerate(spans) if s.parent is None]
    assert [spans[i].name for i in roots] == ["prefill"] + ["decode_step"] * STEPS
    assert {spans[i].batch for i in roots} == {0}
    assert spans[roots[0]].attrs == {"rows": 2, "prompt_len": 8}
    assert [spans[i].attrs for i in roots[1:]] == [{"rows": 2, "step": k, "graph": "eager"}
                                                   for k in range(STEPS)]
    mixer = ARCHS[arch]
    n = cfg.n_layers
    for i in roots:
        kids = children(spans, i)
        names = [s.name for s in kids]
        assert names[0] == "embed" and names[-1] == "head"
        assert [s.attrs["layer"] for s in kids if s.name == mixer] == list(range(n))
        assert names.count("ssm" if mixer == "attn" else "attn") == 0
        per_layer = 4 if "ffn" in names else 2          # norm, mixer[, norm, ffn]
        assert len(kids) == 2 + per_layer * n
        assert names.count("norm") == n * per_layer // 2
        # the step's self time and its children's durations make up the step
        self_s = spans[i].end - spans[i].start - sum(s.end - s.start for s in kids)
        assert self_s >= 0
        assert all(children(spans, spans.index(s)) == [] for s in kids)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_gives_each_layer_the_spans_prefill_does(arch):
    """The full pass runs the layer body of prefill and decode: under a
    recording ``forward`` gives the embedding and then, layer by layer, the
    same norm, mixer[, norm, ffn] spans as a prefill's children, each a
    root (no serving step encloses a forward) with no children."""
    cfg = get_reduced(arch)
    params = init_params(cfg, 0, device="cpu")
    prompts = torch.randint(0, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(1))
    with telemetry.recording(CountingClock()) as rec:
        forward(params, prompts, cfg, impl="pallas")
    full = rec.spans
    with telemetry.recording(CountingClock()) as rec:
        make_prefill_step(cfg, 12, impl="pallas")(params, prompts)
    root = [i for i, s in enumerate(rec.spans) if s.name == "prefill"]
    assert len(root) == 1
    kids = children(rec.spans, root[0])
    assert [s.name for s in kids][::len(kids) - 1] == ["embed", "head"]
    assert [(s.name, s.attrs) for s in full] == [(s.name, s.attrs) for s in kids[:-1]]
    assert all(s.parent is None for s in full)
    per_layer = ["norm", ARCHS[arch]] + (["norm", "ffn"] if "ffn" in {s.name for s in full} else [])
    assert [(s.name, s.attrs["layer"]) for s in full[1:]] == \
        [(name, i) for i in range(cfg.n_layers) for name in per_layer]


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_span_says_how_the_step_ran(arch):
    """On the CPU every step is eager: each ``decode_step`` span says so,
    as ``serve_loop.decode_steps`` counts."""
    before = dict(serve_loop.decode_steps)
    with telemetry.recording(CountingClock()) as rec:
        serve(arch)
    assert [s.attrs["graph"] for s in rec.spans if s.name == "decode_step"] == \
        ["eager"] * STEPS
    assert {k: serve_loop.decode_steps[k] - n for k, n in before.items()} == \
        {"capture": 0, "replay": 0, "eager": STEPS}


def test_a_second_recording_raises():
    with telemetry.recording(CountingClock()):
        with pytest.raises(RuntimeError, match="already open"):
            with telemetry.recording(CountingClock()):
                pass
    with telemetry.recording(CountingClock()) as rec:       # the first one closed
        with telemetry.span("dispatch"):
            pass
    assert [s.name for s in rec.spans] == ["dispatch"]


def test_a_batch_id_follows_its_cache_across_batches():
    cfg = get_reduced("mamba2-2.7b")
    params = init_params(cfg, 0, device="cpu")
    prefill, decode = make_prefill_step(cfg, 12, impl="pallas"), make_serve_step(cfg)
    with telemetry.recording(CountingClock()) as rec:
        a_tok, a = prefill(params, torch.zeros((1, 4), dtype=torch.long))
        b_tok, b = prefill(params, torch.ones((3, 4), dtype=torch.long))
        for _ in range(2):
            a_tok, _, a = decode(params, a, a_tok)
            b_tok, _, b = decode(params, b, b_tok)
    steps = [(s.batch, s.attrs["rows"], s.attrs["step"]) for s in rec.spans
             if s.name == "decode_step"]
    assert steps == [(0, 1, 0), (1, 3, 0), (0, 1, 1), (1, 3, 1)]


def test_observe_carries_the_estimate_it_held_before():
    b = HeMTBatcher(["fast", "slow"], alpha=0.3, mode="hemt")
    plan = [("fast", 100, 1.0), ("slow", 100, 4.0), ("fast", 300, 2.0), ("slow", 60, 3.0)]
    with telemetry.recording(CountingClock()) as rec:
        b.dispatch(10)
        expected = []
        for replica, tokens, seconds in plan:
            speed = b.estimator.speed(replica)
            expected.append(None if speed is None else tokens / speed)
            b.observe(replica, tokens, seconds)
        shares = b.dispatch(10)
    observed = [s for s in rec.spans if s.name == "observe"]
    assert [s.attrs.get("predicted_s") for s in observed] == expected
    assert expected[:2] == [None, None] and expected[2] == pytest.approx(3.0)
    assert [(s.attrs["replica"], s.attrs["tokens"], s.attrs["observed_s"])
            for s in observed] == plan
    dispatched = [s for s in rec.spans if s.name == "dispatch"]
    assert [s.attrs["round"] for s in dispatched] == [0, 1]
    assert dispatched[1].attrs["shares"] == shares == b.log[-1].shares


def test_spans_nest_by_parent_index_and_inherit_the_batch():
    clock = itertools.count(10)
    with telemetry.recording(lambda: next(clock)) as rec:
        with telemetry.span("decode_step", batch=7, step=0):
            with telemetry.span("norm", layer=0):
                pass
            with telemetry.span("attn", layer=0) as sp:
                sp.set(extra=1)
        with telemetry.span("observe"):
            pass
    assert [tuple(s) for s in rec.spans] == [
        ("decode_step", 10, 15, None, 7, {"step": 0}),
        ("norm", 11, 12, 0, 7, {"layer": 0}),
        ("attn", 13, 14, 0, 7, {"layer": 0, "extra": 1}),
        ("observe", 16, 17, None, None, {}),
    ]
