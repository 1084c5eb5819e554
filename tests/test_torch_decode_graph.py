"""The decode step as a CUDA graph (``runtime.serve_loop.make_serve_step``)
on the card: a batch's first step captures it and every step replays it,
giving the eager step's tokens and logits bit for bit; inputs a graph
cannot hold (placed params, an encoder output, an MoE layer) decode
eagerly; a dropped state frees the graph's memory. On the CPU every step
is eager. Plain PyTorch only, so the file runs on a machine without JAX."""
import pytest
import torch
import torch.distributed as dist

from repro_torch import telemetry
from repro_torch.configs import get_bundle, get_reduced
from repro_torch.launch.mesh import host_mesh
from repro_torch.models import model as tm
from repro_torch.runtime import serve_loop
from repro_torch.runtime import sharding as sh
from repro_torch.runtime.serve_loop import make_prefill_step, make_serve_step

B, S, STEPS = 3, 24, 15
MAX_LEN = S + STEPS + 1


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _prompts(cfg, dev, seed=1):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (B, S), device=dev, generator=gen)


def _counts(before):
    return {k: serve_loop.decode_steps[k] - before[k] for k in before}


def _ticks():
    n = iter(range(1 << 40))
    return lambda: next(n)


def test_decode_steps_on_the_cpu_are_eager():
    cfg = get_reduced("granite-3-8b")
    params = tm.init_params(cfg, 0, device="cpu")
    tok, state = make_prefill_step(cfg, MAX_LEN)(params, _prompts(cfg, torch.device("cpu")))
    before = dict(serve_loop.decode_steps)
    serve = make_serve_step(cfg)
    for _ in range(3):
        tok, _, state = serve(params, state, tok)
    assert _counts(before) == {"capture": 0, "replay": 0, "eager": 3}
    assert "graph" not in state and int(state["pos"]) == state["length"] == S + 3


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["granite-3-8b", "mamba2-2.7b"])
def test_graph_steps_equal_eager_steps_on_card(arch):
    """15 replayed steps against 15 eager ``decode_step`` calls on a copy
    of the same prefilled state: the same tokens and logits bit for bit,
    each step's logits a tensor of its own; one capture, 15 replays."""
    dev = _card()
    cfg = get_reduced(arch)
    params = tm.init_params(cfg, 0, device=dev)
    tok, state = make_prefill_step(cfg, MAX_LEN, impl="pallas")(params, _prompts(cfg, dev))
    twin = {"cache": [{k: v.clone() for k, v in c.items()} for c in state["cache"]],
            "length": state["length"]}
    serve = make_serve_step(cfg)
    before = dict(serve_loop.decode_steps)
    got_tok, got_logits, eager_tok, eager_logits = [], [], [], []
    t = tok
    with telemetry.recording(_ticks()) as rec:
        for _ in range(STEPS):
            t, lg, state = serve(params, state, t)
            got_tok.append(t)
            got_logits.append(lg)
    assert _counts(before) == {"capture": 1, "replay": STEPS, "eager": 0}
    t = tok
    with torch.no_grad():
        for _ in range(STEPS):
            lg, twin = tm.decode_step(params, twin, t, cfg)
            t = torch.argmax(lg, dim=-1).to(torch.int32)
            eager_tok.append(t)
            eager_logits.append(lg)
    torch.cuda.synchronize()
    for k in range(STEPS):
        assert torch.equal(got_tok[k], eager_tok[k]), k
        assert torch.equal(got_logits[k], eager_logits[k]), k
    assert len({lg.data_ptr() for lg in got_logits}) == STEPS
    assert not all(torch.equal(got_logits[0], lg) for lg in got_logits[1:])
    assert state["length"] == S + STEPS and int(state["pos"]) == S + STEPS
    for c, w in zip(state["cache"], twin["cache"]):
        assert all(torch.equal(c[k], w[k]) for k in c)
    steps = [(i, s) for i, s in enumerate(rec.spans) if s.name == "decode_step"]
    assert [s.attrs["graph"] for _, s in steps] == ["capture"] + ["replay"] * (STEPS - 1)
    # the per-kind spans fire while the step's Python runs: on the capture only
    assert [sum(x.parent == i for x in rec.spans) > 0 for i, _ in steps] == \
        [True] + [False] * (STEPS - 1)


def _placed_granite(dev, cfg):
    tokens = _prompts(cfg, dev)
    with host_mesh(dev) as mesh:
        mcfg = get_bundle("granite-3-8b").mesh
        params = sh.place(tm.init_params(cfg, 0, device=dev), mesh,
                          sh.param_shardings(cfg, mesh, mcfg))
        tok, state = make_prefill_step(cfg, MAX_LEN)(params, tokens)
        state = sh.place(state, mesh, sh.cache_shardings(cfg, mesh, mcfg, state, B))
        yield params, state, tok, None


def _encoder_decoder(dev, cfg):
    from repro_torch.models.frontends import stub_feature_shape

    params = tm.init_params(cfg, 0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    feats = torch.randn(stub_feature_shape(cfg, B, S), device=dev, generator=gen)
    tok, state = make_prefill_step(cfg, MAX_LEN)(params, _prompts(cfg, dev), feats)
    with torch.no_grad():
        enc_out = tm.encode(params, feats, cfg)
    yield params, state, tok, enc_out


def _moe(dev, cfg):
    params = tm.init_params(cfg, 0, device=dev)
    tok, state = make_prefill_step(cfg, MAX_LEN)(params, _prompts(cfg, dev))
    yield params, state, tok, None


EAGER = {"placed-granite": ("granite-3-8b", _placed_granite),
         "whisper-enc-out": ("whisper-medium", _encoder_decoder),
         "granite-moe": ("granite-moe-1b-a400m", _moe)}


@pytest.mark.gpu
@pytest.mark.parametrize("case", EAGER)
def test_inputs_a_graph_cannot_hold_decode_eagerly_on_card(case):
    dev = _card()
    arch, make = EAGER[case]
    cfg = get_reduced(arch)
    serve = make_serve_step(cfg)
    for params, state, tok, enc_out in make(dev, cfg):
        before = dict(serve_loop.decode_steps)
        with telemetry.recording(_ticks()) as rec:
            for _ in range(4):
                tok, _, state = serve(params, state, tok, enc_out)
        assert _counts(before) == {"capture": 0, "replay": 0, "eager": 4}
        assert "graph" not in state and state["length"] == S + 4
        assert [s.attrs["graph"] for s in rec.spans if s.name == "decode_step"] == \
            ["eager"] * 4
    assert not dist.is_initialized()


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["granite-3-8b", "mamba2-2.7b"])
def test_a_dropped_state_frees_its_graph_on_card(arch):
    """After one warm batch, a batch's prefill, 15 replayed steps and the
    drop of its state and outputs leave ``memory_allocated`` where it was
    before the prefill."""
    dev = _card()
    cfg = get_reduced(arch)
    params = tm.init_params(cfg, 0, device=dev)
    prefill, serve = make_prefill_step(cfg, MAX_LEN), make_serve_step(cfg)

    def batch(seed):
        before = dict(serve_loop.decode_steps)
        tok, state = prefill(params, _prompts(cfg, dev, seed))
        for _ in range(STEPS):
            tok, logits, state = serve(params, state, tok)
        torch.cuda.synchronize()
        assert _counts(before) == {"capture": 1, "replay": STEPS, "eager": 0}
        return tok.cpu()

    batch(1)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    batch(2)
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated(dev) == base
