"""The benchmark's fp32 references against the port's model on the CPU,
at the reduced cells: the same weights, the port's prefill and decode
steps through its cache against the reference's one pass, and the check
reading the port's served tokens and logits."""
from __future__ import annotations

import pytest
import torch

from hemtbench import check, port, weights
from hemtbench.reference import dense, fp8_mm, ssm
from hemtbench.tests import reduced

FAMILIES = {"dense": dense, "ssm": ssm}


def serve(spec, family, w, prompts, out_len, impl):
    cfg = port.model_config(spec)
    params = port.params(cfg, w)
    prefill, decode = port.serving(cfg, prompts.shape[1] + out_len, impl=impl)
    tok, state = prefill(params, prompts)
    tokens, logits = [tok], []
    for _ in range(out_len - 1):
        tok, lg, state = decode(params, state, tok)
        tokens.append(tok)
        logits.append(lg[:, :spec["vocab_size"]])
    return torch.stack(tokens, 1), torch.stack(logits, 1).float()


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_fp32_port_matches_reference(family, impl):
    spec = reduced.spec(family, dtype="float32")
    ref = FAMILIES[family]
    w = weights.make(spec, ref, 3, "cpu")
    gen = torch.Generator().manual_seed(4)
    prompts = torch.randint(0, spec["vocab_size"], (3, 37), generator=gen)
    tokens, logits = serve(spec, ref, w, prompts, 5, impl)
    want = ref.logits(w, spec, torch.cat([prompts, tokens[:, :-1]], 1), 36)
    assert torch.equal(tokens[:, 0], want[:, 0].argmax(-1))
    torch.testing.assert_close(logits, want[:, 1:], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_bf16_port_reads_within_bf16_and_control_reads_far_above(family):
    spec = reduced.spec(family)
    ref = FAMILIES[family]
    w = weights.make(spec, ref, 5, "cpu")
    prompts = torch.randint(0, spec["vocab_size"], (4, 24), generator=torch.Generator().manual_seed(6))
    tokens, logits = serve(spec, ref, w, prompts, 6, "pallas")
    requests = [{"prompt": prompts[i], "tokens": tokens[i], "logits": logits[i]}
                for i in range(4)]
    r = check.readings(w, spec, ref, requests, control=True)
    assert r["requests"] == 4 and r["tokens"] == 24
    assert r["logit_err"] < 0.05
    assert r["control_logit_err"] > 3 * r["logit_err"]


def test_fp8_mm_rounds_like_e4m3():
    x = torch.tensor([[1.0, 0.5, 0.0999]])
    w = torch.eye(3)
    got = fp8_mm(x, w)
    assert got[0, 0] == 1.0 and got[0, 1] == 0.5
    assert got[0, 2] != pytest.approx(0.0999, abs=1e-6)
    assert got[0, 2] == pytest.approx(0.0999, rel=0.07)


def test_weights_are_the_seeds():
    spec = reduced.spec("ssm")
    a, b, c = (weights.make(spec, ssm, s, "cpu") for s in (1, 1, 2))
    assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["stack.0.mixer.w_in"], c["stack.0.mixer.w_in"])
    assert a["embed.table"].dtype == torch.bfloat16
    assert a["stack.0.mixer.a_log"].dtype == torch.float32


def test_port_refuses_weights_that_do_not_fit():
    spec = reduced.spec("dense")
    w = weights.make(spec, dense, 1, "cpu")
    cfg = port.model_config(spec)
    w.pop("final_norm.scale")
    with pytest.raises(ValueError, match="differ"):
        port.params(cfg, w)


def test_served_weights_carry_the_multipliers_the_port_lacks():
    spec = reduced.spec("dense", dtype="float32")
    w = weights.make(spec, dense, 7, "cpu")
    d, dff = spec["hidden_size"], spec["intermediate_size"]
    m_e, m_r = spec["embedding_multiplier"], spec["residual_multiplier"]
    assert (m_e, m_r, spec["logits_scaling"]) == (12.0, 0.22, 16.0)
    assert torch.equal(w["final_norm.scale"], torch.full((d,), 1.0 / (12.0 * 16.0)))
    assert torch.equal(w["stack.0.norm1.scale"], torch.ones(d))
    assert w["embed.table"].std().item() == pytest.approx(m_e / d ** 0.5, rel=0.05)
    assert w["stack.1.ffn.w_down"].std().item() == pytest.approx(m_r / dff ** 0.5, rel=0.05)
    assert w["stack.1.ffn.w_up"].std().item() == pytest.approx(1 / d ** 0.5, rel=0.05)


def test_the_served_weights_are_one_draw_with_the_multipliers_folded_in():
    spec = reduced.spec("dense", dtype="float32")
    plain = {**spec, "embedding_multiplier": 1.0, "residual_multiplier": 1.0,
             "logits_scaling": 1.0}
    served, raw = weights.make(spec, dense, 8, "cpu"), weights.make(plain, dense, 8, "cpu")
    f = dense.folds(spec)
    assert set(dense.folds(plain).values()) == {1.0}
    for name, w in served.items():
        fold = f.get(name, f.get(name.split(".", 2)[-1], 1.0))
        torch.testing.assert_close(w / fold, raw[name], rtol=1e-6, atol=0)
    tokens = torch.randint(0, spec["vocab_size"], (2, 9),
                           generator=torch.Generator().manual_seed(9))
    # the published function of the raw draw is not the plain one
    assert not torch.allclose(dense.logits(served, spec, tokens, 0),
                              dense.logits(raw, plain, tokens, 0), rtol=1e-2, atol=1e-4)
