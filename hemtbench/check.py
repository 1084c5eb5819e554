"""The comparison that decides ``correct``.

Once the window has closed, a sample of the requests it finished, drawn
from the seed and always holding the longest prompt, is run through the
family's fp32 reference: each prompt with the tokens served after it,
in one pass, in blocks of requests. Two numbers are read, each against
its limit in ``limits/<cell>.json``:

* ``gap_max``: the widest gap by which a served token's reference logit
  lies below the reference's best at that position (every token served,
  the prefill's and each decode step's);
* ``logit_err``: the worst request's relative L2 distance between the
  logits its decode steps served and the reference's.

``readings(..., control=True)`` also reads the control: the reference
with every linear layer's operands rounded through float8 e4m3, put in
the program's place at the same positions (its gap is the reference's
gap of the token the control puts first). ``judge`` holds the program's
readings and the control's alike to the cell's limits: a run is correct
only where every number is within its limit, and the control must not be.
"""
from __future__ import annotations

import random
from typing import Dict, List, Sequence, Tuple

import torch

from hemtbench.reference import fp8_mm, matmul, no_tf32
from hemtbench.traffic import sub_seed

TOKENS_PER_BLOCK = 16384       # reference tokens per pass, so a block fits beside the weights


def sample(requests: Sequence[Dict], k: int, seed: int) -> List[Dict]:
    """k of ``requests`` drawn from the seed, the first longest among them."""
    if not requests:
        return []
    longest = max(range(len(requests)), key=lambda i: requests[i]["prompt"].shape[0])
    rest = [i for i in range(len(requests)) if i != longest]
    picked = random.Random(sub_seed(seed, "sample")).sample(rest, min(k - 1, len(rest)))
    return [requests[i] for i in [longest, *sorted(picked)]]


def judge(readings: Dict[str, float], limits: Dict[str, float], failed: int,
          prefix: str = "") -> Tuple[Dict[str, Dict[str, float]], bool]:
    """Each compared number beside its limit (``failed`` rows, limit 0;
    ``gap_max`` and ``logit_err`` as read, or the control's, under
    ``prefix``), and whether all are within their limits. No request
    compared is no verdict of correct."""
    checks = {"failed": {"value": failed, "limit": 0}}
    for name in ("gap_max", "logit_err"):
        checks[name] = {"value": readings[prefix + name], "limit": limits[name]}
    ok = readings["requests"] > 0 and all(v["value"] <= v["limit"] for v in checks.values())
    return checks, ok


def _blocks(requests: Sequence[Dict]) -> List[List[Dict]]:
    """Requests grouped by prompt length, at most TOKENS_PER_BLOCK tokens a block."""
    by_len: Dict[int, List[Dict]] = {}
    for r in requests:
        by_len.setdefault(r["prompt"].shape[0], []).append(r)
    out = []
    for length, rs in sorted(by_len.items()):
        per = max(1, TOKENS_PER_BLOCK // (length + rs[0]["tokens"].shape[0]))
        out += [rs[i:i + per] for i in range(0, len(rs), per)]
    return out


def _gap(ref: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    """ref (..., V) fp32, chosen (...) token ids: best logit minus the chosen one's."""
    return ref.amax(-1) - ref.gather(-1, chosen[..., None].long())[..., 0]


def _rel(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Per request (dim 0): ||got - want|| / ||want|| over the other dims."""
    return ((got - want).flatten(1).norm(dim=1) / want.flatten(1).norm(dim=1))


@torch.no_grad()
def readings(weights: Dict[str, torch.Tensor], spec: Dict, family, requests: Sequence[Dict],
             control: bool = False) -> Dict[str, float]:
    """Each request: ``prompt`` (S,), ``tokens`` (T,) served, ``logits``
    (T - 1, V) served by the decode steps (V the real vocabulary)."""
    out = {"gap_max": 0.0, "logit_err": 0.0, "requests": len(requests), "tokens": 0}
    if control:
        out.update({"control_gap_max": 0.0, "control_logit_err": 0.0})
    with no_tf32():
        for block in _blocks(requests):
            s = block[0]["prompt"].shape[0]
            toks = torch.stack([torch.cat([r["prompt"], r["tokens"][:-1]]) for r in block])
            served = torch.stack([r["tokens"] for r in block])               # (b, T)
            ref = family.logits(weights, spec, toks, s - 1, matmul)          # (b, T, V)
            got = torch.stack([r["logits"] for r in block]).float()          # (b, T-1, V)
            out["gap_max"] = max(out["gap_max"], float(_gap(ref, served).max()))
            out["logit_err"] = max(out["logit_err"], float(_rel(got, ref[:, 1:]).max()))
            out["tokens"] += served.numel()
            if control:
                low = family.logits(weights, spec, toks, s - 1, fp8_mm)
                out["control_gap_max"] = max(out["control_gap_max"],
                                             float(_gap(ref, low.argmax(-1)).max()))
                out["control_logit_err"] = max(out["control_logit_err"],
                                               float(_rel(low[:, 1:], ref[:, 1:]).max()))
                del low
            del ref, got
    return out
