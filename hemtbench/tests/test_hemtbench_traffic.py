"""The traffic generator: rounds of replica batches from a seed."""
from __future__ import annotations

import pytest

from hemtbench import traffic

SEEDS = [0, 7, 2**31 + 11, 2**33 + 5]


@pytest.mark.parametrize("seed", SEEDS)
def test_every_replica_sees_every_length_once_a_cycle(seed):
    t = traffic.load("long-prompt")
    k, n = len(t["prompt_lengths"]), len(t["replicas"])
    for cycle in range(3):
        rounds = [traffic.round_lengths(t, seed, cycle * k + r) for r in range(k)]
        for i in range(n):
            assert sorted(r[i] for r in rounds) == sorted(t["prompt_lengths"])
        for r in rounds:
            assert len(r) == n and len(set(r)) == 1


@pytest.mark.parametrize("seed", SEEDS)
def test_same_seed_same_rounds(seed):
    t = traffic.load("long-prompt")
    assert ([traffic.round_lengths(t, seed, r) for r in range(12)]
            == [traffic.round_lengths(t, seed, r) for r in range(12)])


def test_seeds_change_the_order_not_the_mix():
    t = traffic.load("long-prompt")
    orders = {tuple(tuple(traffic.round_lengths(t, s, r)) for r in range(8)) for s in SEEDS}
    assert len(orders) > 1
    for s in SEEDS:
        flat = sorted(x for r in range(8) for x in traffic.round_lengths(t, s, r))
        assert flat == sorted(t["prompt_lengths"] * 6)


def test_sub_seeds_fit_a_generator_and_differ():
    a, b = traffic.sub_seed(2**31 + 3, "x", 1), traffic.sub_seed(2**31 + 3, "x", 2)
    assert a != b and 0 <= a < 2**63 and 0 <= b < 2**63


def test_lengths_and_warm_up_batch():
    t = traffic.load("long-prompt")
    assert traffic.max_len(t, 4080) == 4096
    assert traffic.warmup_batch(t) == 20
    assert traffic.warmup_batch({**t, "requests_per_round": 6}) == 3


def test_a_malformed_mix_is_refused(tmp_path, monkeypatch):
    monkeypatch.setattr(traffic, "HERE", tmp_path)
    (tmp_path / "traffic").mkdir()
    (tmp_path / "traffic" / "bad.json").write_text('{"name": "bad"}')
    with pytest.raises(ValueError, match="missing"):
        traffic.load("bad")


@pytest.mark.parametrize("seconds,cycles", [(50, 2), (51, 2), (60, 2), (10, 1), (1, 1), (75.1, 3)])
def test_a_window_holds_a_fixed_number_of_cycles(seconds, cycles):
    t = traffic.load("long-prompt")
    assert t["cycle_s"] == 25
    assert traffic.cycles(t, seconds) == cycles
