"""The one traffic generator: reads ``traffic/<name>.json`` and turns a
seed into rounds of replica batches.

A mix is closed-loop rounds of ``requests_per_round`` requests, split over
the fleet's ``replicas`` (relative speeds) by the port's ``HeMTBatcher``.
The port prefills a batch at one length, so lengths are drawn per replica
batch: in each cycle of ``len(prompt_lengths)`` rounds the seed shuffles
the lengths afresh, and round k of the cycle gives every replica the k-th
length. Each replica so sees every length once per cycle, and the
batcher's estimates of the replicas' relative speeds are not swayed by one
replica drawing longer prompts than another in the same round; a seed
changes the order and the token ids, never the set of (replica, length)
pairs of a cycle.

A window holds a fixed number of whole cycles, ``round(seconds /
cycle_s)`` and at least one, set by ``--seconds`` and never by the clock,
so every run of a cell serves the same requests however fast its host is.
"""
from __future__ import annotations

import hashlib
import json
import math
import random
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parent

KEYS = ("name", "loop", "requests_per_round", "replicas", "mode", "min_share",
        "prompt_lengths", "output_len", "cycle_s", "check_requests", "source", "why")


def load(name: str) -> Dict:
    traffic = json.loads((HERE / "traffic" / f"{name}.json").read_text())
    missing = [k for k in KEYS if k not in traffic]
    if missing:
        raise ValueError(f"traffic {name}: missing {missing}")
    if traffic["loop"] != "closed":
        raise ValueError(f"traffic {name}: only closed-loop rounds are generated")
    if traffic["output_len"] < 1 or min(traffic["prompt_lengths"]) < 1:
        raise ValueError(f"traffic {name}: lengths must be positive")
    if traffic["cycle_s"] <= 0:
        raise ValueError(f"traffic {name}: cycle_s must be positive")
    if traffic["requests_per_round"] < len(traffic["replicas"]) * traffic["min_share"]:
        raise ValueError(f"traffic {name}: too few requests for every replica's share")
    return traffic


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed for one purpose, from the run's seed and tags."""
    digest = hashlib.sha256(":".join(map(str, (seed, *tags))).encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def round_lengths(traffic: Dict, seed: int, rnd: int) -> List[int]:
    """The prompt length of each replica's batch in round ``rnd``."""
    order = sorted(traffic["prompt_lengths"])
    k = len(order)
    random.Random(sub_seed(seed, "cycle", rnd // k)).shuffle(order)
    return [order[rnd % k]] * len(traffic["replicas"])


def cycles(traffic: Dict, seconds: float) -> int:
    """Whole cycles of the mix in a window of ``seconds``."""
    return max(1, round(seconds / traffic["cycle_s"]))


def max_len(traffic: Dict, prompt_len: int) -> int:
    """Positions a request's cache holds: its prompt and its output."""
    return prompt_len + traffic["output_len"]


def warmup_batch(traffic: Dict) -> int:
    """Requests in a warm-up batch: the fastest replica's share of a round
    when shares follow the speeds."""
    speeds = traffic["replicas"]
    return math.ceil(round(traffic["requests_per_round"] * max(speeds) / sum(speeds), 9))
