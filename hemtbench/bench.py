"""One run of one cell: set-up, the measured window, the record that the
metric readers read, the check, and the result line.

Set-up builds nothing but what the window uses: the weights, made on the
device from the seed; the port's parameter tree over them; its serving
steps for each prompt length of the mix; and one warm-up batch per
length (largest first, at the fastest replica's share of a round),
which builds the port's kernels and is fed to the batcher, so that the
window's first round is already dispatched by HeMT. The window then runs
closed-loop rounds in a fixed number of whole cycles of the mix
(``traffic.round_lengths``, ``traffic.cycles``), so every window serves
the same requests and holds each replica's every prompt length equally
often: the port's
``HeMTBatcher.dispatch`` splits a round over the fleet's replicas, each
replica's batch is prefilled and decoded on the card in turn, timed from
its own start on the host clock around work that ends in a
synchronisation, and the batcher observes it on the fleet clock (card
time over the replica's speed). Nothing compiles inside the window.
"""
from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from hemtbench import check, port, stats
from hemtbench import traffic as traffic_mod
from hemtbench import weights as weights_mod
from hemtbench.trace import DeviceTrace, summary

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Cell:
    name: str
    chips: int
    spec: Dict
    traffic: Dict
    metrics: List[Dict]          # the BENCHMARK.json entries this run reports
    limits: Dict[str, float]


def load_benchmark(root: Path = ROOT) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(bench: Dict, name: str, trace: bool, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``bench`` with the metrics a run with or
    without ``--trace`` reports: end-to-end ones that list the cell (or
    list no cells), or per-layer ones that list it (or, listing none,
    move an end-to-end metric the cell reports)."""
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r}; known: {sorted(by_name)}")
    w = by_name[name]
    config = next(c for c in bench["configs"] if c["name"] == w["config"])
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    return Cell(name=name, chips=w["chips"],
                spec=json.loads((root / config["file"]).read_text()),
                traffic=traffic_mod.load(w["traffic"]),
                metrics=per_layer if trace else e2e,
                limits=json.loads((HERE / "limits" / f"{name}.json").read_text()))


def reader(metric: str) -> Callable[[Dict], Optional[float]]:
    """``read`` of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "hemtbench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def emit(result: Dict) -> None:
    """The checked numbers beside their limits as the last lines of
    standard error, then the result as the last line of standard output."""
    for name, v in result["checks"].items():
        print(f"check {name} {v['value']} limit {v['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def forbidden_modules(names=None) -> List[str]:
    """Top-level names among ``names`` (the loaded modules) that are JAX's
    or the JAX package's, compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


class Server:
    """The cell's model served by the port, with the batch loop the window
    and the warm-up share."""

    def __init__(self, c: Cell, seed: int, device: torch.device):
        self.c, self.seed, self.dev = c, seed, device
        self.cuda = device.type == "cuda"
        self.family = importlib.import_module(f"hemtbench.reference.{c.spec['family']}")
        self.counts = importlib.import_module(f"hemtbench.counts.{c.spec['family']}")
        tr = c.traffic
        cfg = port.model_config(c.spec)
        limit = c.spec.get("max_position_embeddings")
        longest = traffic_mod.max_len(tr, max(tr["prompt_lengths"]))
        if limit is not None and longest > limit:
            raise ValueError(f"{c.name}: {longest} positions exceed the model's {limit}")
        self.weights = weights_mod.make(c.spec, self.family, seed, device)
        self.params = port.params(cfg, self.weights)
        self.steps = {n: port.serving(cfg, traffic_mod.max_len(tr, n))
                      for n in tr["prompt_lengths"]}
        self.names = [f"r{i}" for i in range(len(tr["replicas"]))]
        self.speeds = dict(zip(self.names, tr["replicas"]))
        self.batcher = port.batcher(self.names, tr["mode"], tr["min_share"])
        self.spans: List = []

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.dev)

    def batch(self, tag: str, rnd: int, replica: str, length: int, size: int) -> Dict:
        """Prefill and decode one replica batch; its record keeps the
        prompts, the served tokens (T, b) and the decode logits."""
        out_len = self.c.traffic["output_len"]
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(traffic_mod.sub_seed(self.seed, tag, rnd, replica))
        t = time.time_ns()
        prompts = torch.randint(0, self.c.spec["vocab_size"], (size, length), generator=gen,
                                device=self.dev)
        self.spans.append(("prompt", t, time.time_ns()))
        prefill, decode = self.steps[length]
        rec = {"round": rnd, "replica": replica, "speed": self.speeds[replica], "batch": size,
               "prompt_len": length, "steps": out_len - 1, "prompts": prompts,
               "error": None, "logits": []}
        self.sync()
        t0, w0 = time.perf_counter(), time.time_ns()
        try:
            tok, state = prefill(self.params, prompts)
            self.sync()
            t1, w1 = time.perf_counter(), time.time_ns()
            self.spans.append(("prefill", w0, w1))
            tokens = [tok]
            for _ in range(out_len - 1):
                tok, logits, state = decode(self.params, state, tok)
                tokens.append(tok)
                rec["logits"].append(logits)
            del state
            self.sync()
            rec["tokens"] = torch.stack(tokens)
        except RuntimeError as err:          # a CUDA error or out of memory: all rows fail
            t1 = time.perf_counter()
            rec["error"] = f"{type(err).__name__}: {err}"[:500]
        t2 = time.perf_counter()
        self.spans.append(("decode", w1 if rec["error"] is None else w0, time.time_ns()))
        rec.update(prefill_s=t1 - t0, decode_s=t2 - t1, total_s=t2 - t0)
        return rec

    def observe(self, rec: Dict) -> None:
        t = time.time_ns()
        self.batcher.observe(rec["replica"], rec["batch"] * self.c.traffic["output_len"],
                             rec["total_s"] / rec["speed"])
        self.spans.append(("observe", t, time.time_ns()))

    def warm_up(self) -> None:
        """One batch per prompt length, largest first, fed to the batcher."""
        tr = self.c.traffic
        size = traffic_mod.warmup_batch(tr)
        for j, length in enumerate(sorted(set(tr["prompt_lengths"]), reverse=True)):
            rec = self.batch("warmup", j, self.names[j % len(self.names)], length, size)
            if rec["error"] is not None:
                raise RuntimeError(f"warm-up batch of {size} x {length}: {rec['error']}")
            self.observe(rec)

    def window(self, seconds: float, trace: bool) -> Dict:
        tr = self.c.traffic
        batches, rounds = [], []
        tracer = DeviceTrace() if (trace and self.cuda) else contextlib.nullcontext()
        self.spans = []
        before = port.launches()
        with tracer:
            self.sync()
            w0, w0_ns = time.perf_counter(), time.time_ns()
            for rnd in range(traffic_mod.cycles(tr, seconds) * len(tr["prompt_lengths"])):
                t = time.time_ns()
                shares = self.batcher.dispatch(tr["requests_per_round"])
                lengths = traffic_mod.round_lengths(tr, self.seed, rnd)
                self.spans.append(("dispatch", t, time.time_ns()))
                times = {}
                for replica, length in zip(self.names, lengths):
                    if shares[replica] == 0:
                        continue
                    rec = self.batch("window", rnd, replica, length, shares[replica])
                    batches.append(rec)
                    times[replica] = rec["total_s"]
                    self.observe(rec)
                rounds.append({"round": rnd, "shares": shares,
                               **stats.fleet_round(times, self.speeds)})
            self.sync()
            span_s, w1_ns = time.perf_counter() - w0, time.time_ns()
        after = port.launches()
        events = tracer.events if isinstance(tracer, DeviceTrace) else []
        return {"batches": batches, "rounds": rounds, "span_s": span_s,
                "launches": {k: after[k] - before[k] for k in after},
                "trace": summary(events, self.spans, w0_ns, w1_ns) if trace and self.cuda
                else None}


def failed_rows(rec: Dict, vocab: int) -> torch.Tensor:
    """(b,) bool: rows whose batch raised, or that served a token outside
    the vocabulary or a non-finite logit."""
    if rec["error"] is not None:
        return torch.ones(rec["batch"], dtype=torch.bool)
    bad = ((rec["tokens"] < 0) | (rec["tokens"] >= vocab)).any(0)
    for logits in rec["logits"]:
        bad |= ~torch.isfinite(logits[:, :vocab]).all(-1)
    return bad.cpu()


def peaks(kind: str) -> Optional[Dict]:
    return json.loads((HERE / "peaks.json").read_text()).get(kind)


def serve(c: Cell, seed: int, seconds: float, trace: bool, device: str, t0: float,
          control: bool = False) -> Dict:
    """One run; returns the result line's object (``control``: with the
    control's readings under ``"control"``)."""
    dev = torch.device(device)
    server = Server(c, seed, dev)
    server.warm_up()
    server.sync()
    setup_s = time.perf_counter() - t0
    win = server.window(seconds, trace)
    peak = torch.cuda.max_memory_allocated(dev) if server.cuda else 0
    kind = torch.cuda.get_device_name(dev) if server.cuda else "cpu"

    vocab = c.spec["vocab_size"]
    batches = win["batches"]
    bad = [failed_rows(b, vocab) for b in batches]
    attempted = sum(b["batch"] for b in batches)
    failed = int(sum(int(x.sum()) for x in bad))
    record = {"spec": c.spec, "traffic": c.traffic, "counts": server.counts,
              "peaks": peaks(kind), "setup_s": setup_s, "span_s": win["span_s"],
              "rounds": win["rounds"], "trace": win["trace"], "launches": win["launches"],
              "batches": [{k: v for k, v in b.items()
                           if k not in ("prompts", "tokens", "logits")}
                          for b, x in zip(batches, bad) if not bool(x.any())]}
    metrics = {}
    for m in c.metrics:
        value = reader(m["name"])(record)
        if value is None and "moves" not in m:
            raise RuntimeError(f"end-to-end metric {m['name']} read nothing")
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    print(json.dumps({"cell": c.name, "seed": seed, "rounds": len(win["rounds"]),
                      "requests": attempted - failed, "window_s": win["span_s"],
                      "setup_s": setup_s, "launches": win["launches"]}), flush=True)

    rows = [(i, j) for i, x in enumerate(bad) for j in range(len(x)) if not bool(x[j])]
    picked = check.sample([{"prompt": batches[i]["prompts"][j], "at": (i, j)}
                           for i, j in rows], c.traffic["check_requests"], seed)
    requests = [{"prompt": r["prompt"],
                 "tokens": batches[r["at"][0]]["tokens"][:, r["at"][1]],
                 "logits": torch.stack([lg[r["at"][1], :vocab]
                                        for lg in batches[r["at"][0]]["logits"]])}
                for r in picked]
    weights, family, traced = server.weights, server.family, win["trace"]
    del server, batches, win, record
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    read = check.readings(weights, c.spec, family, requests, control)
    checks, correct = check.judge(read, c.limits, failed)
    result = {"correct": correct,
              "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if dev.type == "cuda" else dev.type, "kind": kind,
                         "count": c.chips, "memory_peak_bytes": int(peak)}}
    if traced is not None:
        result["device"].update(busy_s=traced["busy_s"], window_s=traced["window_s"])
        result["breakdown"] = {"device_ops": traced["device_ops"],
                               "idle_gaps": traced["idle_gaps"]}
    elif trace and dev.type == "cuda":
        raise RuntimeError("the profiler saw no device activity in the window")
    if control:
        control_checks, control_correct = check.judge(read, c.limits, failed, "control_")
        result["control"] = {"readings": read, "checks": control_checks,
                             "correct": control_correct}
    result["checks"] = checks
    return result
