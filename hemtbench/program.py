#!/usr/bin/env python3
"""The program's own spans joined to a window's device trace, in one process.

    python3 hemtbench/program.py --workload <cell> --seeds 11,12 --seconds <s> [--turns 4]

For each seed it sets the cell up as ``run.py`` does, then runs one window
under both the device trace (``trace.DeviceTrace``) and the program's
recording (``repro_torch.telemetry``), which reads the trace's own clock,
``time.time_ns``. From the two it prints one JSON line:

- ``decode_issue_ms_per_step``: the mean ``decode_step`` span, the host's
  time to issue one decode step, with no synchronisation in it;
- ``decode_kernels_per_step``: device activities from the start of each
  batch's first ``decode_step`` span to the start of the ``observe`` span
  that follows it (after the harness's synchronisation), over the
  batches' decode steps;
- ``dispatch_estimate_err`` (%): over the window's ``observe`` spans that
  carry a prediction, the mean of |``predicted_s`` - ``observed_s``| /
  ``observed_s``: how far the batcher's AR(1) estimate missed;
- ``program_idle``: each idle gap of the card labelled by the innermost
  program span open on the host at the gap's end (the host was then
  issuing the work that ended it), by span path, the top ten; and the
  share of the idle time inside the harness's ``decode`` spans that a
  program span labels;
- ``host_ms_by_kind``: per decode step, each layer kind's host time and
  the step's self time (its residual adds);
- ``faults``: batches without ``output_len - 1`` decode steps, and steps
  whose children's times and self time do not make up the step.

Then, with ``--turns N``, it times N batches of one shape step by step,
the steps taking turns without and with a recording open, and prints
what recording costs a decode step: the median difference of
neighbouring steps. The whole
record goes to ``chiprun_out/program/<cell>.<seed>.json``.
"""
from __future__ import annotations

import argparse
import bisect
import contextlib
import gc
import json
import os
import statistics
import sys
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

ROOT = Path(__file__).resolve().parents[1]
OUTSIDE = "outside any span"
TOP = 10

Event = Tuple[str, int, int]         # (name, start ns, end ns) of a device activity


def paths(spans: Sequence) -> List[str]:
    """Each span's path from its root, names joined by ``/``."""
    out: List[str] = []
    for s in spans:                  # a parent opens, and is listed, before its children
        out.append(s.name if s.parent is None else f"{out[s.parent]}/{s.name}")
    return out


def innermost(spans: Sequence) -> Tuple[List[int], List[Optional[int]]]:
    """Step function of the innermost open span: from ``times[k]`` on, up
    to the next time, span ``index[k]`` (None: no span) is innermost.
    ``spans`` are in the order they opened, each inside its parent."""
    times: List[int] = []
    index: List[Optional[int]] = []

    def mark(t: int, top: Optional[int]) -> None:
        if times and times[-1] == t:
            index[-1] = top
        else:
            times.append(t)
            index.append(top)

    stack: List[int] = []
    for i, s in enumerate(spans):
        while stack and stack[-1] != s.parent:
            mark(spans[stack.pop()].end, stack[-1] if stack else None)
        stack.append(i)
        mark(s.start, i)
    while stack:
        mark(spans[stack.pop()].end, stack[-1] if stack else None)
    return times, index


def _at(t: int, times: List[int], index: List[Optional[int]]) -> Optional[int]:
    k = bisect.bisect_right(times, t) - 1
    return index[k] if k >= 0 else None


def idle_gaps(events: Sequence[Event], start_ns: int, end_ns: int) -> List[Tuple[int, int]]:
    """The card's idle stretches in [start_ns, end_ns], as ``trace.summary``
    finds them."""
    from hemtbench import stats

    busy = stats.union(stats.clip(((s, e) for _, s, e in events), start_ns, end_ns))
    return stats.gaps(busy, start_ns, end_ns)


def program_idle(gaps: Sequence[Tuple[int, int]], spans: Sequence) -> List[List]:
    """[path, gaps, total s, longest s] by the span path open at each gap's
    end, heaviest first."""
    names = paths(spans)
    times, index = innermost(spans)
    agg: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0, 0.0])
    for s, e in gaps:
        i = _at(e, times, index)
        rec = agg[OUTSIDE if i is None else names[i]]
        rec[0] += 1
        rec[1] += (e - s) / 1e9
        rec[2] = max(rec[2], (e - s) / 1e9)
    return sorted(([p, int(n), t, m] for p, (n, t, m) in agg.items()), key=lambda r: -r[2])


def labelled_share(gaps: Sequence[Tuple[int, int]], spans: Sequence,
                   phases: Sequence[Tuple[int, int]]) -> Optional[float]:
    """Of the idle time of the gaps whose middle lies inside ``phases``
    (the harness's ``decode`` spans), the share (%) labelled by a program
    span."""
    times, index = innermost(spans)
    phases = sorted(phases)
    starts = [s for s, _ in phases]
    total = labelled = 0
    for s, e in gaps:
        k = bisect.bisect_right(starts, (s + e) / 2) - 1
        if k < 0 or (s + e) / 2 >= phases[k][1]:
            continue
        total += e - s
        if _at(e, times, index) is not None:
            labelled += e - s
    return 100.0 * labelled / total if total else None


def _decode_steps(spans: Sequence) -> Dict[int, List[int]]:
    """Indices of each batch's ``decode_step`` spans."""
    steps: Dict[int, List[int]] = defaultdict(list)
    for i, s in enumerate(spans):
        if s.name == "decode_step" and s.batch is not None:
            steps[s.batch].append(i)
    return steps


def decode_kernels(events: Sequence[Event], spans: Sequence) -> List[Tuple[int, int, int]]:
    """(batch, device activities, decode steps) for each batch whose steps
    an ``observe`` span follows: activities that start from the batch's
    first step on and before that ``observe`` starts."""
    starts = sorted(s for _, s, _ in events)
    observes = sorted(s.start for s in spans if s.name == "observe")
    out = []
    for batch, idx in sorted(_decode_steps(spans).items()):
        first, last = spans[idx[0]].start, spans[idx[-1]].start
        k = bisect.bisect_right(observes, last)
        if k == len(observes):
            continue
        n = bisect.bisect_left(starts, observes[k]) - bisect.bisect_left(starts, first)
        out.append((batch, n, len(idx)))
    return out


def decode_kernels_per_step(events: Sequence[Event], spans: Sequence) -> Optional[float]:
    per_batch = decode_kernels(events, spans)
    steps = sum(n for _, _, n in per_batch)
    return sum(k for _, k, _ in per_batch) / steps if steps else None


def decode_issue_ms_per_step(spans: Sequence) -> Optional[float]:
    """Mean ``decode_step`` span in ms (a clock in ns)."""
    ds = [s.end - s.start for s in spans if s.name == "decode_step"]
    return sum(ds) / len(ds) / 1e6 if ds else None


def dispatch_estimate_err(spans: Sequence) -> Optional[float]:
    errs = [abs(s.attrs["predicted_s"] - s.attrs["observed_s"]) / s.attrs["observed_s"]
            for s in spans
            if s.name == "observe" and "predicted_s" in s.attrs and s.attrs["observed_s"] > 0]
    return 100.0 * sum(errs) / len(errs) if errs else None


def _children(spans: Sequence) -> Dict[int, List[int]]:
    kids: Dict[int, List[int]] = defaultdict(list)
    for i, s in enumerate(spans):
        if s.parent is not None:
            kids[s.parent].append(i)
    return kids


def host_ms_by_kind(spans: Sequence) -> Dict[str, float]:
    """Per decode step, host ms in each kind of the step's children, and
    ``self``: the step less its children."""
    kids = _children(spans)
    steps = [i for i, s in enumerate(spans) if s.name == "decode_step"]
    out: Dict[str, float] = defaultdict(float)
    for i in steps:
        inner = 0
        for j in kids[i]:
            d = spans[j].end - spans[j].start
            out[spans[j].name] += d
            inner += d
        out["self"] += spans[i].end - spans[i].start - inner
    return {k: v / len(steps) / 1e6 for k, v in out.items()} if steps else {}


def faults(spans: Sequence, output_len: int) -> List[str]:
    """Batches whose decode steps are not ``output_len - 1``, numbered 0
    up, and steps whose children leave its span or overlap."""
    out = []
    for batch, idx in sorted(_decode_steps(spans).items()):
        if [spans[i].attrs["step"] for i in idx] != list(range(output_len - 1)):
            out.append(f"batch {batch}: {len(idx)} decode steps")
    kids = _children(spans)
    for i, s in enumerate(spans):
        if s.name != "decode_step":
            continue
        t = s.start
        for j in kids[i]:
            if spans[j].start < t or spans[j].end > s.end:
                out.append(f"decode_step {i}: child {j} ({spans[j].name}) outside or overlapping")
            t = spans[j].end
    return out


def report(events: Sequence[Event], spans: Sequence, phases: Sequence[Tuple[int, int]],
           start_ns: int, end_ns: int, output_len: int) -> Dict:
    """What one window's device events and program spans give."""
    gaps = idle_gaps(events, start_ns, end_ns)
    return {
        "decode_issue_ms_per_step": decode_issue_ms_per_step(spans),
        "decode_kernels_per_step": decode_kernels_per_step(events, spans),
        "dispatch_estimate_err": dispatch_estimate_err(spans),
        "decode_idle_labelled_share": labelled_share(gaps, spans, phases),
        "program_idle": program_idle(gaps, spans),
        "host_ms_by_kind": host_ms_by_kind(spans),
        "faults": faults(spans, output_len),
    }


def recording_cost(server, batches: int) -> Dict:
    """Decode ms per step, each step synchronised, of one batch shape, the
    steps of a batch taking turns without and with a recording open (the
    first step of each batch alternating), on the same inputs. The host's
    pace drifts over seconds, so neighbouring steps are compared."""
    import torch
    from repro_torch.telemetry import recording

    from hemtbench import traffic as traffic_mod

    tr = server.c.traffic
    length, size = min(tr["prompt_lengths"]), traffic_mod.warmup_batch(tr)
    prefill, decode = server.steps[length]
    gen = torch.Generator(device=server.dev)
    gen.manual_seed(traffic_mod.sub_seed(server.seed, "cost"))
    prompts = torch.randint(0, server.c.spec["vocab_size"], (size, length), generator=gen,
                            device=server.dev)
    ms: Dict[str, List[float]] = {"off": [], "on": []}
    pairs: List[float] = []
    for k in range(batches + 1):                   # the first batch warms the shape up
        tok, state = prefill(server.params, prompts)
        server.sync()
        last = None
        for step in range(tr["output_len"] - 1):
            on = (step + k) % 2 == 1
            t0 = time.perf_counter()
            with recording(time.time_ns) if on else contextlib.nullcontext():
                tok, _, state = decode(server.params, state, tok)
                server.sync()
            dt = 1e3 * (time.perf_counter() - t0)
            if k:
                ms["on" if on else "off"].append(dt)
                if step % 2:
                    pairs.append(dt - last if on else last - dt)
            last = dt
        del state
    off = statistics.median(ms["off"])
    cost = statistics.median(pairs)
    return {"batch": size, "prompt_len": length, "steps": {k: len(v) for k, v in ms.items()},
            "median_off_ms": off, "median_on_ms": statistics.median(ms["on"]),
            "cost_ms_per_step": cost, "cost_share": cost / off, "ms_per_step": ms}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--turns", type=int, default=0)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))

    import torch
    from repro_torch.telemetry import recording

    from hemtbench import bench
    from hemtbench.trace import DeviceTrace

    if not torch.cuda.is_available():
        print("program: needs a CUDA card", file=sys.stderr)
        return 2
    c = bench.cell(bench.load_benchmark(), args.workload, True)
    out_dir = ROOT / "chiprun_out" / "program"
    out_dir.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda")
    for seed in (int(s) for s in args.seeds.split(",")):
        server = bench.Server(c, seed, dev)
        server.warm_up()
        server.sync()
        with DeviceTrace() as tracer, recording(time.time_ns) as rec:
            w0 = time.time_ns()
            win = server.window(args.seconds, trace=False)
            w1 = time.time_ns()
        phases = [(s, e) for kind, s, e in server.spans if kind == "decode"]
        line = {"cell": c.name, "seed": seed,
                "device": torch.cuda.get_device_name(dev),
                "batches": len(win["batches"]), "window_s": (w1 - w0) / 1e9,
                "decode_ms_per_step": bench.reader("decode_ms_per_step")(win),
                "spans": len(rec.spans),
                **report(tracer.events, rec.spans, phases, w0, w1,
                         c.traffic["output_len"])}
        del tracer, win
        if args.turns:
            line["recording_cost"] = recording_cost(server, args.turns)
        (out_dir / f"{c.name}.{seed}.json").write_text(json.dumps(line))
        line["program_idle"] = line["program_idle"][:TOP]
        line["recording_cost"] = {k: v for k, v in line.get("recording_cost", {}).items()
                                  if k != "ms_per_step"}
        print(json.dumps(line), flush=True)
        del server, rec
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
