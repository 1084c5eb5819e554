"""Batched many-solve planner: the closed forms over ``[B, n]`` stacks.

Every capacity-planning question the HeMT story raises ("how many nodes
hold this traffic at this p99?", "where does the HomT/HeMT crossover sit
on this fleet?") is thousands of *independent* closed-form solves, but
:mod:`repro_torch.core.engine` solves one (cluster, spec) pair at a time — a
Monte-Carlo planner pays Python-loop and cache-lookup overhead per solve.
This module lifts the three dominant closed forms to array form, one
vectorized pass over a stack of clusters:

* :func:`batched_closed_static` — HeMT macrotasks: per-node finish is
  ``overhead + works / speeds``, row makespan its max;
* :func:`batched_closed_pull` — HomT uniform microtasks: ``n_tasks``
  equal pulls of ``task_work`` each;
* :func:`batched_closed_pull_hetero` — heterogeneous FIFO pull of a
  ``[B, T]`` work grid.

Both pull solvers share :func:`pull_scan`, a scan over the task axis
whose per-step state is a ``[B, n]`` end-time matrix — the batched
restatement of the engine's merged-grid ``(end, node)`` heap.  The
``argmin`` per step resolves ties to the lowest node index, which is
exactly the heap's tie-break, and the update arithmetic mirrors the
heap's ``e0 + oh`` then ``+= w / speed`` so the two agree bitwise on the
same row.  The randomized differential suites in ``tests/test_batched.py``
pin all three solvers against scalar :func:`repro_torch.core.engine.run_job`
at 1e-9.

The same scan is exposed in torch form (:func:`pull_scan_torch`: a
loop over the task axis, batched over rows), on any device and
differentiable with respect to the work grid and speeds, so accelerator
code can pick it up without re-deriving the schedule semantics.

Where the scalar path leans on ``run_job``'s module-level solve LRU, the
batched path demotes that cache to **cross-batch de-dup**
(:func:`dedup_rows`): identical rows of a batch are detected up front
with one ``np.unique(axis=0)``, solved once, and scattered back — a
Monte-Carlo sweep whose sampler repeats scenarios (or runs cv=0) pays
one scan per *distinct* row and zero per-solve cache probes.

:func:`plan_capacity` is the Monte-Carlo capacity planner on top: the
smallest fleet size whose ``percentile``-th makespan over sampled speed
jitter meets a target, one batched solve per candidate size.

Copy of the JAX package's ``repro/core/batched.py`` (numpy), with
``pull_scan_jax`` replaced by its torch twin :func:`pull_scan_torch`.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "BatchResult",
    "CapacityReport",
    "batched_closed_pull",
    "batched_closed_pull_hetero",
    "batched_closed_static",
    "dedup_rows",
    "plan_capacity",
    "pull_scan",
    "pull_scan_torch",
]


class BatchResult(NamedTuple):
    """One batch of stage solves, stage-relative (start = 0).

    Mirrors the scalar ``StageSummary`` fields row-wise: ``node_finish``
    are per-node finish *offsets* (0.0 for a node that never ran, like
    the scalar summaries), ``idle`` the finish spread over nodes that
    ran at least one task.
    """
    makespan: np.ndarray       # float64 [B]
    idle: np.ndarray           # float64 [B]
    node_finish: np.ndarray    # float64 [B, n]
    executed: np.ndarray       # float64 [B, n] work run per node
    counts: np.ndarray         # int64   [B, n] tasks run per node


def _as_2d(a, name: str) -> np.ndarray:
    arr = np.atleast_2d(np.asarray(a, dtype=np.float64))
    if arr.ndim != 2:
        raise ValueError(f"{name} must be at most 2-D, got shape {arr.shape}")
    return arr


def _broadcast_overheads(overheads, shape) -> np.ndarray:
    oh = np.asarray(overheads, dtype=np.float64)
    try:
        oh = np.broadcast_to(oh, shape)
    except ValueError:
        raise ValueError(
            f"overheads shape {oh.shape} does not broadcast to "
            f"{shape}") from None
    if np.any(oh < 0.0):
        raise ValueError("overheads must be >= 0")
    return oh


def _check_speeds(sp: np.ndarray) -> None:
    if sp.size and not np.all(sp > 0.0):
        raise ValueError("speeds must be > 0")


def _finish_stats(node_end: np.ndarray, counts: np.ndarray,
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """(makespan, idle) rows from per-node finish offsets; idle spans only
    nodes that ran, matching the scalar summaries."""
    ran = counts > 0
    any_ran = ran.any(axis=1)
    makespan = node_end.max(axis=1) if node_end.size else \
        np.zeros(node_end.shape[0])
    hi = np.where(ran, node_end, -np.inf).max(axis=1, initial=-np.inf)
    lo = np.where(ran, node_end, np.inf).min(axis=1, initial=np.inf)
    idle = np.where(any_ran, hi - lo, 0.0)
    return makespan, idle


def batched_closed_static(speeds, works, overheads=0.0) -> BatchResult:
    """Array-form ``closed-static``: row b, node i finishes its macrotask
    at ``overheads[b, i] + works[b, i] / speeds[b, i]``.

    ``speeds`` and ``works`` broadcast against each other to a common
    ``[B, n]`` (so one split vector can be scored against B sampled speed
    vectors, or vice versa); ``overheads`` broadcasts as scalar, ``[n]``
    or ``[B, n]``.  Counts are all-ones per the scalar engine semantics —
    a zero-work macrotask still pays its pull overhead.
    """
    sp = _as_2d(speeds, "speeds")
    wk = _as_2d(works, "works")
    sp, wk = np.broadcast_arrays(sp, wk)
    _check_speeds(sp)
    if np.any(wk < 0.0):
        raise ValueError("works must be >= 0")
    oh = _broadcast_overheads(overheads, sp.shape)
    fin = oh + wk / sp
    counts = np.ones(sp.shape, dtype=np.int64)
    makespan, idle = _finish_stats(fin, counts)
    return BatchResult(makespan, idle, fin,
                       np.array(wk, dtype=np.float64), counts)


def pull_scan(overheads: np.ndarray, speeds: np.ndarray, works: np.ndarray,
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The batched merged-grid FIFO scan: ``[B, n]`` overheads/speeds and a
    ``[B, T]`` work grid -> per-node ``(finish, counts, executed)``.

    Step state is the ``[B, n]`` end-time matrix ``e``.  The first
    ``min(n, T)`` tasks prime nodes 0..n-1 (the engine's initial pulls);
    every later task goes to each row's ``argmin(e)`` — first index on
    ties, the heap's ``(end, node)`` key.  The update ``base = e + oh``
    then ``+ w / speed`` reproduces the heap arithmetic term-for-term, so
    a batched row is bitwise the scalar scan of that row.
    """
    oh, sp, wk = (np.ascontiguousarray(a, dtype=np.float64)
                  for a in (overheads, speeds, works))
    B, n = sp.shape
    T = wk.shape[1]
    e = np.zeros((B, n), dtype=np.float64)
    counts = np.zeros((B, n), dtype=np.int64)
    executed = np.zeros((B, n), dtype=np.float64)
    k0 = min(n, T)
    if k0:
        e[:, :k0] = oh[:, :k0] + wk[:, :k0] / sp[:, :k0]
        counts[:, :k0] = 1
        executed[:, :k0] = wk[:, :k0]
    if T > k0:
        # Hot loop on flat [B*n] views: per step only the end-time matrix
        # is updated; the winning flat index is logged and counts/executed
        # fold up in two bincounts afterwards.
        ef, ohf, spf = e.reshape(-1), oh.reshape(-1), sp.reshape(-1)
        row_base = np.arange(B, dtype=np.int64) * n
        assign = np.empty((T - k0, B), dtype=np.int64)
        for t, k in enumerate(range(k0, T)):
            idx = row_base + e.argmin(axis=1)
            assign[t] = idx
            ef[idx] = (ef[idx] + ohf[idx]) + wk[:, k] / spf[idx]
        flat = assign.reshape(-1)
        counts += np.bincount(flat, minlength=B * n).reshape(B, n)
        executed += np.bincount(
            flat, weights=wk[:, k0:].T.reshape(-1),
            minlength=B * n).reshape(B, n)
    node_end = np.where(counts > 0, e, 0.0)
    return node_end, counts, executed


def dedup_rows(key: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Cross-batch de-dup — the batched demotion of the scalar solve LRU.

    ``key`` is a ``[B, K]`` matrix where equal rows are guaranteed equal
    solves.  Returns ``(uniq_idx, inverse)``: solve ``key[uniq_idx]``
    (one row per distinct key, first occurrence order) and scatter each
    per-row result with ``result[inverse]`` to recover the full batch.

    Keys are matched on exact bytes (a dict over row buffers, not
    ``np.unique(axis=0)`` — the lexicographic row sort costs more than
    the solves it saves at planner batch sizes).
    """
    key = np.ascontiguousarray(key)
    seen: Dict[bytes, int] = {}
    uniq: list = []
    inverse = np.empty(key.shape[0], dtype=np.int64)
    for b in range(key.shape[0]):
        j = seen.setdefault(key[b].tobytes(), len(uniq))
        if j == len(uniq):
            uniq.append(b)
        inverse[b] = j
    return np.asarray(uniq, dtype=np.int64), inverse


def _pull_batch(oh: np.ndarray, sp: np.ndarray, wk: np.ndarray,
                dedup: bool) -> BatchResult:
    if dedup and sp.shape[0] > 1:
        key = np.hstack([oh, sp, wk])
        uniq_idx, inverse = dedup_rows(key)
        if uniq_idx.size < sp.shape[0]:
            node_end, counts, executed = pull_scan(
                oh[uniq_idx], sp[uniq_idx], wk[uniq_idx])
            node_end, counts, executed = (
                node_end[inverse], counts[inverse], executed[inverse])
            makespan, idle = _finish_stats(node_end, counts)
            return BatchResult(makespan, idle, node_end, executed, counts)
    node_end, counts, executed = pull_scan(oh, sp, wk)
    makespan, idle = _finish_stats(node_end, counts)
    return BatchResult(makespan, idle, node_end, executed, counts)


def batched_closed_pull(speeds, n_tasks: int, task_work, overheads=0.0,
                        *, dedup: bool = True) -> BatchResult:
    """Array-form uniform ``closed-pull``: each row pulls ``n_tasks``
    microtasks of ``task_work`` (scalar or per-row ``[B]``) each.

    Routed through the same scan as the hetero solver — exact by
    construction, including the lowest-node tie-break uniform grids hit
    constantly.  De-dup runs on the compact ``(overheads, speeds,
    task_work)`` key before the grid is expanded.
    """
    if n_tasks < 0:
        raise ValueError("n_tasks must be >= 0")
    sp = _as_2d(speeds, "speeds")
    _check_speeds(sp)
    B, n = sp.shape
    oh = _broadcast_overheads(overheads, sp.shape)
    tw = np.broadcast_to(
        np.asarray(task_work, dtype=np.float64), (B,)).reshape(B, 1)
    if np.any(tw < 0.0):
        raise ValueError("task_work must be >= 0")
    if dedup and B > 1:
        key = np.hstack([oh, sp, tw])
        uniq_idx, inverse = dedup_rows(key)
        if uniq_idx.size < B:
            u = uniq_idx.size
            wk = np.broadcast_to(tw[uniq_idx], (u, max(n_tasks, 1)))
            node_end, counts, executed = pull_scan(
                oh[uniq_idx], sp[uniq_idx], wk[:, :n_tasks])
            node_end, counts, executed = (
                node_end[inverse], counts[inverse], executed[inverse])
            makespan, idle = _finish_stats(node_end, counts)
            return BatchResult(makespan, idle, node_end, executed, counts)
    wk = np.broadcast_to(tw, (B, max(n_tasks, 1)))[:, :n_tasks]
    return _pull_batch(oh, sp, wk, dedup=False)


def batched_closed_pull_hetero(speeds, works, overheads=0.0,
                               *, dedup: bool = True) -> BatchResult:
    """Array-form ``closed-pull-hetero``: row b FIFO-pulls the ``[B, T]``
    work grid ``works[b]`` over speeds ``speeds[b]``.

    ``speeds`` may be ``[n]`` or ``[B, n]`` (a single cluster scored
    against B work grids broadcasts for free); ``works`` may be ``[T]``
    or ``[B, T]``.  ``dedup=True`` collapses identical
    ``(overheads, speeds, works)`` rows to one scan each.
    """
    sp = _as_2d(speeds, "speeds")
    wk = _as_2d(works, "works")
    if sp.shape[0] == 1 and wk.shape[0] > 1:
        sp = np.broadcast_to(sp, (wk.shape[0], sp.shape[1]))
    elif wk.shape[0] == 1 and sp.shape[0] > 1:
        wk = np.broadcast_to(wk, (sp.shape[0], wk.shape[1]))
    if sp.shape[0] != wk.shape[0]:
        raise ValueError(
            f"batch mismatch: speeds {sp.shape} vs works {wk.shape}")
    _check_speeds(sp)
    if np.any(wk < 0.0):
        raise ValueError("works must be >= 0")
    oh = _broadcast_overheads(overheads, sp.shape)
    return _pull_batch(oh, sp, wk, dedup=dedup)


def pull_scan_torch(overheads, speeds, works):
    """torch twin of :func:`pull_scan`: a Python loop over the task axis,
    each step batched over the rows, on the tensors' device and in their
    dtype, and differentiable by autograd with respect to the work grid
    and speeds (makespan gradients for learned split policies).

    Unprimed nodes carry ``+inf`` end times so the argmin never selects
    them before their forced priming turn (step k < n takes node k, the
    engine's initial pulls); ``torch.argmin`` takes the first index on
    ties, the heap's ``(end, node)`` key.  Each step builds its end times,
    counts and executed work out of place, so autograd sees every step
    and no argument is written.  In float64 it reproduces the numpy scan
    at 1e-9.  Returns ``(node_end, counts, executed)`` like the numpy scan.
    """
    import torch

    dev = works.device if torch.is_tensor(works) else None
    wk = torch.as_tensor(works, device=dev)
    sp = torch.as_tensor(speeds, dtype=wk.dtype, device=wk.device)
    oh = torch.as_tensor(overheads, dtype=wk.dtype, device=wk.device)
    B, n = sp.shape
    T = wk.shape[-1]
    cols = torch.arange(n, device=wk.device)
    e = torch.full((B, n), float("inf"), dtype=wk.dtype, device=wk.device)
    cnt = torch.zeros((B, n), dtype=torch.int64, device=wk.device)
    ex = torch.zeros((B, n), dtype=wk.dtype, device=wk.device)
    for k in range(T):
        if k < n:
            i = torch.full((B, 1), k, dtype=torch.int64, device=wk.device)
        else:
            i = torch.argmin(e, dim=1, keepdim=True)
        pick = cols == i
        e_i = e.gather(1, i)
        prev = torch.where(torch.isinf(e_i), torch.zeros_like(e_i), e_i)
        w = wk[:, k:k + 1]
        end = (prev + oh.gather(1, i)) + w / sp.gather(1, i)
        e = torch.where(pick, end, e)
        cnt = cnt + pick.to(torch.int64)
        ex = torch.where(pick, ex + w, ex)
    node_end = torch.where(cnt > 0, e, torch.zeros_like(e))
    return node_end, cnt, ex


class CapacityReport(NamedTuple):
    """Result of :func:`plan_capacity`."""
    chosen: Optional[int]            # smallest passing fleet size, or None
    quantiles: Dict[int, float]      # fleet size -> percentile makespan
    makespans: Dict[int, np.ndarray]  # fleet size -> [samples] makespans
    target: float
    percentile: float
    mode: str


_CAPACITY_MODES = ("hemt", "oracle", "homt")


def plan_capacity(speed_pool: Sequence[float], total_work: float, *,
                  target: float, n_range: Sequence[int], mode: str = "hemt",
                  percentile: float = 99.0, samples: int = 1000,
                  cv: float = 0.2, overhead: float = 0.0, n_tasks: int = 0,
                  seed: int = 0) -> CapacityReport:
    """Monte-Carlo capacity planning: the smallest fleet size whose
    ``percentile``-th makespan meets ``target``.

    For candidate size ``n``, the fleet's advertised means cycle through
    ``speed_pool`` (node j advertises ``speed_pool[j % len(pool)]``);
    each of ``samples`` draws jitters every node's true speed lognormally
    around its mean with coefficient of variation ``cv`` (mean-preserving;
    ``cv=0`` is deterministic, and the pull de-dup then collapses the
    whole batch to a single scan).  Modes:

    * ``"hemt"``   — static split proportional to the *advertised* means
      (what a non-adaptive HeMT planner knows at split time);
    * ``"oracle"`` — split proportional to each sample's *true* speeds,
      the clairvoyant lower envelope;
    * ``"homt"``   — uniform pull of ``n_tasks`` microtasks (default 4
      per node when 0) of ``total_work / n_tasks`` each.
    """
    if mode not in _CAPACITY_MODES:
        raise ValueError(f"mode must be one of {_CAPACITY_MODES}, got {mode!r}")
    pool = np.asarray(list(speed_pool), dtype=np.float64)
    if pool.size == 0 or np.any(pool <= 0.0):
        raise ValueError("speed_pool must be non-empty and > 0")
    sizes = sorted(set(int(n) for n in n_range))
    if not sizes or sizes[0] < 1:
        raise ValueError("n_range must contain sizes >= 1")
    if total_work < 0.0:
        raise ValueError("total_work must be >= 0")
    if target <= 0.0:
        raise ValueError("target must be > 0")
    if samples < 1:
        raise ValueError("samples must be >= 1")
    if cv < 0.0:
        raise ValueError("cv must be >= 0")
    if not 0.0 < percentile <= 100.0:
        raise ValueError("percentile must be in (0, 100]")

    rng = np.random.default_rng(seed)
    quantiles: Dict[int, float] = {}
    makespans: Dict[int, np.ndarray] = {}
    chosen: Optional[int] = None
    for n in sizes:
        means = pool[np.arange(n) % pool.size]
        if cv > 0.0:
            # mean-preserving lognormal jitter (RequestModel idiom):
            # sigma^2 = log(1 + cv^2), mu = log(mean) - sigma^2 / 2
            sigma = np.sqrt(np.log1p(cv * cv))
            mu = np.log(means) - 0.5 * sigma * sigma
            sp = rng.lognormal(mean=mu, sigma=sigma, size=(samples, n))
        else:
            sp = np.broadcast_to(means, (samples, n))
        if mode == "homt":
            k = n_tasks if n_tasks > 0 else 4 * n
            res = batched_closed_pull(sp, k, total_work / k, overhead)
        else:
            if mode == "hemt":
                split = total_work * means / means.sum()
                res = batched_closed_static(sp, split[None, :], overhead)
            else:   # oracle: clairvoyant split on the sampled true speeds
                split = total_work * sp / sp.sum(axis=1, keepdims=True)
                res = batched_closed_static(sp, split, overhead)
        q = float(np.percentile(res.makespan, percentile))
        quantiles[n] = q
        makespans[n] = res.makespan
        if chosen is None and q <= target:
            chosen = n
    return CapacityReport(chosen, quantiles, makespans, target, percentile,
                          mode)
