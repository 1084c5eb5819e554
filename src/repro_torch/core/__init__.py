"""The paper's primary contribution: Heterogeneous MacroTasking (HeMT).

Copies of the reference's scheduler core (``repro/core``), with the
reference's package surface; ``bucket_of_torch`` stands where the
reference has ``bucket_of_jnp``.

Submodules:
  estimators  — AR(1) executor speed estimation, fudge-factor probes (§5, §6.2)
  capacity    — token-bucket burstable capacity model, W(t) solver (§6.2)
  partitioner — HomT/HeMT integer partitioners (§4-§5)
  skewed_hash — Algorithm 1 skewed hash partitioner (§7)
  scheduler   — OA-HeMT / provisioned / burstable schedulers (§5-§6)
  straggler   — Claim 1 bound, detection, speculation, elastic re-skew
  speculation — straggler-mitigation policies (speculative copies, work
                stealing, barrier re-skew hand-off) for the engine
  hdfs_model  — Claim 2 storage-contention model (§3)
  simulator   — discrete-event cluster simulator (the paper's testbed)
  engine      — fast-path engine behind the simulator's stage runners
                (event calendar + vectorized closed forms)
  batched     — many-solve planner: the closed forms over [B, n] stacks
                (numpy scan + torch core, Monte-Carlo plan_capacity)
  planner     — HeMT-DP grain planner used by the training runtime
"""
from repro_torch.core.estimators import (  # noqa: F401
    ARSpeedEstimator, FudgeFactorLearner, synchronization_delay,
)
from repro_torch.core.capacity import (  # noqa: F401
    BurstableNode, TokenBucket, burstable_split, solve_finish_time,
)
from repro_torch.core.partitioner import (  # noqa: F401
    even_split, hemt_split_floats, makespan, optimal_makespan,
    proportional_split,
)
from repro_torch.core.skewed_hash import bucket_of, bucket_of_torch, integer_capacities  # noqa: F401
from repro_torch.core.engine import (  # noqa: F401
    AdaptivePlan, JobSchedule, PullSpec, StageSummary, StaticSpec, plan_path,
    run_job, run_job_cache_clear,
)
from repro_torch.core.batched import (  # noqa: F401
    BatchResult, CapacityReport, batched_closed_pull,
    batched_closed_pull_hetero, batched_closed_static, dedup_rows,
    plan_capacity,
)
from repro_torch.core.speculation import (  # noqa: F401
    ReskewHandoff, SpeculativeCopies, WorkStealing,
)
from repro_torch.core.planner import GrainPlanner, SlicePlan, WorkStealingQueue  # noqa: F401
from repro_torch.core.straggler import claim1_bound, detect_stragglers, verify_claim1  # noqa: F401
