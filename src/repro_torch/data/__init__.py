"""Data pipeline: deterministic synthetic corpus + HeMT grain sharding."""
from repro_torch.data.pipeline import (  # noqa: F401
    FeederPlacement, SyntheticCorpus, make_batch_specs,
)
from repro_torch.data.grains import Grain, GrainAssignment, GrainSource, plan_grain_ranges  # noqa: F401
