"""Runtime of the port: sharding placements, serving (prefill/decode
steps, HeMT batching), HeMT-DP training (train/grain/apply steps,
``HeMTTrainer``), fault tolerance and elasticity. The re-exports are the
reference's ``repro.runtime`` surface."""
from repro_torch.runtime.sharding import (  # noqa: F401
    axis_rules, batch_shardings, cache_shardings, param_shardings,
    shardings_for, train_state_shardings,
)
from repro_torch.runtime.train_loop import (  # noqa: F401
    TrainState, make_grain_step, make_train_step, train_state_init,
)
from repro_torch.runtime.serve_loop import HeMTBatcher, make_serve_step  # noqa: F401
from repro_torch.runtime.serving import (  # noqa: F401
    RequestModel, ServingReport, ServingScenario, run_round,
)
