"""Built-in hemt-lint rules (copy of ``repro/analysis/rules``).

Importing this package registers every rule with the
:mod:`repro_torch.analysis.base` registry — one module per rule, named
``hlNNN_<slug>``.  A later PR adds a rule by dropping a module here and
importing it below; nothing else (CLI, JSON output, waivers, repo
self-check, CI job) needs to change.
"""
from . import hl001_frozen_spec   # noqa: F401
from . import hl002_seeded_rng    # noqa: F401
from . import hl003_wall_clock    # noqa: F401
from . import hl004_float_eq      # noqa: F401
from . import hl005_tracer_safety  # noqa: F401
from . import hl006_arg_mutation  # noqa: F401
