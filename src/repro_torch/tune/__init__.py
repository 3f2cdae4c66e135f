"""`repro_torch.tune` — cache-model-guided autotuner with a persistent
tuning DB, the port of ``repro.tune``.

The stack's performance knobs (TOCAB block size, balanced-schedule bins,
engine variant, Beamer α — the paper's Fig. 11 sensitivity axes) are graph-
and device-dependent; this package searches them per (graph fingerprint,
device, dtype):

* :mod:`repro_torch.tune.space`    — declarative search space
  (:class:`Candidate`, :class:`SearchSpace`, trial budgets);
* :mod:`repro_torch.tune.analytic` — cache-model pre-pass pruning
  candidates by predicted DRAM-per-edge before any timing;
* :mod:`repro_torch.tune.runner`   — empirical trials on a device
  (warmup + median-of-k via ``repro_torch.obs`` spans);
* :mod:`repro_torch.tune.db`       — the reference's schema-versioned JSON
  DB under ``experiments/tune/``, keyed by the card's name;
* :mod:`repro_torch.tune.plan`     — read side: ``"auto"`` resolution for
  the engines, tuned-layout builders for callers that can rebuild;
* :mod:`repro_torch.tune.tuner`    — orchestration; ``python -m
  repro_torch.tune`` (``tune`` / ``show`` / ``apply``) is the CLI over
  the suite (:mod:`repro_torch.tune.suite`).
"""
from .space import (  # noqa: F401
    BUDGETS,
    Candidate,
    SearchSpace,
    TrialBudget,
    WORKLOADS,
    default_candidate,
)
from .db import DB_SCHEMA, db_path, default_dir, device_key, entry_key  # noqa: F401
from .plan import (  # noqa: F401
    TunedPlan,
    blocked_for,
    resolve_alpha,
    resolve_impl,
    resolve_plan,
    resolve_schedule,
)
from .runner import Trial, run_trial  # noqa: F401
from .tuner import choose, tune, tune_graph  # noqa: F401
