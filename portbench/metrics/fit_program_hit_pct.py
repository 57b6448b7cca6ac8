"""``fit_program_hit_pct``: the share of the run's fused fits that took a
trainer the program kept from an earlier fit, with its captured graphs,
rather than building one (the program's counters ``fit_programs_reused``
and ``fit_programs_built``), in percent, over every fit of the run.
Nothing where the program keeps no such counters."""
from __future__ import annotations


def read(run):
    from stochqn_tpu_torch.utils import metrics
    counters = getattr(metrics, "COUNTERS", {})
    reused = counters.get("fit_programs_reused")
    built = counters.get("fit_programs_built")
    if reused is None or built is None or not reused + built:
        return None
    return 100.0 * reused / (reused + built)
