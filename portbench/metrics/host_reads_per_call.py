"""``host_reads_per_call``: the program's reads of device values on the
host (``stochqn_tpu_torch.utils.metrics.COUNTERS["host_reads"]``) per
``jit_epochs`` call (the count of its span ``stochqn.jit_epochs``), over
every call of the run.  Nothing where the program keeps no such
counter or span."""
from __future__ import annotations


def read(run):
    from stochqn_tpu_torch.utils import metrics
    spans = getattr(metrics, "SPANS", {})
    calls = spans.get("stochqn.jit_epochs", [0])[0]
    if not calls:
        return None
    return metrics.COUNTERS["host_reads"] / calls
