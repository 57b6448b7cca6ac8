"""``prepare_s_per_fit``: the seconds a fused fit spends before its first
epoch (the program's span ``stochqn.fit.prepare``: the inputs checked, the
float64 ``X``, ``y`` and the weights on the card, the trainer, its state
and the batches), per fit (the count of ``stochqn.fit``), over every fit
of the run.  Nothing where the program has no such spans."""
from __future__ import annotations


def read(run):
    from stochqn_tpu_torch.utils import metrics
    spans = getattr(metrics, "SPANS", {})
    fits = spans.get("stochqn.fit", [0])[0]
    if not fits or "stochqn.fit.prepare" not in spans:
        return None
    return spans["stochqn.fit.prepare"][1] / fits
