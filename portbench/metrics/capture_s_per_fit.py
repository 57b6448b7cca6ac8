"""``capture_s_per_fit``: the seconds the program's single-dispatch
programs spent warming up and capturing graphs during the window
(``stochqn_tpu_torch.graphs.STATS``: ``warm_s + capture_s``), per fit."""
from __future__ import annotations


def read(run):
    if not run.attempted or getattr(run, "capture_s", None) is None:
        return None
    return run.capture_s / run.attempted
