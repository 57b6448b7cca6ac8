"""``replay_issue_ms``: the host's time to issue one graph replay, the
mean of the program's span ``stochqn.replay`` (``graph.replay()``, which
returns once the launch is queued), over every replay of the run: the
window's, and the few of the set-up and of the profiled slice.  Nothing
where the program has no such span."""
from __future__ import annotations


def read(run):
    from stochqn_tpu_torch.utils import metrics
    count, total = getattr(metrics, "SPANS", {}).get(
        "stochqn.replay", [0, 0.0])[:2]
    return 1e3 * total / count if count else None
