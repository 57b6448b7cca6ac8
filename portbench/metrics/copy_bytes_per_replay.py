"""``copy_bytes_per_replay``: the bytes the program copies into a graph's
static buffers before its replays (``COUNTERS["copy_in_bytes"]``) and
back into them inside each replay (``COUNTERS["copy_back_bytes"]``), over
the replays (``graphs.STATS["replays"]``), every one of the run.
Nothing where the program keeps no such counters."""
from __future__ import annotations


def read(run):
    from stochqn_tpu_torch import graphs
    from stochqn_tpu_torch.utils import metrics
    counters = getattr(metrics, "COUNTERS", {})
    replays = graphs.STATS.get("replays", 0)
    if "copy_back_bytes" not in counters or not replays:
        return None
    return (counters["copy_in_bytes"] + counters["copy_back_bytes"]) \
        / replays
