"""``collective_share_pct``: the exposed collective time of a cell on
several cards: the device time of NCCL's kernels (operations whose name
holds ``nccl``) in rank 0's profiled slice, over the slice's busy time
(the union of its operations' intervals).  A graph replay runs on one
stream, so NCCL's kernels overlap nothing and their time, waits for the
other ranks included, is time the rank's other work did not run.
Nothing where the slice holds no NCCL kernel."""
from __future__ import annotations


def read(run):
    ops = run.traced.get("ops", {})
    busy = run.traced.get("busy_s")
    seconds = sum(c[1] for name, c in ops.items() if "nccl" in name.lower())
    if not seconds or not busy:
        return None
    return 100.0 * seconds / busy
