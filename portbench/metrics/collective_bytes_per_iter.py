"""``collective_bytes_per_iter``: the payload bytes of the collectives
rank 0 ran in its profiled slice (``stochqn_tpu_torch.parallel.comm``'s
log, a graph's collectives logged at each replay by ``log_replay``),
over the slice's iterations.  A count: it repeats exactly.  Nothing where
the slice ran no collective."""
from __future__ import annotations


def read(run):
    nbytes = run.traced.get("collective_bytes")
    work = run.traced.get("work")
    if not nbytes or not work:
        return None
    return nbytes / work
