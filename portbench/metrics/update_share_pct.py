"""``update_share_pct``: the guard's and the update's share of a graph
replay's device time: the nodes labelled ``guard`` (the NaN / magnitude
check of each direction) and ``update`` (``x``, the flush, ``niter`` and
``x_sum``) over all of the matched launches' device time
(:func:`portbench.labels.share_pct`)."""
from __future__ import annotations

from portbench import labels


def read(run):
    return labels.share_pct(run, ("guard", "update"))
