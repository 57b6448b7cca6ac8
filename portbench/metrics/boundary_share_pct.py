"""``boundary_share_pct``: the round boundary's share of a graph replay's
device time: the nodes labelled ``boundary`` (the big batch, the average,
the Hessian-vector product and the pair commit, once every ``upd_freq``
steps) over all of the matched launches' device time
(:func:`portbench.labels.share_pct`)."""
from __future__ import annotations

from portbench import labels


def read(run):
    return labels.share_pct(run, ("boundary",))
