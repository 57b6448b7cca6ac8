"""``gradient_share_pct``: the minibatch gradient's share of a graph
replay's device time: the nodes labelled ``gradient`` (the ``grad_fn``
call of each SQN step) over all of the matched launches' device time
(:func:`portbench.labels.share_pct`)."""
from __future__ import annotations

from portbench import labels


def read(run):
    return labels.share_pct(run, ("gradient",))
