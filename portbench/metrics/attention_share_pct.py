"""``attention_share_pct``: the model's attention share of a graph
replay's device time: the nodes labelled ``attention`` inside the
trainer's ``gradient`` and ``boundary`` (``gradient/attention``,
``boundary/attention``: MLA's forward pass, and inside the boundary's jvp
its tangents) over all of the matched launches' device time
(:func:`portbench.labels.share_pct`).  The backward passes run in
autograd's engine after the labelled forward and fall under the outer
labels alone.  Nothing where the program records no such labels."""
from __future__ import annotations

from portbench import labels

NAMES = ("gradient/attention", "boundary/attention")


def read(run):
    return labels.share_pct(run, NAMES)
