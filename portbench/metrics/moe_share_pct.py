"""``moe_share_pct``: the routed experts' share of a graph replay's
device time: the nodes labelled ``router`` (the scores, the top-k, the
sort by expert and the offsets) and ``experts`` (the gather, the grouped
products and the weighted combine) inside the trainer's ``gradient`` and
``boundary``, forward passes (and the boundary's tangents) alone, as
``attention_share_pct`` counts them, over all of the matched launches'
device time (:func:`portbench.labels.share_pct`).  Nothing where the
program records no such labels."""
from __future__ import annotations

from portbench import labels

NAMES = tuple(f"{outer}/{inner}" for outer in ("gradient", "boundary")
              for inner in ("router", "experts"))


def read(run):
    return labels.share_pct(run, NAMES)
