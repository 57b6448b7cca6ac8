"""``run_optimizer_share_pct``: the benchmark's host spans around every
``run_optimizer`` call of the free-mode window, summed, as a share of the
window's wall; the rest is the user's own functions."""
from __future__ import annotations


def read(run):
    share = getattr(run, "call_share", None)
    return None if share is None else 100.0 * share
