"""The numbers a training check compares, from two records of one run:
the program's and the plain reference's.

A record holds ``xs``, the iterate at each checkpoint (host tensors);
optionally ``codes``, the info code of each iteration or call, ``tasks``,
the free-mode requests in order, and ``pairs``, the live correction pairs
``[S; Y]`` oldest first after the last checkpoint.  Every gap is the
program's distance from the reference over the reference's own size of
the same thing, so it reads the same whatever the scale:

* ``x_gap``: the worst checkpoint's ``||x - x_ref|| / ||x_ref - x0||``;
* ``dx_norm_gap``: at the last checkpoint, the gap between the two
  iterates' distances from ``x0``, over the reference's;
* ``loss_gap``: the worst checkpoint's gap between the two full-data
  losses, over the reference's loss decrease from ``x0``;
* ``pairs_gap``: ``||P - P_ref|| / ||P_ref||`` of the pairs (:data:`OFF`
  where the numbers of live pairs differ);
* ``codes_differ``, ``tasks_differ``: how many codes or requests differ
  (a missing or extra one counts).

A gap that cannot be taken (live pairs in different numbers, a loss that
is not finite) reads :data:`OFF`, a number JSON can carry.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Sequence

import torch

OFF = 1e30


def _count_differ(a: Sequence, b: Sequence) -> float:
    return float(sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b)))


def _ratio(num: float, den: float) -> float:
    if den > 0:
        return num / den
    return 0.0 if num == 0 else OFF


def compare(prog: dict, ref: dict, x0: torch.Tensor,
            loss: Callable[[torch.Tensor], float]) -> Dict[str, float]:
    """The numbers above, for the keys both records hold."""
    x0 = x0.double().cpu()
    xs = [x.double().cpu() for x in prog["xs"]]
    rs = [x.double().cpu() for x in ref["xs"]]
    if len(xs) != len(rs):
        raise ValueError("the records hold different checkpoints")
    out = {"x_gap": max(_ratio(float(torch.linalg.vector_norm(x - r)),
                               float(torch.linalg.vector_norm(r - x0)))
                        for x, r in zip(xs, rs))}
    moved = float(torch.linalg.vector_norm(rs[-1] - x0))
    out["dx_norm_gap"] = _ratio(
        abs(float(torch.linalg.vector_norm(xs[-1] - x0)) - moved), moved)
    f0 = loss(x0)
    gaps = []
    for x, r in zip(xs, rs):
        fx, fr = loss(x), loss(r)
        gaps.append(_ratio(abs(fx - fr), abs(fr - f0)) if math.isfinite(fx)
                    else OFF)
    out["loss_gap"] = max(gaps)
    if "pairs" in ref:
        p, q = prog["pairs"].double(), ref["pairs"].double()
        out["pairs_gap"] = (OFF if p.shape != q.shape else _ratio(
            float(torch.linalg.vector_norm(p - q)),
            float(torch.linalg.vector_norm(q))))
    for key in ("codes", "tasks"):
        if key in ref:
            out[f"{key}_differ"] = _count_differ(prog[key], ref[key])
    return {k: (v if math.isfinite(v) else OFF) for k, v in out.items()}
