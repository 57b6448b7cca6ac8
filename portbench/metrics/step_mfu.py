"""``step_mfu``: the whole SQN iteration's share of the cell's cards'
peak: the least time of one iteration on the cell's ``chips`` cards
(``costs/<model>.py``: the larger of its bytes over ``chips`` times the
card's memory rate and its flops over ``chips`` times its float32 rate,
the boundary's share included) over the window's measured time per
iteration (``1 / iters_per_s``).  The work is the problem's own, once,
so work that every rank repeats shows as share lost.  Nothing where the
card has no row in ``peaks.json``."""
from __future__ import annotations


def read(run):
    import torch
    peaks = run.ctx.peaks.get(torch.cuda.get_device_name(run.device)) \
        if run.device.type == "cuda" else None
    rate = run.end_to_end.get("iters_per_s")
    if not peaks or not rate:
        return None
    chips = run.ctx.cell["chips"]
    flops, nbytes = run.ctx.module("costs").step(run.cfg)
    least = max(flops / (chips * peaks["float32_flop_per_s"]),
                nbytes / (chips * peaks["bytes_per_s"]))
    return 100.0 * least * rate
