"""``step_mfu``: the whole SQN iteration's share of the card's peak: the
least time of one iteration (``costs/<model>.py``: the larger of its
bytes over the card's memory rate and its flops over its float32 rate,
the boundary's share included) over the window's measured time per
iteration (``1 / iters_per_s``).  Nothing where the card has no row in
``peaks.json``."""
from __future__ import annotations


def read(run):
    import torch
    peaks = run.ctx.peaks.get(torch.cuda.get_device_name(run.device)) \
        if run.device.type == "cuda" else None
    rate = run.end_to_end.get("iters_per_s")
    if not peaks or not rate:
        return None
    flops, nbytes = run.ctx.module("costs").step(run.cfg)
    least = max(flops / peaks["float32_flop_per_s"],
                nbytes / peaks["bytes_per_s"])
    return 100.0 * least * rate
