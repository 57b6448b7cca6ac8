"""``direction_roofline``: the SQN direction kernel's share of its
roofline, from the profiled slice: the least time of one direction
(``costs/direction.py`` at the cell's ``m`` and ``n``: the larger of its
bytes over the card's memory rate and its flops over its float32 rate)
over the mean device time of a launch of whichever direction kernel ran
(``direction_one_read`` of ``csrc/direction.cu`` or ``direction_parked``
of ``csrc/direction_streamed.cu``).  Nothing where the slice holds no
such launch or the card has no row in ``peaks.json``."""
from __future__ import annotations

from portbench import trace
from portbench.costs.direction import cost

SYMBOLS = ("direction_one_read", "direction_parked")


def read(run):
    import torch
    peaks = run.ctx.peaks.get(torch.cuda.get_device_name(run.device)) \
        if run.device.type == "cuda" else None
    launches, seconds = trace.kernel_seconds(run.traced.get("ops", {}),
                                             SYMBOLS)
    if not launches or not peaks:
        return None
    n = run.ctx.module("costs").size(run.cfg)
    flops, nbytes = cost(run.cfg["mem_size"], n)
    least = max(flops / peaks["float32_flop_per_s"],
                nbytes / peaks["bytes_per_s"])
    return 100.0 * least / (seconds / launches)
