"""``grouped_mm_roofline``: the grouped product's share of its float32
roofline, from the profiled slice: the least time of its launches
(``costs/grouped_mm.py``, each launch at the mean live rows of one MoE
layer's routing: the share of assignments to the experts held here in the
program's device counter ``expert_tokens`` times the batch's ``T k``
assignments; the larger of its flops over the card's float32 rate and its
bytes over its memory rate) over the device time of the launches of
``grouped_mm_rows`` and ``grouped_mm_wgrad``.  Nothing where the slice
holds no such launch, the program keeps no such counter or the card has
no row in ``peaks.json``."""
from __future__ import annotations

from portbench import trace
from portbench.costs.grouped_mm import cost

SYMBOLS = ("grouped_mm_rows", "grouped_mm_wgrad")


def live_rows(cfg: dict, counts) -> float:
    """The mean live rows of one routing over the MoE layers, from the
    ``[layers, experts]`` counts of assignments."""
    held = cfg["n_routed_experts"]
    shares = [sum(row[:held]) / sum(row) for row in counts if sum(row)]
    if not shares:
        return 0.0
    assignments = cfg["batch_size"] * cfg["seq_len"] \
        * cfg["num_experts_per_tok"]
    return assignments * sum(shares) / len(shares)


def read(run):
    import torch
    from stochqn_tpu_torch.utils import metrics
    peaks = run.ctx.peaks.get(torch.cuda.get_device_name(run.device)) \
        if run.device.type == "cuda" else None
    launches, seconds = trace.kernel_seconds(run.traced.get("ops", {}),
                                             SYMBOLS)
    counts = metrics.snapshot().get("device_counters", {}) \
        .get("expert_tokens")
    if not launches or not peaks or not counts:
        return None
    cfg = run.cfg
    flops, nbytes = cost(live_rows(cfg, counts), cfg["hidden_size"],
                         cfg["moe_intermediate_size"],
                         cfg["n_routed_experts"])
    least = max(flops / peaks["float32_flop_per_s"],
                nbytes / peaks["bytes_per_s"])
    return 100.0 * least * launches / seconds
