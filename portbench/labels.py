"""The device time of each labelled layer of a graph replay.

The program names the nodes of each epoch graph it captures by layer
(``stochqn_tpu_torch.utils.metrics.label``) and keeps each graph's map,
``(node_count, [(label, first, end), ...])``, in
``stochqn_tpu_torch.graphs.STATS["labels"]``.  A replay runs those nodes
in order, so the device operations the profiler matches to one
``cudaGraphLaunch`` (by kineto correlation id), in start order, fall to the
labels by position.  A launch is attributed only where its operations
number the ``node_count`` of exactly one distinct map.

The harness's profiled slice (:mod:`portbench.trace`) keeps operations
summed by name, so :func:`launches` profiles slices of its own: a fresh
run of the cell's driver, set up from the run's seed as the run was,
makes its traced calls under the profiler.  The program's tables
(``graphs.STATS``, ``metrics.SPANS`` and ``metrics.COUNTERS``) are put
back as they were after it, so the readers of the run's counters read the
run's.
"""
from __future__ import annotations

import copy
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

LAUNCH = "cudaGraphLaunch"
SPANS = ("portbench.", "stochqn.")   # host spans' copies on the device


def profile_launches(call: Callable[[], None], sync: Callable[[], None]
                     ) -> List[List[Tuple[str, float]]]:
    """``call()`` under the profiler, then ``sync()``: for each
    ``cudaGraphLaunch`` in it, the device operations of that launch as
    ``(name, seconds)`` in start order."""
    from torch.profiler import ProfilerActivity, profile
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        sync()
    cuda = torch.autograd.DeviceType.CUDA
    launched, ops = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda:
            if e.name() == LAUNCH:
                launched.append(e.correlation_id())
        elif not (e.is_user_annotation() or e.name().startswith(SPANS)):
            ops.setdefault(e.correlation_id(), []).append(
                (e.start_ns(), e.name(), e.duration_ns() * 1e-9))
    return [[(name, s) for _, name, s in sorted(ops.get(c, []))]
            for c in launched]


def _profile_again(run) -> Optional[dict]:
    from stochqn_tpu_torch import graphs
    from stochqn_tpu_torch.utils import metrics
    if run.device.type != "cuda" or "labels" not in graphs.STATS:
        return None                     # no card, or a program unlabelled
    stats = copy.deepcopy(graphs.STATS)
    tables = metrics.snapshot()
    again = type(run)(run.ctx)
    got: dict = {}
    first = len(graphs.STATS["labels"])     # set-up captures the graphs
    try:
        again.setup()
        again.profile = lambda call: got.update(
            launches=profile_launches(call, again.sync))
        again.trace()
        got["maps"] = graphs.STATS["labels"][first:]
    finally:
        again.release()
        graphs.STATS.clear()
        graphs.STATS.update(stats)
        metrics.SPANS.clear()
        metrics.SPANS.update(tables["spans"])
        metrics.COUNTERS.update(tables["counters"])
    return got


def launches(run) -> Optional[dict]:
    """``{"launches": [[(name, seconds), ...], ...], "maps": [...]}``:
    the profiled launches and the label maps of the graphs they replay;
    None without a card or where the program records no labels.  Made
    once a run (``run.label_launches``)."""
    if not hasattr(run, "label_launches"):
        run.label_launches = _profile_again(run)
    return run.label_launches


def seconds_by_label(got: Optional[dict]
                     ) -> Optional[Tuple[Dict[str, float], float]]:
    """``({label: device seconds}, device seconds)`` over the launches
    whose operations number the ``node_count`` of exactly one distinct
    map; None where no launch does."""
    if not got:
        return None
    maps: Dict[int, set] = {}
    for count, ranges in got["maps"]:
        maps.setdefault(count, set()).add(tuple(ranges))
    by_label: Dict[str, float] = {}
    total = 0.0
    for ops in got["launches"]:
        found = maps.get(len(ops), ())
        if len(found) != 1:
            continue
        (ranges,) = found
        for name, first, end in ranges:
            by_label[name] = by_label.get(name, 0.0) + sum(
                s for _, s in ops[first:end])
        total += sum(s for _, s in ops)
    return (by_label, total) if total else None


def share_pct(run, names: Sequence[str]) -> Optional[float]:
    """The labels ``names``' share of the matched launches' device time,
    in %; None where no launch matches."""
    got = seconds_by_label(launches(run))
    if got is None:
        return None
    by_label, total = got
    return 100.0 * sum(by_label.get(n, 0.0) for n in names) / total
