"""A profiled slice: ``torch.profiler`` over one call, read from its raw
events.

The device's busy time is the union of its operations' intervals
(kernels, copies, sets; not the device's copies of the harness's spans)
in the slice, and the slice's length the host
clock around the call, which ends in a synchronize.  Operations are
summed by name; the idle gaps between them are named by the innermost
host event under the gap's midpoint (the harness's own spans, the
program's ops and the runtime's calls).
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Tuple

import torch

TOP = 10
NAME = 160                  # the characters of a name the breakdown keeps
SPAN = "portbench."         # the prefix of the harness's own host spans


def _events(prof) -> Tuple[list, list]:
    """(device events, host events) as ``(name, start_ns, end_ns)``."""
    dev, host = [], []
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        item = (e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
        if e.device_type() != cuda:
            host.append(item)
        elif not (e.is_user_annotation() or e.name().startswith(SPAN)):
            dev.append(item)
    return dev, host


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _host_at(host: list, t: float) -> str:
    best = None
    for name, a, b in host:
        if a <= t <= b and (best is None or b - a < best[2] - best[1]):
            best = (name, a, b)
    return best[0] if best else "host"


def profile_slice(call: Callable[[], None], sync: Callable[[], None]) -> dict:
    """``call()`` under the profiler, then ``sync()``.  Returns ``busy_s``,
    ``window_s``, ``ops`` ``{name: [count, seconds]}`` and ``breakdown``
    (the ``TOP`` device operations by time and the ``TOP`` longest idle
    gaps by what the host was doing)."""
    from torch.profiler import ProfilerActivity, profile
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        sync()
        window = time.perf_counter() - t0
    dev, host = _events(prof)
    ops: Dict[str, list] = {}
    for name, a, b in dev:
        c = ops.setdefault(name, [0, 0.0])
        c[0] += 1
        c[1] += (b - a) * 1e-9
    busy = _union([(a, b) for _, a, b in dev])
    gaps = sorted(((busy[i + 1][0] - busy[i][1], busy[i][1], busy[i + 1][0])
                   for i in range(len(busy) - 1)), reverse=True)[:TOP]
    top = sorted(ops.items(), key=lambda kv: -kv[1][1])[:TOP]
    return {
        "busy_s": sum(b - a for a, b in busy) * 1e-9,
        "window_s": window,
        "ops": ops,
        "breakdown": {
            "device_ops": [[name[:NAME], c[1]] for name, c in top],
            "idle_gaps": [[_host_at(host, (a + b) / 2)[:NAME], g * 1e-9]
                          for g, a, b in gaps],
        },
    }


def idle_pct(run):
    """The device's idle share while the window ran: 100 (1 - b r), ``b``
    the device's busy seconds per unit of work in the profiled slice (the
    union of its operations' intervals, over the slice's ``work``) and
    ``r`` the units of work a second of the window, which ran without the
    profiler.  The slice's own wall is not the base: the profiler
    stretches it at each launch (its activity buffers, its hooks on a
    graph's launch).  None without a trace, or where the trace shows no
    device time."""
    t = run.traced
    if not t.get("busy_s") or not t.get("work") or not run.rate:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["work"] * run.rate)


def kernel_seconds(ops: Dict[str, list], symbols) -> Tuple[int, float]:
    """Launches and device seconds of the operations whose name holds one
    of ``symbols``."""
    hits = [c for name, c in ops.items() if any(s in name for s in symbols)]
    return sum(c[0] for c in hits), sum(c[1] for c in hits)
