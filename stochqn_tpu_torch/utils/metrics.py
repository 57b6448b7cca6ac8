"""Observability: the port's spans, counters and kernel labels; the
iteration-info summaries, loss tracking and the profiler's TensorBoard
view.

Counterpart of :mod:`stochqn_tpu.utils.metrics` (its info summaries and
:class:`LossHistory`; the rest has no JAX counterpart).  Three records are
always on, at a call's granularity, never an iteration's:

* :func:`span` ``(name)``: a host span.  While a profiler records (a
  benchmark's, or :func:`trace`) it enters
  ``torch.profiler.record_function(name)``, so it lies on the device
  trace's clock and each idle gap of the device falls under the span that
  covers it; always, it adds its host-clock seconds to :data:`SPANS`
  ``[name] = [count, total_s, max_s]``.  Spans nest; the outermost open
  one gives every span inside it its call's sequence number, the
  ``record_function`` argument.  The
  port's spans: ``stochqn.jit_epochs`` (one call of the single-dispatch
  programs, ``graphs.EpochPrograms.drive``) over ``stochqn.host_read``,
  ``stochqn.load``, ``stochqn.warmup``, ``stochqn.capture`` and
  ``stochqn.replay``; ``stochqn.fit`` (a fused
  ``StochasticLogisticRegression.fit``) over ``stochqn.fit.prepare``,
  ``stochqn.fit.epochs`` and ``stochqn.fit.finish``.
* :data:`COUNTERS`: plain ints.  ``host_reads`` counts every read of the
  device's values on the host that decides the program's control flow
  (:func:`host_read`: a call's ``niter``, free mode's request codes);
  ``copy_in_bytes`` the bytes a graph's buffers take in before a replay;
  ``copy_back_bytes`` the bytes a replay copies back into them.
* :func:`label` ``(name)``: names the CUDA-graph nodes its body records
  while the port captures an epoch (:func:`capturing`); anywhere else it
  does nothing.  Each captured graph's map, ``(node_count, [(label, first,
  end), ...])`` with ``end`` one past the last node, is kept in
  ``graphs.STATS["labels"]``; a replay then runs the same nodes, so the
  profiler's device operations of one replay, in start order, fall to the
  labels by position.  A captured SQN epoch's labels: ``gradient``,
  ``direction``, ``guard``, ``update`` a step, ``boundary`` a round,
  ``infos``, ``copy_back``.

An operator snapshots the records with :func:`snapshot` (copies, safe to
keep) and sets them to zero with :func:`reset`; ``graphs.reset_stats()``
clears the graphs' counts and label maps.  :func:`trace` shows the spans
in TensorBoard above the card's kernels.

The info summaries turn the int32 info codes an epoch driver returns into
counts by name (one copy to the host).
"""
from __future__ import annotations

import contextlib
import ctypes
import itertools
import threading
import time
from collections import Counter
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from stochqn_tpu_torch.core.enums import INFO_NAMES, Info

# name -> [count, total seconds, longest seconds] of every span closed
# since reset()
SPANS: Dict[str, list] = {}
# name -> count since reset()
COUNTERS: Dict[str, int] = {}
_NAMES = ("host_reads", "copy_in_bytes", "copy_back_bytes")
_lock = threading.Lock()
_calls = itertools.count(1)         # the calls' sequence numbers


class _Thread(threading.local):
    capture = None                  # the Capture labels record in

    def __init__(self):
        self.calls: List[int] = []  # the open spans' call numbers


_local = _Thread()


def reset() -> None:
    """Clear :data:`SPANS` and set every counter to 0."""
    with _lock:
        SPANS.clear()
        COUNTERS.update(dict.fromkeys(_NAMES, 0))


reset()


def snapshot() -> dict:
    """Copies of :data:`SPANS` and :data:`COUNTERS`:
    ``{"spans": {...}, "counters": {...}}``."""
    with _lock:
        return {"spans": {k: list(v) for k, v in SPANS.items()},
                "counters": dict(COUNTERS)}


def count(name: str, k: int = 1) -> None:
    """Add ``k`` to the counter ``name``."""
    with _lock:
        COUNTERS[name] = COUNTERS.get(name, 0) + k


class span:
    """``with span(name): ...``: a host span (the module's docstring).
    Its ``record_function`` is entered only while a profiler records."""
    __slots__ = ("name", "_rf", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "span":
        calls = _local.calls
        calls.append(calls[-1] if calls else next(_calls))
        self._rf = None
        if torch.autograd._profiler_enabled():
            self._rf = torch.autograd.profiler.record_function(
                self.name, str(calls[-1]))
            self._rf.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        dt = time.perf_counter() - self._t0
        if self._rf is not None:
            self._rf.__exit__(*exc)
        _local.calls.pop()
        with _lock:
            entry = SPANS.get(self.name)
            if entry is None:
                SPANS[self.name] = [1, dt, dt]
            else:
                entry[0] += 1
                entry[1] += dt
                entry[2] = max(entry[2], dt)


def host_read() -> span:
    """The ``stochqn.host_read`` span around one read of the device's
    values on the host, counted in ``COUNTERS["host_reads"]``."""
    count("host_reads")
    return span("stochqn.host_read")


# -- kernel labels ---------------------------------------------------------- #
class Capture:
    """The labels of one graph being captured.  ``nodes.mark()`` says where
    the capture stands; ``nodes.resolve()``, once the epoch is recorded,
    gives ``(node_count, index)``, ``index(mark)`` the nodes recorded up to
    a mark.  ``marks`` holds the labels met, ``(label, first, end)`` as
    marks."""

    def __init__(self, nodes):
        self.nodes = nodes
        self.marks: List[tuple] = []
        self.open = False               # a label's body is running

    def map(self) -> tuple:
        """``(node_count, [(label, first, end), ...])`` in node indices."""
        count, index = self.nodes.resolve()
        return count, [(name, index(a), index(b))
                       for name, a, b in self.marks]


class _Label:
    __slots__ = ("cap", "name", "first")

    def __init__(self, cap: Capture, name: str):
        self.cap, self.name = cap, name

    def __enter__(self) -> None:
        self.cap.open = True
        self.first = self.cap.nodes.mark()

    def __exit__(self, kind, *exc) -> None:
        self.cap.open = False
        if kind is None:        # a failed capture is void: leave its error
            self.cap.marks.append((self.name, self.first,
                                   self.cap.nodes.mark()))


_NOTHING = contextlib.nullcontext()


def label(name: str):
    """``with label(name): ...``: while this thread captures a graph
    (:func:`capturing`), record the range of nodes the body adds under
    ``name``; a label inside another adds nothing to the outer's.  Outside
    a capture it does nothing: one attribute read."""
    cap = _local.capture
    if cap is None or cap.open:
        return _NOTHING
    return _Label(cap, name)


@contextlib.contextmanager
def capturing(nodes):
    """While this thread captures a graph: :func:`label` records node
    ranges, ``nodes`` saying where the capture stands (:class:`Capture`;
    :class:`GraphNodes` on the card).  Yields the :class:`Capture`."""
    cap = Capture(nodes)
    outer = _local.capture
    _local.capture = cap
    try:
        yield cap
    finally:
        _local.capture = outer


_CU = None


def _libcuda():
    """The CUDA driver's queries of a capture, bound at first use."""
    global _CU
    if _CU is None:
        cu = ctypes.CDLL("libcuda.so.1")
        p = ctypes.POINTER
        cu.cuStreamGetCaptureInfo_v2.argtypes = [
            ctypes.c_void_p, p(ctypes.c_int), p(ctypes.c_uint64),
            p(ctypes.c_void_p), p(p(ctypes.c_void_p)), p(ctypes.c_size_t)]
        cu.cuStreamGetCaptureInfo_v2.restype = ctypes.c_int
        cu.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                       p(ctypes.c_size_t)]
        cu.cuGraphGetNodes.restype = ctypes.c_int
        _CU = cu
    return _CU


class GraphNodes:
    """Where the capture on ``stream`` stands, through the driver (ctypes):
    a mark is the capture's last nodes (``cuStreamGetCaptureInfo``'s
    dependencies), one query a mark; once the epoch is recorded,
    :meth:`resolve` lists the graph's nodes once (``cuGraphGetNodes``, in
    the order they were recorded) and places each mark one past its latest
    node.  Raises where the stream is not capturing or the driver
    refuses."""

    def __init__(self, stream: "torch.cuda.Stream"):
        self.cu = _libcuda()
        self.graph = ctypes.c_void_p()
        self._status = ctypes.c_int()
        self._deps = ctypes.POINTER(ctypes.c_void_p)()
        self._ndeps = ctypes.c_size_t()
        self._query = (ctypes.c_void_p(stream.cuda_stream),
                       ctypes.byref(self._status), None,
                       ctypes.byref(self.graph), ctypes.byref(self._deps),
                       ctypes.byref(self._ndeps))

    def mark(self) -> tuple:
        err = self.cu.cuStreamGetCaptureInfo_v2(*self._query)
        if err or self._status.value != 1:  # CU_STREAM_CAPTURE_STATUS_ACTIVE
            raise RuntimeError(f"cuStreamGetCaptureInfo: error {err}, "
                               f"capture status {self._status.value}")
        return tuple(self._deps[:self._ndeps.value])

    def _nodes(self, into, n) -> None:
        err = self.cu.cuGraphGetNodes(self.graph, into, ctypes.byref(n))
        if err:
            raise RuntimeError(f"cuGraphGetNodes: error {err}")

    def resolve(self) -> tuple:
        self.mark()                         # the graph, while capturing
        n = ctypes.c_size_t()
        self._nodes(None, n)
        nodes = (ctypes.c_void_p * n.value)()
        self._nodes(nodes, n)
        place = {h: i + 1 for i, h in enumerate(nodes)}

        def index(mark: tuple) -> int:
            return max((place[h] for h in mark), default=0)
        return n.value, index


def _host(infos) -> np.ndarray:
    if isinstance(infos, torch.Tensor):
        infos = infos.cpu().numpy()
    return np.asarray(infos).reshape(-1)


def summarize_infos(infos) -> Dict[str, int]:
    """Histogram of per-iteration info codes by name; ``infos`` is the
    ``[B]`` (or ``[epochs, B]``) tensor an epoch driver returns."""
    counts = Counter(int(v) for v in _host(infos))
    return {INFO_NAMES[Info(code)]: cnt for code, cnt in
            sorted(counts.items())}


def problem_iterations(infos) -> np.ndarray:
    """Indices of iterations that reported anything other than
    ``no_problems_encountered``."""
    flat = _host(infos)
    return np.nonzero(flat != int(Info.NO_PROBLEMS_ENCOUNTERED))[0]


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile a training region: ``with trace("tb"): ...``, then open
    ``log_dir`` in TensorBoard.  The card's kernels are traced where
    there is one, the host's operators and the port's spans always."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                str(log_dir))):
        yield


class LossHistory:
    """Epoch-loss tracking with the guided driver's early-stop rule
    (``stochqn/_optimizers.py:271-281``)."""

    def __init__(self, tol: float = 1e-1):
        self.tol = tol
        self.losses = []

    def update(self, loss: float) -> bool:
        """Record a loss; returns True when training should stop."""
        loss = float(loss)
        stop = False
        if self.losses:
            prev = self.losses[-1]
            stop = (prev - loss) < self.tol and loss <= prev
        self.losses.append(loss)
        return stop
