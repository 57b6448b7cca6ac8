"""Observability: iteration-info decoding, loss tracking, profiling.

Counterpart of :mod:`stochqn_tpu.utils.metrics`.  The fused engine returns
an epoch's info codes as one int32 tensor on the state's device; these
helpers turn them into summaries (one copy to the host), and
:func:`trace` wraps ``torch.profiler`` with a TensorBoard trace handler.
"""
from __future__ import annotations

import contextlib
from collections import Counter
from typing import Dict

import numpy as np
import torch

from stochqn_tpu_torch.core.enums import INFO_NAMES, Info


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
    there is one, the host's operators always."""
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
