"""Step-size schedules (reference: ``stochqn/_optimizers.py:24-28``).

This package's own copy of :mod:`stochqn_tpu.utils.schedules`."""
from __future__ import annotations

import numpy as np


def step_size_sqrt(initial_step_size: float, k) -> float:
    """``step0 / sqrt(k + 1)`` — the reference's "auto" schedule."""
    return initial_step_size / np.sqrt(k + 1)


def step_size_const(initial_step_size: float, k) -> float:
    return initial_step_size
