"""AdaGrad / RMSProp squared-gradient accumulator and diagonal rescaling.

Counterpart of :mod:`stochqn_tpu.ops.accumulators`: ``update_sum_sq``
(``src/stochqn.c:720-747``) and ``diag_rescal``
(``src/stochqn.c:762-783``), elementwise torch ops.
"""
from __future__ import annotations

from typing import Tuple

import torch

from stochqn_tpu_torch.core.protocol import cast_scalar


def rsqrt(t: torch.Tensor) -> torch.Tensor:
    """``1 / sqrt(t)``; a bfloat16 ``t`` through float32 and rounded once,
    as XLA computes it (torch's bfloat16 ``rsqrt`` on the CPU rounds in
    between, a bfloat16 ulp or two from the nearest value)."""
    if t.dtype == torch.bfloat16:
        return torch.rsqrt(t.float()).to(t.dtype)
    return torch.rsqrt(t)


def update_sum_sq(grad: torch.Tensor, grad_sum_sq: torch.Tensor,
                  rmsprop_weight: float) -> torch.Tensor:
    """RMSProp EMA when ``0 < rmsprop_weight < 1``, else AdaGrad sum."""
    if 0.0 < rmsprop_weight < 1.0:
        dt = grad_sum_sq.dtype
        return (cast_scalar(rmsprop_weight, dt) * grad_sum_sq
                + cast_scalar(1.0 - rmsprop_weight, dt) * (grad * grad))
    return grad_sum_sq + grad * grad


def diag_rescal(grad: torch.Tensor, grad_sum_sq: torch.Tensor,
                scal_reg: float, rmsprop_weight: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Update the accumulator, then rescale the gradient by it.

    Returns ``(rescaled, new_grad_sum_sq)`` with
    ``rescaled = grad / sqrt(new_acc + scal_reg)``.  The accumulator is
    updated on every step, also on steps whose direction the NaN check
    rejects later (``src/stochqn.c:765,811,818``).
    """
    acc = update_sum_sq(grad, grad_sum_sq, rmsprop_weight)
    return grad * rsqrt(acc + cast_scalar(scal_reg, acc.dtype)), acc
