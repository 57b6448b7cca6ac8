"""Static hyperparameter records (the SQN part of
:mod:`stochqn_tpu.core.config`).

Defaults and validation match the JAX package, which follows the reference
Python free-mode constructor (``stochqn/_optimizers.py:1091-1092``) and its
``None -> 0`` sentinel normalization (``stochqn/_optimizers.py:883-908``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


def _norm(value: Optional[float], name: str, positive: bool = True) -> float:
    """Reference semantics: ``None`` means "feature off" and maps to 0."""
    if value is None:
        return 0.0
    value = float(value)
    if positive and value <= 0:
        raise ValueError(f"'{name}' must be positive or None, got {value!r}")
    return value


@dataclasses.dataclass(frozen=True)
class SQNConfig:
    """SQN hyperparameters (Byrd et al., 2016).

    Reference: ``initialize_SQN`` at ``src/stochqn.c:483-506`` and
    ``SQN_free`` at ``stochqn/_optimizers.py:1048-1097``.

    ``pairs_bf16`` and ``pairs_interleaved`` are kept so that a config
    means the same in both packages; this package does not build such
    state yet (``core.sqn.init`` raises).
    """

    mem_size: int = 10
    upd_freq: int = 20           # "bfgs_upd_freq" L: pair every L iterations
    min_curvature: float = 1e-4
    y_reg: float = 0.0
    use_grad_diff: bool = False  # False -> Hessian-vector products
    check_nan: bool = True
    pairs_bf16: bool = False
    pairs_interleaved: bool = False

    @classmethod
    def create(cls, mem_size=10, bfgs_upd_freq=20, min_curvature=1e-4,
               y_reg=None, use_grad_diff=False, check_nan=True,
               pairs_bf16=False, pairs_interleaved=False) -> "SQNConfig":
        if mem_size <= 0 or bfgs_upd_freq <= 0:
            raise ValueError("'mem_size' and 'bfgs_upd_freq' must be positive")
        return cls(
            mem_size=int(mem_size),
            upd_freq=int(bfgs_upd_freq),
            min_curvature=_norm(min_curvature, "min_curvature"),
            y_reg=_norm(y_reg, "y_reg"),
            use_grad_diff=bool(use_grad_diff),
            check_nan=bool(check_nan),
            pairs_bf16=bool(pairs_bf16),
            pairs_interleaved=bool(pairs_interleaved),
        )
