"""SQN state construction (the ``init`` part of :mod:`stochqn_tpu.core.sqn`).

The request protocol (``advance``) is not ported yet (ROADMAP A.10,
slice 2); the fused engine (:mod:`stochqn_tpu_torch.fused`) drives the
state directly.
"""
from __future__ import annotations

import torch

from stochqn_tpu_torch.core.config import SQNConfig
from stochqn_tpu_torch.core.state import SQNState


def init(x0: torch.Tensor, cfg: SQNConfig) -> SQNState:
    if cfg.pairs_bf16:
        raise NotImplementedError(
            "bfloat16 pair state is not ported yet (ROADMAP A.13, slice 5)")
    if cfg.pairs_interleaved:
        raise NotImplementedError(
            "the interleaved pair layout is not ported yet "
            "(ROADMAP A.11, slice 3)")
    if x0.dtype != torch.float32:
        raise NotImplementedError(
            f"SQN state is float32 only, got {x0.dtype} "
            "(float64 is ROADMAP A.13, slice 5)")
    return SQNState.create(x0, cfg.mem_size)
