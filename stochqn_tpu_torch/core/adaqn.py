"""adaQN state construction (the ``init`` part of
:mod:`stochqn_tpu.core.adaqn`).

The request protocol (``advance``) and ``adaQN_free`` wait for the
protocol slice (ROADMAP A.10); the fused engine
(:mod:`stochqn_tpu_torch.fused`) drives the state directly and reproduces
the reference quirks listed in the JAX module.
"""
from __future__ import annotations

import torch

from stochqn_tpu_torch.core.config import AdaQNConfig
from stochqn_tpu_torch.core.state import AdaQNState


def init(x0: torch.Tensor, cfg: AdaQNConfig) -> AdaQNState:
    if cfg.pairs_bf16 or cfg.fisher_bf16:
        raise NotImplementedError(
            "bfloat16 pair or Fisher state is not ported yet "
            "(ROADMAP A.13, slice 5)")
    if x0.dtype != torch.float32:
        raise NotImplementedError(
            f"adaQN state is float32 only, got {x0.dtype} "
            "(float64 is ROADMAP A.13, slice 5)")
    return AdaQNState.create(x0, cfg.mem_size, cfg.fisher_size)
