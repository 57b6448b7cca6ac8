"""Task / info / status codes for the request-driven optimizer protocol.

A copy of :mod:`stochqn_tpu.core.enums` (same members, same numeric
values), kept separate so that the PyTorch package never imports the JAX
one.  The values mirror the reference's wire protocol
(``include/stochqn.h:268-291``) and its Python-side string mapping
(``stochqn/_optimizers.py:8-21``).
"""
from __future__ import annotations

import enum


class Task(enum.IntEnum):
    """What the optimizer needs evaluated before it can continue."""

    INVALID_INPUT = 100
    CALC_GRAD = 101
    CALC_GRAD_SAME_BATCH = 102   # oLBFGS only: gradient at the new x on the SAME batch
    CALC_GRAD_BIG_BATCH = 103    # SQN / adaQN with use_grad_diff
    CALC_HESS_VEC = 104          # SQN without use_grad_diff
    CALC_FUN_VAL_BATCH = 105     # adaQN with max_incr


class Info(enum.IntEnum):
    """Per-call iteration diagnostics."""

    NO_PROBLEMS_ENCOUNTERED = 200
    FUNC_INCREASED = 201
    CURVATURE_TOO_SMALL = 202
    SEARCH_DIRECTION_WAS_NAN = 203


# String names used in the request dicts of the free-mode API
# (reference: stochqn/_optimizers.py:8-21).
TASK_NAMES = {
    Task.CALC_GRAD: "calc_grad",
    Task.CALC_GRAD_SAME_BATCH: "calc_grad_same_batch",
    Task.CALC_GRAD_BIG_BATCH: "calc_grad_big_batch",
    Task.CALC_HESS_VEC: "calc_hess_vec",
    Task.CALC_FUN_VAL_BATCH: "calc_fun_val_batch",
    Task.INVALID_INPUT: "invalid_input",
}

INFO_NAMES = {
    Info.NO_PROBLEMS_ENCOUNTERED: "no_problems_encountered",
    Info.FUNC_INCREASED: "func_increased",
    Info.CURVATURE_TOO_SMALL: "curvature_too_small",
    Info.SEARCH_DIRECTION_WAS_NAN: "search_direction_was_nan",
}

TASK_BY_NAME = {v: k for k, v in TASK_NAMES.items()}
INFO_BY_NAME = {v: k for k, v in INFO_NAMES.items()}
