"""SQN transition function (Byrd et al., 2016).

Counterpart of :mod:`stochqn_tpu.core.sqn`, a functional re-design of
``run_SQN`` (``src/stochqn.c:1038-1153``).

Protocol (identical to the reference):

    section 0 -> request ``calc_grad`` at x                            -> 1
    section 1 -> step ``x -= eta * twoloop(g)``; ``x_sum += x``;
                 every L = upd_freq iterations:
                   first time: archive averages; with use_grad_diff also
                     request ``calc_grad_big_batch`` at x_avg_prev     -> 2
                   later: ``s = x_avg - x_avg_prev``; request either
                     ``calc_grad_big_batch`` at x_avg                  -> 3
                     or ``calc_hess_vec`` at (x_avg, s)                -> 4
                 otherwise request ``calc_grad``                       -> 1
    section 2 -> store big-batch gradient as grad_prev                 -> 1
    section 3 -> ``y = g_big - grad_prev``; commit pair; on accept also
                 refresh grad_prev / x_avg_prev; zero x_sum            -> 1
    section 4 -> archive averages; ``y = hess_vec``; commit pair       -> 1

``x_sum`` accumulates even on rejected steps and is divided by exactly L
(``src/stochqn.c:1063-1067``); after division it *is* ``x_avg`` (the
reference aliases the two arrays, ``src/stochqn.c:134``).

Where the JAX package dispatches with ``lax.switch`` / ``lax.cond`` on
device values, :func:`advance` reads ``section`` and ``niter`` on the host
once and branches in Python: which request comes next is host control
flow.  What the data decides (a bad direction, the curvature test) stays
on the device as ``torch.where`` selects.  :func:`step` is the
per-iteration work alone, which the fused engine
(:mod:`stochqn_tpu_torch.fused`) runs without reading anything.
"""
from __future__ import annotations

from typing import Tuple

import torch

from stochqn_tpu_torch.core.config import SQNConfig
from stochqn_tpu_torch.core.enums import Task
from stochqn_tpu_torch.core.protocol import (NO_PROBLEMS, AdvanceResult,
                                             cast_scalar, check_iterate_dtype,
                                             commit_info, goto, host_ints,
                                             no_bad, resume, scalar_like,
                                             step_info)
from stochqn_tpu_torch.core.state import SQNState
from stochqn_tpu_torch.ops.pairs import (commit_pair, conditional_flush,
                                         direction_is_bad)
from stochqn_tpu_torch.ops.two_loop import two_loop_cached


def init(x0: torch.Tensor, cfg: SQNConfig) -> SQNState:
    check_iterate_dtype(x0, "SQN")
    return SQNState.create(x0, cfg.mem_size, pairs_bf16=cfg.pairs_bf16,
                           pairs_interleaved=cfg.pairs_interleaved)


def step(cfg: SQNConfig, state: SQNState, grad: torch.Tensor,
         step_size: torch.Tensor, comm=None
         ) -> Tuple[SQNState, torch.Tensor]:
    """The per-iteration work of ``run_SQN`` section 1 before any
    ``upd_freq`` boundary (``src/stochqn.c:1050-1073``): direction, NaN /
    magnitude guard, ``x`` and ``x_sum`` updates, ``section = 1``.
    ``comm``: the mesh of a sharded run
    (:mod:`stochqn_tpu_torch.ops.two_loop`).
    Returns ``(state, bad)``; nothing is read on the host."""
    d = two_loop_cached(grad, state.mem, collapsed=True, comm=comm)
    bad = direction_is_bad(d, comm) if cfg.check_nan else no_bad(d)
    x_new = torch.where(bad, state.x, state.x - step_size * d)
    state = state.replace(x=x_new, mem=conditional_flush(state.mem, bad),
                          niter=state.niter + 1, x_sum=state.x_sum + x_new,
                          section=torch.ones_like(state.section))
    return state, bad


def advance(cfg: SQNConfig, state: SQNState, grad: torch.Tensor,
            hess_vec: torch.Tensor, step_size
            ) -> Tuple[SQNState, AdvanceResult]:
    """One transition of the request protocol: consume the evaluation the
    last request asked for, return the new state and the next request.
    The pair memory of ``state`` is updated in place by a commit, so
    ``state`` is consumed."""
    st = state
    section, niter = host_ints(st.section, st.niter)
    L = cfg.upd_freq

    if section == 0:
        return resume(st, NO_PROBLEMS, False)

    if section == 1:
        st, bad = step(cfg, st, grad, scalar_like(step_size, st.x))
        info, changed = step_info(bad), torch.logical_not(bad)
        niter += 1
        if niter % L != 0:
            return resume(st, info, changed)
        x_avg = st.x_sum * cast_scalar(1.0 / L, st.x.dtype)
        if niter == L:
            # archive the first averages (src/stochqn.c:1078-1094)
            st = st.replace(x_avg_prev=x_avg,
                            x_sum=torch.zeros_like(st.x_sum))
            if cfg.use_grad_diff:
                return goto(st, 2, Task.CALC_GRAD_BIG_BATCH, info, changed)
            return resume(st, info, changed)
        # build s; keep x_avg in x_sum for the follow-up request
        # (src/stochqn.c:1097-1113)
        st = st.replace(x_sum=x_avg, mem=st.mem.replace(
            s_pending=x_avg - st.x_avg_prev))
        if cfg.use_grad_diff:
            return goto(st, 3, Task.CALC_GRAD_BIG_BATCH, info, changed)
        return goto(st, 4, Task.CALC_HESS_VEC, info, changed)

    if section == 2:
        # an owned copy: the caller may reuse the buffer it handed over
        return resume(st.replace(grad_prev=grad.clone()), NO_PROBLEMS, False)

    if section == 3:
        mem, accepted = commit_pair(st.mem, grad - st.grad_prev,
                                    cfg.min_curvature, cfg.y_reg,
                                    direction_cache=True)
        st = st.replace(
            mem=mem,
            grad_prev=torch.where(accepted, grad, st.grad_prev),
            x_avg_prev=torch.where(accepted, st.x_sum, st.x_avg_prev),
            x_sum=torch.zeros_like(st.x_sum))
        return resume(st, commit_info(accepted), False)

    if section == 4:
        # archive_x_avg happens whether or not the pair is accepted
        # (src/stochqn.c:1136-1141)
        mem, accepted = commit_pair(st.mem, hess_vec, cfg.min_curvature,
                                    y_reg=0.0, direction_cache=True)
        st = st.replace(mem=mem, x_avg_prev=st.x_sum,
                        x_sum=torch.zeros_like(st.x_sum))
        return resume(st, commit_info(accepted), False)

    raise ValueError(f"SQN state has section {section}, expected 0..4")
