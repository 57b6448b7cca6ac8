"""adaQN transition function (Keskar & Berahas, 2016).

Counterpart of :mod:`stochqn_tpu.core.adaqn`, a functional re-design of
``run_adaQN`` (``src/stochqn.c:1155-1315``).

Protocol (identical to the reference):

    section 0 -> request ``calc_grad`` at x                            -> 1
    section 1 -> append grad to Fisher memory; AdaGrad/RMSProp-
                 preconditioned L-BFGS step; ``x_sum += x``;
                 every L iterations:
                   first time: archive averages, then (grad-diff)
                     request big-batch grad at x_avg_prev              -> 2
                     or (max_incr) function value at x_avg_prev        -> 3
                   later: (max_incr) request f at x_avg                -> 5
                     else build s and either request big-batch grad    -> 4
                     or commit the Fisher-product pair inline          -> 1
    section 2 -> store grad_prev; (max_incr) request f at x_avg_prev   -> 3
    section 3 -> store f_prev                                          -> 1
    section 4 -> ``y = g_big - grad_prev``; commit pair                -> 1
    section 5 -> accept/reject on ``f > max_incr * f_prev``:
                   reject: flush BFGS + Fisher memory, revert x to
                     x_avg_prev (``func_increased``)                   -> 1
                   accept: build s; Fisher pair or big-batch request   -> 1/4

Reference quirks reproduced deliberately (trajectory parity):
  * H0 diagonal: see ``AdaQNConfig.h0_exact_reference``.
  * On a rejected (NaN) direction only the BFGS memory is flushed: the
    Fisher flush is commented out in the reference (``src/stochqn.c:1181``).
  * ``x_sum`` is *not* reset on a ``func_increased`` rejection
    (``src/stochqn.c:1275-1283``), so the next window's average folds in the
    rejected window's average once.
  * With ``use_grad_diff`` the reference never refreshes ``x_avg_prev``
    after the first archive (section 4, ``src/stochqn.c:1265-1270``),
    unlike both the Fisher path and SQN.  Reproduced as-is; the Fisher path
    is the default and unaffected.

As in :mod:`stochqn_tpu_torch.core.sqn`, :func:`advance` reads ``section``
and ``niter`` on the host once and branches in Python; section 5 also
reads the guard's verdict, because the next request depends on it.  A bad
direction and the curvature test stay on the device.  :func:`step` is the
per-iteration work alone, shared with the fused engine.
"""
from __future__ import annotations

from typing import Tuple

import torch

from stochqn_tpu_torch.core.config import AdaQNConfig
from stochqn_tpu_torch.core.enums import Info, Task
from stochqn_tpu_torch.core.protocol import (NO_PROBLEMS, AdvanceResult,
                                             cast_scalar, check_iterate_dtype,
                                             commit_info, goto, host_ints,
                                             no_bad, resume, scalar_like,
                                             step_info)
from stochqn_tpu_torch.core.state import AdaQNState
from stochqn_tpu_torch.ops.accumulators import diag_rescal, rsqrt
from stochqn_tpu_torch.ops.pairs import (commit_pair, conditional_flush,
                                         direction_is_bad, fisher_y)
from stochqn_tpu_torch.ops.two_loop import two_loop_cached


def init(x0: torch.Tensor, cfg: AdaQNConfig) -> AdaQNState:
    check_iterate_dtype(x0, "adaQN")
    return AdaQNState.create(x0, cfg.mem_size, cfg.fisher_size,
                             pairs_bf16=cfg.pairs_bf16,
                             fisher_bf16=cfg.fisher_bf16)


def step(cfg: AdaQNConfig, state: AdaQNState, grad: torch.Tensor,
         step_size: torch.Tensor, comm=None
         ) -> Tuple[AdaQNState, torch.Tensor]:
    """The per-iteration adaQN work before any ``upd_freq`` boundary
    (``src/stochqn.c:1170-1197``): the Fisher append
    (``src/stochqn.c:1174``), the AdaGrad / RMSProp rescaling, the
    diagonal-H0 two-loop, the guard, the ``x`` and ``x_sum`` updates,
    ``section = 1``.  A NaN direction flushes the pair memory only.
    ``comm``: the mesh of a sharded run
    (:mod:`stochqn_tpu_torch.ops.two_loop`).
    Returns ``(state, bad)``; nothing is read on the host."""
    if not cfg.use_grad_diff:
        state = state.replace(fisher=state.fisher.append(grad))
    rescaled, acc_sq = diag_rescal(grad, state.grad_sum_sq, cfg.scal_reg,
                                   cfg.rmsprop_weight)
    h0_diag = (rescaled if cfg.h0_exact_reference
               else rsqrt(acc_sq + cast_scalar(cfg.scal_reg, acc_sq.dtype)))
    d_mem = two_loop_cached(grad, state.mem, diag=h0_diag,
                            use_pallas=cfg.use_pallas, coupling=cfg.coupling,
                            comm=comm)
    d = torch.where(state.mem.count > 0, d_mem, rescaled)
    bad = direction_is_bad(d, comm) if cfg.check_nan else no_bad(d)
    x_new = torch.where(bad, state.x, state.x - step_size * d)
    state = state.replace(x=x_new, mem=conditional_flush(state.mem, bad),
                          grad_sum_sq=acc_sq, niter=state.niter + 1,
                          x_sum=state.x_sum + x_new,
                          section=torch.ones_like(state.section))
    return state, bad


def _commit_fisher_pair(cfg: AdaQNConfig, st: AdaQNState, info, changed,
                        x_avg: torch.Tensor
                        ) -> Tuple[AdaQNState, AdvanceResult]:
    """``update_y`` label, Fisher branch (``src/stochqn.c:1297-1308``)."""
    y_cand = fisher_y(st.fisher, st.mem.s_pending)
    mem, accepted = commit_pair(st.mem, y_cand, cfg.min_curvature, y_reg=0.0)
    st = st.replace(
        mem=mem,
        x_avg_prev=torch.where(accepted, x_avg, st.x_avg_prev),
        x_sum=torch.zeros_like(st.x_sum))
    return resume(st, commit_info(accepted, info), changed)


def advance(cfg: AdaQNConfig, state: AdaQNState, grad: torch.Tensor,
            f, step_size) -> Tuple[AdaQNState, AdvanceResult]:
    """One transition of the request protocol: consume the evaluation the
    last request asked for, return the new state and the next request.
    The memories of ``state`` are updated in place (a commit, a ring-mode
    Fisher append), so ``state`` is consumed."""
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
            st = st.replace(x_avg_prev=x_avg,
                            x_sum=torch.zeros_like(st.x_sum))
            if cfg.use_grad_diff:
                return goto(st, 2, Task.CALC_GRAD_BIG_BATCH, info, changed)
            if cfg.max_incr > 0:
                return goto(st, 3, Task.CALC_FUN_VAL_BATCH, info, changed)
            return resume(st, info, changed)
        if cfg.max_incr > 0:
            # evaluate f on the new averages first (src/stochqn.c:1227-1234)
            return goto(st.replace(x_sum=x_avg), 5, Task.CALC_FUN_VAL_BATCH,
                         info, changed)
        st = st.replace(x_sum=x_avg, mem=st.mem.replace(
            s_pending=x_avg - st.x_avg_prev))
        if cfg.use_grad_diff:
            return goto(st, 4, Task.CALC_GRAD_BIG_BATCH, info, changed)
        return _commit_fisher_pair(cfg, st, info, changed, x_avg)

    if section == 2:
        # an owned copy: the caller may reuse the buffer it handed over
        st = st.replace(grad_prev=grad.clone())
        if cfg.max_incr > 0:
            return goto(st, 3, Task.CALC_FUN_VAL_BATCH, NO_PROBLEMS, False)
        return resume(st, NO_PROBLEMS, False)

    f = scalar_like(f, st.x).reshape(())
    if section == 3:
        return resume(st.replace(f_prev=f), NO_PROBLEMS, False)

    if section == 4:
        mem, accepted = commit_pair(st.mem, grad - st.grad_prev,
                                    cfg.min_curvature, cfg.y_reg)
        st = st.replace(
            mem=mem,
            grad_prev=torch.where(accepted, grad, st.grad_prev),
            x_sum=torch.zeros_like(st.x_sum))
        return resume(st, commit_info(accepted), False)

    if section == 5:
        x_avg = st.x_sum        # divided in section 1
        reject = ((f > cast_scalar(cfg.max_incr, f.dtype) * st.f_prev)
                  | torch.logical_not(torch.isfinite(f)))
        if bool(reject):        # read on the host: it picks the next request
            # x_sum deliberately not reset (reference quirk)
            st = st.replace(mem=conditional_flush(st.mem, reject),
                            fisher=st.fisher.flush(),
                            x=st.x_avg_prev.clone())
            return resume(st, int(Info.FUNC_INCREASED), True)
        st = st.replace(f_prev=f, mem=st.mem.replace(
            s_pending=x_avg - st.x_avg_prev))
        if cfg.use_grad_diff:
            return goto(st, 4, Task.CALC_GRAD_BIG_BATCH, NO_PROBLEMS, False)
        return _commit_fisher_pair(cfg, st, NO_PROBLEMS, False, x_avg)

    raise ValueError(f"adaQN state has section {section}, expected 0..5")
