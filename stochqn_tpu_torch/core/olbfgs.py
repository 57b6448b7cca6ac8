"""oLBFGS transition function (Schraudolph et al., 2007).

Counterpart of :mod:`stochqn_tpu.core.olbfgs`, a functional re-design of
``run_oLBFGS`` (``src/stochqn.c:978-1036``).

Protocol (identical to the reference):

    section 0 -> request ``calc_grad`` at x                        -> 1
    section 1 -> save grad_prev; step ``x -= eta * twoloop(g)``;
                 stash candidate ``s = -eta * d``;
                 request ``calc_grad_same_batch`` at the new x     -> 2
                 (on a bad direction: flush memory, keep x, re-request
                 ``calc_grad``                                     -> 1)
    section 2 -> ``y = g_same_batch - grad_prev (+ y_reg * s)``;
                 curvature-gated pair commit; request ``calc_grad`` -> 1

One correction pair per iteration (``upd_freq = 1``,
``src/stochqn.c:467``).  As in :mod:`stochqn_tpu_torch.core.sqn`,
:func:`advance` reads ``section`` on the host and branches in Python; a
bad direction and the curvature test stay on the device.  :func:`step` is
section 1's work on the iterate and the memory, which the fused engine
(:func:`stochqn_tpu_torch.fused.olbfgs_step`) shares.
"""
from __future__ import annotations

from typing import Tuple

import torch

from stochqn_tpu_torch.core.config import OLBFGSConfig
from stochqn_tpu_torch.core.enums import Task
from stochqn_tpu_torch.core.protocol import (NO_PROBLEMS, AdvanceResult,
                                             check_iterate_dtype, commit_info,
                                             host_ints, no_bad, result, resume,
                                             scalar_like, step_info)
from stochqn_tpu_torch.core.state import OLBFGSState
from stochqn_tpu_torch.ops.pairs import (commit_pair, conditional_flush,
                                         direction_is_bad)
from stochqn_tpu_torch.ops.two_loop import two_loop_cached


def init(x0: torch.Tensor, cfg: OLBFGSConfig) -> OLBFGSState:
    check_iterate_dtype(x0, "oLBFGS")
    return OLBFGSState.create(x0, cfg.mem_size, pairs_bf16=cfg.pairs_bf16,
                              pairs_interleaved=cfg.pairs_interleaved)


def step(cfg: OLBFGSConfig, state: OLBFGSState, grad: torch.Tensor,
         step_size: torch.Tensor, comm=None
         ) -> Tuple[OLBFGSState, torch.Tensor]:
    """Section 1's work on the iterate and the memory
    (``src/stochqn.c:991-1011``): the uncollapsed direction, the NaN /
    magnitude guard, ``x += s`` with the candidate ``s = -eta d`` kept in
    ``s_pending``, the memory flushed on a bad direction (``x`` kept), and
    ``niter + 1``.  ``grad_prev`` and ``section`` are the caller's.
    ``comm``: the mesh of a sharded run
    (:mod:`stochqn_tpu_torch.ops.two_loop`).
    Returns ``(state, bad)``; nothing is read on the host."""
    d = two_loop_cached(grad, state.mem, h0=cfg.hess_init, comm=comm)
    bad = direction_is_bad(d, comm) if cfg.check_nan else no_bad(d)
    s_cand = -step_size * d
    mem = conditional_flush(state.mem.replace(s_pending=s_cand), bad)
    x_new = torch.where(bad, state.x, state.x + s_cand)
    return state.replace(x=x_new, mem=mem, niter=state.niter + 1), bad


def advance(cfg: OLBFGSConfig, state: OLBFGSState, grad: torch.Tensor,
            step_size) -> Tuple[OLBFGSState, AdvanceResult]:
    """One transition of the request protocol: consume the gradient the
    last request asked for (ignored on the very first call), return the
    new state and the next request.  A commit may update the pair memory
    of ``state`` in place, so ``state`` is consumed."""
    st = state
    (section,) = host_ints(st.section)

    if section == 0:
        return resume(st, NO_PROBLEMS, False)

    if section == 1:
        st, bad = step(cfg, st, grad, scalar_like(step_size, st.x))
        good = torch.logical_not(bad)
        # an owned copy: the caller may reuse the buffer it handed over
        st = st.replace(grad_prev=grad.clone(),
                        section=torch.where(bad, 1, 2).to(st.section.dtype))
        task = torch.where(bad, int(Task.CALC_GRAD),
                           int(Task.CALC_GRAD_SAME_BATCH))
        return st, result(task, step_info(bad), good)

    if section == 2:
        mem, accepted = commit_pair(st.mem, grad - st.grad_prev,
                                    cfg.min_curvature, cfg.y_reg)
        return resume(st.replace(mem=mem), commit_info(accepted), False)

    raise ValueError(f"oLBFGS state has section {section}, expected 0..2")
