"""Plain SQN (Byrd, Hansen, Nocedal and Singer, 2016), as the reference C
code runs it (david-cortes/stochQN, ``run_SQN``), for the benchmark's
check.

Every iteration takes a minibatch gradient ``g``, the L-BFGS direction
``d = H g`` by the classic two-loop recursion over the live pairs
(oldest to newest, ``H0 = gamma I`` with ``gamma = s.y / y.y`` of the
newest pair, 1 with none), the guard (a non-finite ``d`` or ``||d|| > 1e3
n`` leaves ``x`` where it is and empties the memory), ``x -= eta d`` and
``x_sum += x``.  Every ``L`` iterations: ``x_avg = x_sum / L``; the first
time it is only archived; later ``s = x_avg - x_avg_prev``, ``y`` the
Hessian-vector product at ``(x_avg, s)`` on the round's big batch, the
pair kept iff ``s.y / s.s > min_curvature`` (the oldest dropped beyond
``mem_size``), and ``x_avg`` archived either way; ``x_sum`` restarts.

Plain PyTorch and host branches: no cache of the two-loop's small math,
no kernel, nothing of the program under test.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import torch

NO_PROBLEMS, CURVATURE_TOO_SMALL, DIRECTION_WAS_NAN = 200, 202, 203


def two_loop(g: torch.Tensor, S: List[torch.Tensor],
             Y: List[torch.Tensor]) -> torch.Tensor:
    """``H g`` over the pairs ``S``, ``Y`` (oldest first)."""
    q = g.clone()
    rhos = [1.0 / torch.dot(s, y) for s, y in zip(S, Y)]
    alphas = []
    for s, y, rho in zip(reversed(S), reversed(Y), reversed(rhos)):
        a = rho * torch.dot(s, q)
        q -= a * y
        alphas.append(a)
    gamma = (torch.dot(S[-1], Y[-1]) / torch.dot(Y[-1], Y[-1])) if S else 1.0
    r = gamma * q
    for s, y, rho, a in zip(S, Y, rhos, reversed(alphas)):
        b = rho * torch.dot(y, r)
        r += (a - b) * s
    return r


class SQN:
    """The optimizer's state and its two transitions."""

    def __init__(self, x0: torch.Tensor, mem_size: int, upd_freq: int,
                 min_curvature: float = 1e-4):
        self.x = x0.clone()
        self.m, self.L, self.min_curvature = mem_size, upd_freq, min_curvature
        self.x_sum = torch.zeros_like(self.x)
        self.x_avg_prev: Optional[torch.Tensor] = None
        self.S: List[torch.Tensor] = []
        self.Y: List[torch.Tensor] = []
        self.niter = 0

    def step(self, g: torch.Tensor, eta: float) -> int:
        """One iteration before any boundary; returns its info code."""
        d = two_loop(g.to(self.x.dtype), self.S, self.Y)
        norm = float(torch.linalg.vector_norm(d.float()))
        self.niter += 1
        if not norm <= 1e3 * d.shape[0]:
            self.S, self.Y = [], []
            code = DIRECTION_WAS_NAN
        else:
            self.x = self.x - eta * d
            code = NO_PROBLEMS
        self.x_sum += self.x
        return code

    def boundary_due(self) -> bool:
        return self.niter % self.L == 0

    def boundary(self, hessvec: Callable[[torch.Tensor, torch.Tensor],
                                         torch.Tensor]):
        """The pair work after the step that ends a round: ``"first"`` at
        the first (archive only), else whether the pair was kept."""
        x_avg = self.x_sum / self.L
        self.x_sum = torch.zeros_like(self.x)
        if self.x_avg_prev is None:
            self.x_avg_prev = x_avg
            return "first"
        s = x_avg - self.x_avg_prev
        y = hessvec(x_avg, s).to(self.x.dtype)
        self.x_avg_prev = x_avg
        keep = bool(torch.dot(s, y) / torch.dot(s, s) > self.min_curvature)
        if keep:
            self.S.append(s)
            self.Y.append(y)
            if len(self.S) > self.m:
                self.S.pop(0)
                self.Y.pop(0)
        return keep


def run(opt: SQN, steps: int, grad: Callable[[torch.Tensor, int],
                                             torch.Tensor],
        hessvec: Callable[[torch.Tensor, torch.Tensor, int], torch.Tensor],
        eta: Callable[[int], float], start: int = 0) -> list:
    """``steps`` iterations from iteration ``start`` (0-based, counted
    over the whole run): ``grad(x, t)`` on iteration ``t``'s minibatch,
    ``hessvec(x, v, r)`` on round ``r``'s big batch, ``eta(t)`` the step.
    Returns each iteration's events ``(step code, boundary)``, the
    boundary as :meth:`SQN.boundary` gives it, None where there was
    none."""
    events = []
    for t in range(start, start + steps):
        code = opt.step(grad(opt.x, t), eta(t))
        kept = None
        if opt.boundary_due():
            r = opt.niter // opt.L - 1
            kept = opt.boundary(lambda x, v, r=r: hessvec(x, v, r))
        events.append((code, kept))
    return events


def fused_codes(events) -> List[int]:
    """The info code of each iteration as a fused epoch reports it: a
    rejected pair after a later boundary reports ``curvature_too_small``
    in place of the step's code."""
    return [CURVATURE_TOO_SMALL if kept is False else code
            for code, kept in events]


def protocol_calls(events) -> List[tuple]:
    """The free-mode requests and codes that follow the first call's
    ``calc_grad``: ``(task, info)`` of each later ``run_optimizer`` call.
    A step answers with its code and asks for the next gradient, or after
    a later boundary for the Hessian-vector product, whose answer reports
    the commit."""
    calls = []
    for code, kept in events:
        if kept is None or kept == "first":
            calls.append(("calc_grad", code))
        else:
            calls.append(("calc_hess_vec", code))
            calls.append(("calc_grad", NO_PROBLEMS if kept
                          else CURVATURE_TOO_SMALL))
    return calls
