"""Fused SQN training engine.

Counterpart of the SQN part of :mod:`stochqn_tpu.fused`.  An epoch runs as
rounds of ``upd_freq`` (L) branch-free base steps — minibatch gradient,
collapsed two-loop direction (the hand-written kernel on CUDA), NaN /
magnitude guard, ``x`` / ``x_sum`` updates — followed once per round by the
boundary: a Hessian-vector product (or big-batch gradient) on the round's
L minibatches and a curvature-gated pair commit.

``lax.scan`` becomes a Python loop.  Every accept/reject, flush and
first-round decision is a device-side ``torch.where``: nothing in
:meth:`FusedTrainer.epochs` with ``aligned=True`` reads a device tensor on
the host, so the loop never waits for the device.

The state is updated in place where that saves copying the pair memory:
the boundary commit rewrites one ring row of ``mem.s`` / ``mem.y``
(``ops.pairs.commit_pair``).  A state passed to :meth:`FusedTrainer.round`,
:meth:`~FusedTrainer.epoch` or :meth:`~FusedTrainer.epochs` is therefore
consumed; use the returned one.

Batches are tensors or (nested) tuples / lists of tensors with a leading
example axis, and epoch data has leaves ``[B, bs, ...]``.
"""
from __future__ import annotations

import dataclasses
import numbers
from typing import Any, Callable, Optional, Tuple

import torch

from stochqn_tpu_torch.core import sqn
from stochqn_tpu_torch.core.config import SQNConfig
from stochqn_tpu_torch.core.enums import Info
from stochqn_tpu_torch.core.state import SQNState
from stochqn_tpu_torch.models.losses import hvp_from_grad
from stochqn_tpu_torch.ops.pairs import (commit_pair, conditional_flush,
                                         direction_is_bad)
from stochqn_tpu_torch.ops.two_loop import two_loop_cached

Batch = Any
GradFn = Callable[[torch.Tensor, Batch], torch.Tensor]
# Optional analytic Hessian-vector product ``hess_vec_fn(x, v, batch) -> [n]``
# (the reference's ``hess_vec_fun``, ``src/stochqn.c:1105-1111``); without
# one the engine uses ``torch.func.jvp`` of ``grad_fn``.
HessVecFn = Callable[[torch.Tensor, torch.Tensor, Batch], torch.Tensor]

_NO_PROB = int(Info.NO_PROBLEMS_ENCOUNTERED)
_NAN = int(Info.SEARCH_DIRECTION_WAS_NAN)
_CURV = int(Info.CURVATURE_TOO_SMALL)


def _tree_map(fn, batch):
    if isinstance(batch, torch.Tensor):
        return fn(batch)
    if isinstance(batch, (tuple, list)):
        return type(batch)(_tree_map(fn, v) for v in batch)
    raise TypeError(f"batch leaves must be tensors, got {type(batch)}")


def _first_leaf(batch) -> torch.Tensor:
    return batch if isinstance(batch, torch.Tensor) else _first_leaf(batch[0])


def _info(bad: torch.Tensor, accepted: Optional[torch.Tensor] = None
          ) -> torch.Tensor:
    info = torch.where(bad, _NAN, _NO_PROB)
    if accepted is not None:
        info = torch.where(accepted, info, _CURV)
    return info.to(torch.int32)


def _step_tensor(step_size, x: torch.Tensor) -> torch.Tensor:
    """``step_size`` as a tensor of ``x``'s dtype on ``x``'s device.  A
    Python number is filled on the device: copying it from the host would
    wait for the device."""
    if isinstance(step_size, numbers.Real):
        return torch.full((), float(step_size), dtype=x.dtype,
                          device=x.device)
    return torch.as_tensor(step_size, dtype=x.dtype, device=x.device)


def _flat(batch):
    """Merge a ``[k, bs, ...]`` stack of minibatches into one big batch,
    example axis major (``[k, bs] -> [bs, k] -> [bs*k]``), the JAX
    package's order, so the big-batch sums run over the same rows in the
    same order."""
    def merge(a):
        a = a.transpose(0, 1)
        return a.reshape((-1,) + tuple(a.shape[2:]))
    return _tree_map(merge, batch)


def _sqn_base(cfg: SQNConfig, grad_fn: GradFn, state: SQNState,
              batch: Batch, step_size: torch.Tensor
              ) -> Tuple[SQNState, torch.Tensor]:
    """The per-iteration work of ``run_SQN`` section 1 before any
    ``upd_freq`` boundary (``src/stochqn.c:1050-1073``)."""
    g = grad_fn(state.x, batch)
    d = two_loop_cached(g, state.mem, collapsed=True)
    bad = (direction_is_bad(d) if cfg.check_nan
           else torch.zeros((), dtype=torch.bool, device=d.device))
    x_new = torch.where(bad, state.x, state.x - step_size * d)
    state = state.replace(x=x_new, mem=conditional_flush(state.mem, bad),
                          niter=state.niter + 1, x_sum=state.x_sum + x_new,
                          section=torch.ones_like(state.section))
    return state, bad


def _sqn_boundary(cfg: SQNConfig, grad_fn: GradFn, state: SQNState,
                  big: Batch, bad: torch.Tensor,
                  hess_vec_fn: Optional[HessVecFn] = None
                  ) -> Tuple[SQNState, torch.Tensor]:
    """The every-``upd_freq`` correction-pair work
    (``src/stochqn.c:1078-1141``), on the already assembled big batch.
    Call exactly when ``niter % upd_freq == 0``.

    Branch-free like the JAX package: the first boundary still evaluates
    the Hessian-vector product and the commit on a meaningless ``s``, and
    vetoes the commit with ``enabled = not first``."""
    st = state
    x_avg = st.x_sum * (1.0 / cfg.upd_freq)
    is_first = st.niter == cfg.upd_freq
    not_first = torch.logical_not(is_first)

    s_cand = x_avg - st.x_avg_prev      # garbage on the first round; vetoed
    mem_p = st.mem.replace(s_pending=s_cand)
    if cfg.use_grad_diff:
        gb = grad_fn(x_avg, big)        # first round: at the archived average
        mem2, acc = commit_pair(mem_p, gb - st.grad_prev, cfg.min_curvature,
                                cfg.y_reg, enabled=not_first,
                                direction_cache=True)
        keep = is_first | acc
        st = st.replace(mem=mem2,
                        grad_prev=torch.where(keep, gb, st.grad_prev),
                        x_avg_prev=torch.where(keep, x_avg, st.x_avg_prev),
                        x_sum=torch.zeros_like(st.x_sum))
    else:
        if hess_vec_fn is not None:
            hv = hess_vec_fn(x_avg, s_cand, big)
        else:
            hv = hvp_from_grad(grad_fn)(x_avg, s_cand, big)
        mem2, acc = commit_pair(mem_p, hv, cfg.min_curvature, y_reg=0.0,
                                enabled=not_first, direction_cache=True)
        # archive happens on first AND (accept or reject) later rounds
        st = st.replace(mem=mem2, x_avg_prev=x_avg,
                        x_sum=torch.zeros_like(st.x_sum))
    info = torch.where(is_first, _info(bad), _info(bad, acc))
    return st, info


@dataclasses.dataclass
class FusedTrainer:
    """Round-chunked fused trainer (SQN only so far).

    Args:
      optimizer: "SQN" (oLBFGS and adaQN are ROADMAP A.11 / A.12).
      cfg: an :class:`SQNConfig`.
      grad_fn: ``grad_fn(x, batch) -> [n]``.
      hess_vec_fn: optional ``hess_vec_fn(x, v, big_batch) -> [n]`` used by
        the boundary in place of ``torch.func.jvp`` of ``grad_fn``;
        ignored with ``cfg.use_grad_diff``.
    """

    optimizer: str
    cfg: SQNConfig
    grad_fn: GradFn
    hess_vec_fn: Optional[HessVecFn] = None

    def __post_init__(self):
        if self.optimizer in ("oLBFGS", "adaQN"):
            raise NotImplementedError(
                f"{self.optimizer} is not ported yet (ROADMAP "
                f"{'A.11, slice 3' if self.optimizer == 'oLBFGS' else 'A.12, slice 4'})")
        if self.optimizer != "SQN":
            raise ValueError(f"unknown optimizer {self.optimizer!r}")
        if not isinstance(self.cfg, SQNConfig):
            raise TypeError(f"SQN needs an SQNConfig, got {type(self.cfg)}")

    def init(self, x0, device=None) -> SQNState:
        """Fresh state at ``x0`` (copied), on ``device`` (default: where
        ``x0`` is, CPU for non-tensors)."""
        return sqn.init(torch.as_tensor(x0, device=device), self.cfg)

    def round(self, state: SQNState, round_data, step_size
              ) -> Tuple[SQNState, torch.Tensor]:
        """One ``upd_freq``-sized round: L branch-free base steps, then the
        boundary once.  ``round_data`` leaves are ``[L, bs, ...]``; the
        round must start with ``niter % upd_freq == 0``.  Returns
        ``(state, infos[L])`` (int32)."""
        L = _first_leaf(round_data).shape[0]
        eta = _step_tensor(step_size, state.x)
        bads = []
        for i in range(L):
            state, bad = _sqn_base(self.cfg, self.grad_fn, state,
                                   _tree_map(lambda a: a[i], round_data),
                                   eta)
            bads.append(bad)
        state, binfo = _sqn_boundary(self.cfg, self.grad_fn, state,
                                     _flat(round_data), bads[-1],
                                     self.hess_vec_fn)
        infos = _info(torch.stack(bads))
        infos[L - 1] = binfo
        return state, infos

    def _epoch_chunked(self, state, data, step_size, num_batches, L):
        rounds = num_batches // L
        data_r = _tree_map(
            lambda a: a.reshape((rounds, L) + tuple(a.shape[1:])), data)
        infos = []
        for r in range(rounds):
            state, inf = self.round(
                state, _tree_map(lambda a: a[r], data_r), step_size)
            infos.append(inf)
        return state, torch.cat(infos)

    def epoch(self, state: SQNState, data, step_size, aligned=None
              ) -> Tuple[SQNState, torch.Tensor]:
        """Run one epoch over ``data`` (leaves ``[B, bs, ...]``) in the
        round-chunked layout.  Returns ``(state, infos[B])``.

        The layout needs ``B % upd_freq == 0`` and an epoch that starts on
        a round boundary (``niter % upd_freq == 0``).  ``aligned=True``
        asserts the latter without reading ``niter``; ``None`` reads it
        once (a host sync).  Other layouts need the generic per-step
        path, which is not ported yet (ROADMAP A.10, slice 2): they
        raise."""
        num_batches = _first_leaf(data).shape[0]
        L = self.cfg.upd_freq
        if num_batches % L != 0 or aligned is False:
            raise NotImplementedError(
                f"an epoch of {num_batches} batches with upd_freq={L} "
                "(or aligned=False) needs the generic per-step path, which "
                "is not ported yet (ROADMAP A.10, slice 2)")
        if aligned is None and int(state.niter) % L != 0:
            raise NotImplementedError(
                "this epoch starts mid-round (niter % upd_freq != 0) and "
                "needs the generic per-step path, which is not ported yet "
                "(ROADMAP A.10, slice 2)")
        return self._epoch_chunked(state, data, step_size, num_batches, L)

    def epochs(self, state: SQNState, data, step_size, nepochs: int,
               aligned=None) -> Tuple[SQNState, torch.Tensor]:
        """Run ``nepochs`` epochs over the same pre-batched ``data`` — the
        counterpart of the function ``jit_epochs()`` returns in the JAX
        package.  ``step_size`` is a scalar (same step every epoch) or a
        ``[nepochs]`` schedule.  Returns ``(state, infos[nepochs, B])``.

        Alignment is resolved once, before the first epoch (see
        :meth:`epoch`); with ``aligned=True`` no device value is read on
        the host."""
        steps = torch.broadcast_to(_step_tensor(step_size, state.x),
                                   (nepochs,))
        if aligned is None:
            L = self.cfg.upd_freq
            aligned = int(state.niter) % L == 0
        infos = []
        for e in range(nepochs):
            state, inf = self.epoch(state, data, steps[e], aligned=aligned)
            infos.append(inf)
        return state, torch.stack(infos)


def batchify(data, batch_size: int):
    """Reshape ``[n, ...]`` leaves into ``[B, batch_size, ...]``, dropping
    the ragged tail."""
    def rs(a):
        nb = a.shape[0] // batch_size
        if nb == 0:
            raise ValueError(
                f"batch_size={batch_size} exceeds the {a.shape[0]} available "
                "rows — no batches would be produced")
        return a[:nb * batch_size].reshape(
            (nb, batch_size) + tuple(a.shape[1:]))
    return _tree_map(rs, data)
