"""Ecosystem adapters: a ``torch.optim`` oLBFGS and structured-parameter
training.

Counterpart of :mod:`stochqn_tpu.optax_adapter`, whose optax
transformation and pytree trainer become:

* :class:`OLBFGS` (made by :func:`olbfgs`): a ``torch.optim.Optimizer``, to
  drop the optimizer into any PyTorch training loop.  Because such a loop
  delivers one gradient per step, correction pairs are built from
  *consecutive-step* gradient differences (``y_t = g_t - g_{t-1}``, ``s_t``
  = the previous applied update) instead of the protocol's same-batch
  re-evaluation: the online-BFGS formulation of Schraudolph et al. (2007)
  section 3 before the variance-reduction trick, as in the JAX package.
  For exact same-batch pairs use :class:`PytreeTrainer` or
  :mod:`stochqn_tpu_torch.fused`.
* :class:`PytreeTrainer`: full-fidelity fused training (oLBFGS / SQN /
  adaQN, same-batch pairs, jvp Hessian-vector products, function-value
  guard) over structured parameters: a nested dict / list / tuple of
  tensors, or an ``nn.Module``'s parameters.  The structure is flattened
  to the vector the state machines work on, and viewed back for the loss.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Union

import torch

from stochqn_tpu_torch.core.config import OLBFGSConfig
from stochqn_tpu_torch.core.state import BFGSMemory
from stochqn_tpu_torch.fused import FusedTrainer
from stochqn_tpu_torch.ops.pairs import (commit_pair, conditional_flush,
                                         direction_is_bad)
from stochqn_tpu_torch.ops.two_loop import two_loop_cached

ScalarOrSchedule = Union[float, Callable[[int], float]]


class OLBFGS(torch.optim.Optimizer):
    """oLBFGS as a ``torch.optim.Optimizer`` over all its parameters as one
    flat vector.

    ``step()`` reads every parameter's ``.grad`` (a missing one counts as
    zeros), commits the pair formed by the previous step's update and the
    gradient change it produced (vetoed on the first step), takes the
    cached two-loop direction, zeroes it and flushes the memory when it is
    NaN / Inf or too large (``check_nan``), and adds ``-lr * d`` to the
    parameters: the arithmetic of the JAX package's
    ``optax_adapter.olbfgs``.  ``lr`` is a number or a schedule ``lr(k)``
    of the step count ``k`` (0 on the first step).  The memory lives on
    the parameters' device; nothing is read on the host.
    """

    def __init__(self, params, lr: ScalarOrSchedule = 1e-3,
                 mem_size: int = 10, hess_init=None,
                 min_curvature: float = 1e-4, y_reg=None,
                 check_nan: bool = True):
        super().__init__(params, dict(lr=lr))
        self.cfg = OLBFGSConfig.create(
            mem_size=mem_size, hess_init=hess_init,
            min_curvature=min_curvature, y_reg=y_reg, check_nan=check_nan)

    def _params(self):
        return [p for group in self.param_groups for p in group["params"]]

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        params = self._params()
        g = torch.cat([(torch.zeros_like(p) if p.grad is None else p.grad)
                       .reshape(-1) for p in params])
        st = self.state[params[0]]
        if not st:
            st["mem"] = BFGSMemory.create(self.cfg.mem_size, g.shape[0],
                                          g.dtype, device=g.device)
            st["grad_prev"] = torch.zeros_like(g)
            st["upd_prev"] = torch.zeros_like(g)
            st["count"] = 0
        count = st["count"]
        mem = st["mem"].replace(s_pending=st["upd_prev"])
        mem, _ = commit_pair(
            mem, g - st["grad_prev"], self.cfg.min_curvature, self.cfg.y_reg,
            enabled=torch.full((), count > 0, dtype=torch.bool,
                               device=g.device))
        d = two_loop_cached(g, mem, h0=self.cfg.hess_init)
        if self.cfg.check_nan:
            bad = direction_is_bad(d)
            mem = conditional_flush(mem, bad)
            d = torch.where(bad, torch.zeros_like(d), d)
        lr = self.param_groups[0]["lr"]
        upd = -(lr(count) if callable(lr) else lr) * d
        st.update(mem=mem, grad_prev=g, upd_prev=upd, count=count + 1)
        offset = 0
        for p in params:
            p.add_(upd[offset:offset + p.numel()].view_as(p))
            offset += p.numel()
        return loss


def olbfgs(params, learning_rate: ScalarOrSchedule, mem_size: int = 10,
           hess_init=None, min_curvature: float = 1e-4, y_reg=None,
           check_nan: bool = True) -> OLBFGS:
    """The JAX package's ``olbfgs(learning_rate, ...)`` as an
    :class:`OLBFGS` over ``params``."""
    return OLBFGS(params, lr=learning_rate, mem_size=mem_size,
                  hess_init=hess_init, min_curvature=min_curvature,
                  y_reg=y_reg, check_nan=check_nan)


# --------------------------------------------------------------------------
# Structured parameters
# --------------------------------------------------------------------------
def _leaves(tree) -> list:
    """The tensors of a nested dict / list / tuple, dicts in sorted key
    order (the order ``jax.flatten_util.ravel_pytree`` takes)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for part in tree for leaf in _leaves(part)]
    return [tree]


def _rebuild(tree, leaves):
    """``tree``'s structure with ``leaves`` (an iterator, in
    :func:`_leaves` order) in place of its tensors."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(part, leaves) for part in tree)
    return next(leaves)


def _ravel(tree) -> torch.Tensor:
    """The tensors of ``tree`` as one flat vector (a copy, detached)."""
    return torch.cat([t.detach().reshape(-1) for t in _leaves(tree)])


class PytreeTrainer:
    """Fused stochQN training over structured parameters.

    Wraps :class:`stochqn_tpu_torch.fused.FusedTrainer`: the state's flat
    ``x`` is viewed back into the template's structure for ``loss_fn``,
    and ``grad_fn`` is ``torch.func.grad`` of that, so SQN's jvp
    Hessian-vector products (``torch.func.jvp`` over it) work unchanged.

    Args:
      optimizer: "oLBFGS" | "SQN" | "adaQN".
      cfg: the matching config.
      loss_fn: ``loss_fn(params, batch) -> scalar`` tensor, built from
        torch operations, with ``params`` in the template's structure.
      params_template: a nested dict / list / tuple of tensors, or an
        ``nn.Module``, whose structure is then ``dict(named_parameters())``
        (call ``torch.func.functional_call(module, params, args)`` inside
        ``loss_fn``).
      val_data: optional batch on the state's device for adaQN's guard.
      mesh, reduction: a sharded run, as :class:`FusedTrainer` takes them.
        ``reduction`` also says how ``boundary_per_batch`` combines the
        minibatches: ``"mean"`` for a ``loss_fn`` that averages over its
        rows.
      donate: forward of ``FusedTrainer(donate=...)``, off by default:
        the state passed to :meth:`run_epochs` or to the program of
        :meth:`jit_epoch` stays readable; with ``True`` it is consumed
        (keep using the returned state).
      boundary_per_batch: forward of the :class:`FusedTrainer` option:
        SQN's Hessian-vector product taken over the round's minibatches
        one at a time.

    The gradient is taken with respect to the structure's tensors (views
    of ``x``) and concatenated once: a gradient with respect to ``x``
    itself would give each view's backward a zero-filled ``[n]`` buffer.
    """

    def __init__(self, optimizer: str, cfg: Any, loss_fn: Callable,
                 params_template: Any, val_data: Any = None, mesh=None,
                 reduction: str = "sum", donate: bool = False,
                 boundary_per_batch: bool = False):
        if isinstance(params_template, torch.nn.Module):
            params_template = dict(params_template.named_parameters())
        self._template = params_template
        self._shapes = [(t.shape, t.dtype) for t in _leaves(params_template)]
        self.loss_fn = loss_fn
        tree_grad = torch.func.grad(loss_fn)

        def flat_loss(xflat, batch):
            return loss_fn(self.unravel(xflat), batch)

        def flat_grad(xflat, batch):
            grads = tree_grad(self.unravel(xflat), batch)
            return torch.cat([g.reshape(-1).to(xflat.dtype)
                              for g in _leaves(grads)])

        self.trainer = FusedTrainer(optimizer, cfg, flat_grad,
                                    obj_fn=flat_loss, val_data=val_data,
                                    mesh=mesh, reduction=reduction,
                                    donate=donate,
                                    boundary_per_batch=boundary_per_batch)

    def unravel(self, xflat: torch.Tensor):
        """Views of ``xflat`` in the template's structure."""
        parts, offset = [], 0
        for shape, dtype in self._shapes:
            size = math.prod(shape)
            parts.append(xflat[offset:offset + size].view(shape).to(dtype))
            offset += size
        return _rebuild(self._template, iter(parts))

    def init(self, params=None):
        """Fresh state at ``params`` (the template when None); a
        ``nn.Module`` gives its parameters."""
        if isinstance(params, torch.nn.Module):
            params = dict(params.named_parameters())
        return self.trainer.init(
            _ravel(self._template if params is None else params))

    def epoch(self, state, data, step_size, aligned=None):
        return self.trainer.epoch(state, data, step_size, aligned=aligned)

    def jit_epoch(self):
        """:meth:`FusedTrainer.jit_epoch`: on the card one CUDA-graph
        replay per epoch."""
        return self.trainer.jit_epoch()

    def jit_epochs(self):
        """:meth:`FusedTrainer.jit_epochs`: ``fn(state, data, step_size,
        nepochs, aligned=None)``, on the card ``nepochs`` replays of the
        epoch's CUDA graph."""
        return self.trainer.jit_epochs()

    @property
    def eager_only(self) -> bool:
        """:attr:`FusedTrainer.eager_only`."""
        return self.trainer.eager_only

    def run_epochs(self, state, data, nepochs, step_size, **kw):
        """:meth:`FusedTrainer.run_epochs`; with ``donate=True`` the
        passed-in ``state`` is consumed."""
        return self.trainer.run_epochs(state, data, nepochs, step_size, **kw)

    @property
    def cfg(self):
        return self.trainer.cfg

    def params(self, state):
        """Current parameters in the template's structure."""
        return self.unravel(state.x)
