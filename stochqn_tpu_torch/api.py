"""High-level one-call training API.

Counterpart of :mod:`stochqn_tpu.api`.  ``minimize`` is the front door for
the fused engine: give it a torch loss, an initial point (flat vector or a
structure of tensors) and batched data; it builds the optimizer, runs
fused epochs and returns the result, the counterpart of the reference's
guided ``fit`` loop.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from stochqn_tpu_torch.core.config import AdaQNConfig, OLBFGSConfig, SQNConfig
from stochqn_tpu_torch.fused import (FusedTrainer, _first_leaf, _flat,
                                     _tree_map, batchify, shuffle_batched)
from stochqn_tpu_torch.optim_adapter import PytreeTrainer
from stochqn_tpu_torch.parallel.mesh import (MeshComm, gather_state,
                                             shard_batches)
from stochqn_tpu_torch.utils.metrics import LossHistory, summarize_infos

_CONFIGS = {"oLBFGS": OLBFGSConfig, "SQN": SQNConfig, "adaQN": AdaQNConfig}


@dataclasses.dataclass
class MinimizeResult:
    x: Any                  # optimized parameters (same structure as x0)
    state: Any              # final optimizer state (checkpointable)
    losses: list            # per-epoch full-data loss (if obj evaluated)
    info_counts: dict       # histogram of iteration info codes
    nepochs_run: int


def minimize(loss_fn: Callable, x0, data, *, optimizer: str = "adaQN",
             step_size: float = 1e-1, batch_size: Optional[int] = None,
             nepochs: int = 25, decr_step_size=None, tol: Optional[float] = None,
             shuffle_key: Optional[torch.Generator] = None, mesh=None,
             reduction: str = "sum", **optimizer_kwargs) -> MinimizeResult:
    """Stochastically minimize ``loss_fn`` over batched data.

    Args:
      loss_fn: ``loss_fn(x, batch) -> scalar`` tensor, built from torch
        operations (``torch.func.grad`` differentiates it); ``x`` has the
        structure of ``x0``.
      x0: initial parameters: a flat vector (a tensor stays on its device;
        a numpy array goes to the card, as ``FusedTrainer.init`` does) or
        a nested dict / list / tuple of tensors.
      data: tensors or numpy arrays (moved to the state's device), either
        already batched ``[B, bs, ...]`` (``batch_size=None``) or
        example-major ``[N, ...]`` with ``batch_size`` given.
      optimizer: "oLBFGS" | "SQN" | "adaQN".
      tol: optional early-stop threshold on the epoch loss decrease
        (guided-driver semantics).
      shuffle_key: a ``torch.Generator`` on the state's device; each epoch
        then reshuffles the rows (:func:`shuffle_batched`).
      mesh: a ``(data, param)`` ``DeviceMesh``
        (:func:`stochqn_tpu_torch.parallel.make_mesh`), one process per
        rank, each passing the full data: every epoch (shuffled with the
        same generator state on every rank) runs on this rank's rows, the
        state shards its parameter axis, and the result's ``x`` and
        ``state`` are the gathered whole.  The epoch losses for ``tol``
        are taken on all the data on every rank.
      reduction: with ``mesh``, how the ranks' gradients and function
        values combine: ``"sum"`` when ``loss_fn`` sums over the rows it
        gets with no term outside the sum, ``"mean"`` when it averages
        over them with every term inside
        (:mod:`stochqn_tpu_torch.parallel.evaluate`).
      **optimizer_kwargs: forwarded to the optimizer config
        (``mem_size``, ``bfgs_upd_freq``, ``max_incr``, ...).
    """
    if optimizer not in _CONFIGS:
        raise ValueError(f"unknown optimizer {optimizer!r}")
    cfg = _CONFIGS[optimizer].create(**optimizer_kwargs)

    is_flat = (isinstance(x0, (torch.Tensor, np.ndarray)) and x0.ndim == 1)
    if is_flat:
        trainer = FusedTrainer(optimizer, cfg, torch.func.grad(loss_fn),
                               obj_fn=loss_fn, mesh=mesh, reduction=reduction)
        state = trainer.init(x0)
        flat_loss = loss_fn
    else:
        trainer = PytreeTrainer(optimizer, cfg, loss_fn, x0, mesh=mesh,
                                reduction=reduction)
        state = trainer.init(x0)
        flat_loss = trainer.trainer.obj_fn

    data = _tree_map(lambda a: torch.as_tensor(a, device=state.x.device),
                     data)
    if batch_size is not None:
        data = batchify(data, batch_size)

    upd_freq = getattr(trainer.cfg, "upd_freq", 1)
    history = LossHistory(tol if tol is not None else float("inf"))
    all_infos, losses = [], []
    epochs_run = 0
    # niter is counted here (a fresh state): no epoch waits for a read
    niter = 0
    num_batches = _first_leaf(data).shape[0]
    epoch_fn = trainer.epoch if trainer.eager_only else trainer.jit_epoch()
    for epoch in range(nepochs):
        eta = (step_size if decr_step_size is None
               else decr_step_size(step_size, epoch))
        d = data if shuffle_key is None else shuffle_batched(data,
                                                             shuffle_key)
        if mesh is not None:                # this rank's rows
            d = shard_batches(d, mesh)
        state, infos = epoch_fn(state, d, eta,
                                aligned=niter % upd_freq == 0)
        niter += num_batches
        all_infos.append(infos)
        epochs_run += 1
        if tol is not None:
            x = state.x if mesh is None else MeshComm(mesh).gather_param(
                [state.x], "gather x")[0]
            loss = float(flat_loss(x, _flat(data)))
            losses.append(loss)
            if history.update(loss):
                break

    if mesh is not None:
        state = gather_state(state, mesh)
    x_out = state.x if is_flat else trainer.params(state)
    return MinimizeResult(
        x=x_out, state=state, losses=losses,
        info_counts=summarize_infos(torch.stack(all_infos)),
        nepochs_run=epochs_run)
