"""Data-parallel evaluation: the user's functions on this rank's rows,
summed over the mesh's ``data`` axis.

Counterpart of :mod:`stochqn_tpu.parallel.evaluate`, where ``shard_map``
splits a global batch and ``psum`` reduces.  Here each rank already holds
its rows (:func:`stochqn_tpu_torch.parallel.mesh.shard_batches`), and the
wrappers run the function on them and all-reduce once.  Where the mesh
also splits the parameter axis, the wrapped functions take this rank's
slice of ``x`` (and ``v``): the function sees the full vectors (one
all-gather over the param axis), and the result is cut to this rank's
slice before the data sum, so that sum moves ``n / n_param`` values.

``reduction`` says how the ranks' results combine into the result on the
whole batch:

* ``"sum"``: the function is a (weighted) sum over the rows it is given,
  with no term outside the sum: the ranks' results add up;
* ``"mean"``: the function is a mean over the rows, every term inside the
  mean: the ranks' results are averaged (equal shards).

A term added once per call, such as an l2 penalty on a summed loss, is
counted once per data rank by ``"sum"``: split it (``reg / n_data`` on
each rank), as :class:`stochqn_tpu_torch.models.logistic.
StochasticLogisticRegression` does.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from stochqn_tpu_torch.parallel.mesh import MeshComm


def _reducer(mesh, reduction: str):
    if reduction not in ("sum", "mean"):
        raise ValueError("reduction must be 'sum' or 'mean'")
    comm = mesh if isinstance(mesh, MeshComm) else MeshComm(mesh)

    def reduce(t: torch.Tensor, label: str) -> torch.Tensor:
        t = comm.sum_data(t, label)
        return t / comm.n_data if reduction == "mean" else t
    return comm, reduce


def data_parallel_grad(grad_fn: Callable, mesh, reduction: str = "sum"
                       ) -> Callable:
    """Wrap ``grad_fn(x, batch) -> [..., n]`` into ``g(x, rows) ->
    [..., n / n_param]``: this rank's slice of the gradient on the whole
    batch, from this rank's rows.  ``mesh`` is a ``DeviceMesh`` (or a
    :class:`MeshComm`)."""
    comm, reduce = _reducer(mesh, reduction)

    def local(x, batch):
        (x_full,) = comm.gather_param([x], "gather x")
        return reduce(comm.param_slice(grad_fn(x_full, batch)), "grad")
    return local


def data_parallel_value(obj_fn: Callable, mesh, reduction: str = "sum"
                        ) -> Callable:
    """Same for scalar objectives (adaQN's function-value guard)."""
    comm, reduce = _reducer(mesh, reduction)

    def local(x, batch):
        (x_full,) = comm.gather_param([x], "gather x")
        v = torch.as_tensor(obj_fn(x_full, batch), dtype=x.dtype,
                            device=x.device)
        return reduce(v.reshape(1), "value")[0]
    return local


def data_parallel_hvp(grad_fn: Callable, mesh, reduction: str = "sum",
                      hess_vec_fn: Optional[Callable] = None) -> Callable:
    """Hessian-vector product over a sharded big batch: ``hvp(x, v,
    rows)``.  ``torch.func.jvp`` is taken of the *local* gradient and the
    result summed once, outside the jvp (a sum inside would be
    differentiated and counted again); with ``hess_vec_fn(x, v, batch)``
    that function is evaluated on the rows instead."""
    comm, reduce = _reducer(mesh, reduction)

    def local(x, v, batch):
        x_full, v_full = comm.gather_param([x, v], "gather x, v")
        if hess_vec_fn is not None:
            hv = hess_vec_fn(x_full, v_full, batch)
        else:
            hv = torch.func.jvp(lambda xx: grad_fn(xx, batch), (x_full,),
                                (v_full,))[1]
        return reduce(comm.param_slice(hv), "hvp")
    return local
