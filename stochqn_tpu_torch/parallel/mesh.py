"""The ``(data, param)`` device mesh, and placing states and batches on it.

Counterpart of :mod:`stochqn_tpu.parallel.mesh`.  The JAX package places
global arrays with ``NamedSharding`` and lets GSPMD partition the
programs; here every rank is one process holding plain tensors (explicit
SPMD), and the mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with
the same two dims:

* ``data``: the example axis of every minibatch and big batch is split
  over it; gradients, Hessian-vector products and function values are
  summed over it (:mod:`stochqn_tpu_torch.parallel.evaluate`);
* ``param``: every parameter-axis state field (the iterate, the pair and
  Fisher rows, the averages) holds this rank's even slice of its last
  axis, and the two-loop, the guard and the commit sum their
  n-contractions over it (:class:`MeshComm`).

:func:`shard_state` and :func:`shard_batches` take this rank's part of a
state and of batched data every rank holds in full; :func:`gather_state`
reassembles a sharded state on every rank.  The JAX package's
``epoch_batch_constraint`` has no counterpart: it re-pins the example
axis after a device-side shuffle gather, and the port's drivers take the
rank's rows after that gather themselves.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from stochqn_tpu_torch.parallel.comm import all_gather, all_reduce

DATA_AXIS = "data"
PARAM_AXIS = "param"

# Fields whose trailing dimension is the parameter count ``n`` (the JAX
# package's set).  Matching on names rather than on shape avoids sharding
# the O(m)/O(m^2) small-math caches (gram, bwd_inv, c0, ...) when a small
# model happens to have n == mem_size or n == 2 * mem_size.
_PARAM_AXIS_FIELDS = frozenset({
    "x", "s", "y", "sy", "s_pending", "f", "grad_prev",
    "x_sum", "x_avg_prev", "grad_sum_sq",
})


def make_mesh(n_data: Optional[int] = None, n_param: int = 1,
              device_type: Optional[str] = None) -> DeviceMesh:
    """A ``(data, param)`` mesh over every rank of the process group
    (formed by :func:`stochqn_tpu_torch.parallel.distributed.initialize`
    or ``torch.distributed.init_process_group``).  ``n_data`` defaults to
    ``world_size // n_param``.  ``device_type`` defaults to the card and
    raises where there is none; pass ``"cpu"`` for a CPU mesh (gloo)."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a process group: call "
            "stochqn_tpu_torch.parallel.distributed.initialize() first")
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_param
    if n_data * n_param != world:
        raise ValueError(
            f"mesh {n_data}x{n_param} does not match {world} ranks")
    if device_type is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh builds a mesh of NVIDIA GPUs by default and none "
                "is available; pass device_type='cpu' for a CPU mesh")
        device_type = "cuda"
    return init_device_mesh(device_type, (n_data, n_param),
                            mesh_dim_names=(DATA_AXIS, PARAM_AXIS))


def mesh_shape(mesh: DeviceMesh) -> Tuple[int, int]:
    """``(n_data, n_param)``; raises ``TypeError`` for anything but a
    ``DeviceMesh`` with the dims ``("data", "param")``."""
    if not (isinstance(mesh, DeviceMesh)
            and mesh.mesh_dim_names == (DATA_AXIS, PARAM_AXIS)):
        raise TypeError(
            f"a mesh is a DeviceMesh with dims ({DATA_AXIS!r}, "
            f"{PARAM_AXIS!r}) (parallel.make_mesh), got {mesh!r}")
    names = mesh.mesh_dim_names
    return (mesh.size(names.index(DATA_AXIS)),
            mesh.size(names.index(PARAM_AXIS)))


def _sum_together(parts: Sequence[torch.Tensor], group, label: str):
    """Independent sums in one all-reduce of their concatenation."""
    flat = torch.cat([p.reshape(-1) for p in parts])
    all_reduce(flat, group, label)
    out, at = [], 0
    for p in parts:
        out.append(flat[at:at + p.numel()].reshape(p.shape))
        at += p.numel()
    return tuple(out)


def capturable(group) -> bool:
    """Whether ``group``'s collectives can be captured in a CUDA graph:
    NCCL's run as kernels on the card; gloo's run on the host."""
    backend = str(dist.get_backend(group))
    return backend == "nccl" or "cuda:nccl" in backend


class MeshComm:
    """This rank's place in a ``(data, param)`` mesh, and the sums over it
    that the engine and the ops run.  ``None`` in place of one means no
    mesh: every sum is then the identity.

    ``capturable``: whether both groups' collectives can be captured in a
    CUDA graph (NCCL groups).  Every sum here allocates and copies on the
    device only (``torch.cat`` and slices, a clone, a zero buffer and a
    slice assignment), so nothing but the collective decides it."""

    def __init__(self, mesh: DeviceMesh):
        self.mesh = mesh
        self.n_data, self.n_param = mesh_shape(mesh)
        self.data_group = mesh.get_group(DATA_AXIS)
        self.param_group = mesh.get_group(PARAM_AXIS)
        self.data_rank = mesh.get_local_rank(DATA_AXIS)
        self.param_rank = mesh.get_local_rank(PARAM_AXIS)
        self.capturable = (capturable(self.data_group)
                           and capturable(self.param_group))

    def sum_param(self, parts: Sequence[torch.Tensor], label: str):
        """The parts (one dtype) summed over the param axis in one
        all-reduce; returned as they are where the axis has one rank."""
        if self.n_param == 1:
            return tuple(parts)
        return _sum_together(parts, self.param_group, label)

    def sum_data(self, t: torch.Tensor, label: str) -> torch.Tensor:
        """``t`` summed over the data axis (always a collective, a group of
        one included), into a copy: ``t`` may be what a user's function
        returned, and stays as it was."""
        return all_reduce(t.clone(memory_format=torch.contiguous_format),
                          self.data_group, label)

    def gather_param(self, parts: Sequence[torch.Tensor], label: str):
        """Full vectors from this rank's slices (one all-gather for all
        of them); returned as they are where the axis has one rank."""
        if self.n_param == 1:
            return tuple(parts)
        return tuple(all_gather(torch.stack(list(parts)), self.param_group,
                                label).unbind(0))

    def param_slice(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's even slice of the last axis of ``full``."""
        if self.n_param == 1:
            return full
        k = full.shape[-1] // self.n_param
        return full[..., self.param_rank * k:(self.param_rank + 1) * k]


def _map_fields(state, fn):
    """``state`` with ``fn(name, tensor)`` applied to every tensor field,
    nested dataclasses walked."""
    if not dataclasses.is_dataclass(state):
        return state
    changes = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if isinstance(v, torch.Tensor):
            changes[f.name] = fn(f.name, v)
        elif dataclasses.is_dataclass(v):
            changes[f.name] = _map_fields(v, fn)
    return dataclasses.replace(state, **changes)


def shard_state(state, mesh: DeviceMesh):
    """This rank's part of an optimizer state (or of a memory) every rank
    holds in full: its even slice (an owned copy) of the last axis of
    every field in :data:`_PARAM_AXIS_FIELDS`, every other field as it
    is.  The param axis must divide ``n``."""
    comm = MeshComm(mesh)
    if comm.n_param == 1:
        return state

    def place(name, t):
        if name in _PARAM_AXIS_FIELDS and t.ndim >= 1:
            if t.shape[-1] % comm.n_param:
                raise ValueError(
                    f"the mesh's param axis ({comm.n_param}) must divide "
                    f"the parameter count n={t.shape[-1]}")
            return comm.param_slice(t).clone()
        return t
    return _map_fields(state, place)


def gather_state(state, mesh: DeviceMesh):
    """The full state from every rank's part (one all-gather per
    parameter-axis field over the param axis), on every rank; the
    inverse of :func:`shard_state`, for ``coef_``, prediction and
    ``.npz`` checkpoints."""
    comm = MeshComm(mesh)
    if comm.n_param == 1:
        return state

    def place(name, t):
        if name in _PARAM_AXIS_FIELDS and t.ndim >= 1:
            return all_gather(t.contiguous(), comm.param_group,
                              f"gather {name}")
        return t
    return _map_fields(state, place)


def shard_batches(data, mesh: DeviceMesh, batched: bool = True):
    """This rank's contiguous rows of batched data every rank holds in
    full: axis 1 of leaves ``[B, bs, ...]`` (``batched=True``) or axis 0 of
    ``[rows, ...]``, split evenly over the data axis (tensors or nested
    tuples, lists or dicts of them).  The data axis must divide the
    rows: the port raises where the JAX package would replicate the batch
    (a replicated batch summed over the data axis would count every row
    ``n_data`` times)."""
    from stochqn_tpu_torch.fused import _tree_map
    comm = MeshComm(mesh)
    axis = 1 if batched else 0

    def take(a):
        rows = a.shape[axis]
        if rows % comm.n_data:
            raise ValueError(
                f"the mesh's data axis ({comm.n_data}) must divide the "
                f"{rows} rows of every batch")
        k = rows // comm.n_data
        return a.narrow(axis, comm.data_rank * k, k).contiguous()
    return _tree_map(take, data)
