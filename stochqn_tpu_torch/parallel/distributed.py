"""Multi-process start-up and process-local data.

Counterpart of :mod:`stochqn_tpu.parallel.distributed`.  One process per
rank, as ``torchrun --nproc-per-node=N`` starts them: :func:`initialize`
forms the process group (NCCL on the card, gloo for ``"cpu"``),
:func:`global_mesh` lays every rank out as ``(data, param)``, and each
process loads only its rows (:func:`process_local_batch_slice`,
:func:`global_batches`).  With explicit SPMD there is no global array to
assemble: a rank's rows and its state slice are plain tensors on its
device.

Teardown: on an NCCL mesh a trainer's programs are CUDA graphs that hold
NCCL kernels.  Release them before ``torch.distributed.
destroy_process_group()``: drop every trainer that ran them and run
``gc.collect()``.  Destroying
the group under a live graph can hang, and a later replay would run on a
dead communicator.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from stochqn_tpu_torch.parallel.mesh import (MeshComm, make_mesh,
                                             shard_state)


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None,
               device_type: Optional[str] = None,
               timeout: Optional[datetime.timedelta] = None) -> None:
    """Form the default process group: from the arguments, or from
    torchrun's environment (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``).  A no-op for a single process and where the group
    exists.  NCCL on the card (the default; raises where there is none),
    gloo with ``device_type="cpu"``.

    The JAX package's ``initialize`` falls back to a single process when
    its auto-detection fails; this one raises whenever more than one
    process is named and the group does not form, so that a broken
    cluster never runs as one process."""
    if dist.is_initialized():
        return
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if world_size <= 1:
        return
    if rank is None:
        rank = int(os.environ["RANK"])
    if device_type is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "initialize forms an NCCL group of NVIDIA GPUs by default "
                "and none is available; pass device_type='cpu' for gloo")
        device_type = "cuda"
    backend = "gloo" if device_type == "cpu" else "nccl"
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    kw = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank, **kw)


def global_mesh(n_param: int = 1, device_type: Optional[str] = None):
    """A mesh over every rank of the group, the data axis spanning them
    (pure data parallelism by default) and ``n_param`` ranks per slice of
    the parameter axis."""
    return make_mesh(n_param=n_param, device_type=device_type)


def process_local_batch_slice(global_batch_size: int, mesh=None) -> slice:
    """The rows of a global batch this process loads: equal shares by
    data rank (ranks of one param group load the same rows), or by global
    rank where no mesh is given."""
    if mesh is not None:
        comm = MeshComm(mesh)
        share, index = comm.n_data, comm.data_rank
    elif dist.is_initialized():
        share, index = dist.get_world_size(), dist.get_rank()
    else:
        share, index = 1, 0
    per = global_batch_size // share
    return slice(index * per, (index + 1) * per)


def _on_device(data, mesh):
    """Tensors, numpy arrays or nested tuples, lists or dicts of them as
    tensors on this rank's device."""
    from stochqn_tpu_torch.fused import _tree_map
    dev = (torch.device("cpu") if mesh.device_type == "cpu" else
           torch.device(mesh.device_type, torch.cuda.current_device()))
    return _tree_map(lambda a: torch.as_tensor(a, device=dev), data)


def global_batches(local_data, mesh, batched: bool = True):
    """The rows this process loaded (its :func:`process_local_batch_slice`
    of the example axis: leaves ``[B, bs_local, ...]`` with ``batched``,
    else ``[rows_local, ...]``; either way they are this rank's already)
    as tensors on this rank's device: what
    :func:`stochqn_tpu_torch.parallel.mesh.shard_batches` gives from full
    data, without the full data ever being loaded."""
    return _on_device(local_data, mesh)


def shard_state_global(state, mesh):
    """Every process holds the full state (states are small next to
    data), so this is :func:`shard_state`: this rank's slice of every
    parameter-axis field."""
    return shard_state(state, mesh)


def replicate_global(value, mesh):
    """A value every process holds the same (the initial iterate) as a
    tensor on this rank's device."""
    return _on_device(value, mesh)
