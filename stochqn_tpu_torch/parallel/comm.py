"""The collectives of the port's explicit SPMD execution, and their recorder.

The only module of the port that runs a collective.  Two operations, both
sums over one process group:

* :func:`all_reduce`: ``torch.distributed.all_reduce`` (sum), in place;
* :func:`all_gather`: a shard placed in a zero buffer of the full size
  and all-reduced, so every rank holds the concatenation along the last
  axis.  It moves ``group size`` times the bytes of a ring all-gather,
  but all-reduce and broadcast are the only collectives gloo runs on
  CUDA tensors, and several ranks on one card can only talk over gloo
  (NCCL refuses two ranks on one GPU): written so, the CPU tests and the
  card run the same code.

:func:`record_collectives` is the counterpart of the JAX package's
``parallel/hlo_stats.py``.  That module parses the collectives XLA put
into a compiled program; a torch program has no compiled text to parse,
so every call here is logged instead, while a recorder is open, with its
kind, its payload bytes, its group size and a caller's label.
:func:`collective_ops` and :func:`collective_bytes` read a log back, as
their JAX namesakes read HLO text; the tests lock the collective budgets
of a step with them.

Inside a CUDA-graph capture nothing runs, so a call there is recorded in
:data:`CAPTURED` (the graph being captured keeps that list, as it keeps
the kernel launches of ``two_loop_kernel.CAPTURED``), and each replay of
the graph adds its collectives to every open log (:func:`log_replay`).
Per-step budgets therefore read the same on a replayed epoch as on an
eager one.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator, List

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class CollectiveOp:
    kind: str            # "all-reduce" | "all-gather" (run as an all-reduce)
    payload_bytes: int   # bytes of the buffer the all-reduce sums
    group_size: int      # ranks in the group
    label: str           # what the caller reduced ("grad", "two_loop", ...)


# The logs of the recorders now open (a stack: recorders may nest).
_OPEN_LOGS: List[List[CollectiveOp]] = []
# The collectives called inside the CUDA-graph capture now running, in
# order (cleared and read by stochqn_tpu_torch.graphs).
CAPTURED: List[CollectiveOp] = []


@contextlib.contextmanager
def record_collectives() -> Iterator[List[CollectiveOp]]:
    """Log every collective run inside the block; yields the log, a list
    of :class:`CollectiveOp` filled as the calls happen."""
    log: List[CollectiveOp] = []
    _OPEN_LOGS.append(log)
    try:
        yield log
    finally:
        _OPEN_LOGS.remove(log)


def collective_ops(log: List[CollectiveOp], label=None) -> List[CollectiveOp]:
    """The recorded calls, or those with ``label``."""
    return [op for op in log if label is None or op.label == label]


def collective_bytes(log: List[CollectiveOp], label=None) -> int:
    """Total payload bytes of the recorded calls (or of those with
    ``label``)."""
    return sum(op.payload_bytes for op in collective_ops(log, label))


def log_replay(ops: List[CollectiveOp]) -> None:
    """Log the collectives a CUDA graph holds (``ops``, as
    :data:`CAPTURED` was after its capture) for one replay of it."""
    for log in _OPEN_LOGS:
        log.extend(ops)


def _capturing(buf: torch.Tensor) -> bool:
    """Whether ``buf``'s collective is being captured, not run."""
    return buf.is_cuda and torch.cuda.is_current_stream_capturing()


def _record(kind: str, buf: torch.Tensor, group, label: str) -> None:
    logs = [CAPTURED] if _capturing(buf) else _OPEN_LOGS
    if logs:
        op = CollectiveOp(kind, buf.numel() * buf.element_size(),
                          dist.get_world_size(group), label)
        for log in logs:
            log.append(op)


def all_reduce(buf: torch.Tensor, group, label: str) -> torch.Tensor:
    """Sum ``buf`` (contiguous) over ``group`` in place; returns it."""
    _record("all-reduce", buf, group, label)
    dist.all_reduce(buf, group=group)
    return buf


def all_gather(shard: torch.Tensor, group, label: str) -> torch.Tensor:
    """The shards of every rank of ``group``, in rank order, concatenated
    along the last axis: one all-reduce of zero-padded shards (exact: each
    entry is one shard's value plus zeros)."""
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    k = shard.shape[-1]
    full = shard.new_zeros(tuple(shard.shape[:-1]) + (k * size,))
    full[..., rank * k:(rank + 1) * k] = shard
    _record("all-gather", full, group, label)
    dist.all_reduce(full, group=group)
    return full
