"""Checkpoint / resume for optimizer states.

Counterpart of :mod:`stochqn_tpu.utils.checkpoint`'s ``.npz`` pair: the
whole optimizer state, the ``section`` coroutine resume point included, is
one nested dataclass of tensors, so a snapshot restores mid-protocol
exactly.  :func:`save_state` writes one array per tensor, keyed by its
field path (``"x"``, ``"mem/s"``, ``"fisher/head"``): the JAX package's
keys for the same state, with its integer fields as ``int32`` and
bfloat16 rows as their ``uint16`` bits (as :mod:`stochqn_tpu_torch.convert`
carries them).  So a float32 or float64 state written by either package
loads in the other.  Fields that are no tensor (a memory's commit mode
``shift``) are not stored: they come from the template.

The JAX package's orbax pair (sharded, multi-host states) waits for the
multi-GPU slice (ROADMAP A.15), where it becomes
``torch.distributed.checkpoint``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from stochqn_tpu_torch.convert import _array


def _leaves_with_paths(state, prefix=""):
    """``(path, tensor)`` for every tensor in a nested dataclass, dict,
    list or tuple, in field order."""
    if isinstance(state, torch.Tensor):
        return [(prefix, state)]
    if dataclasses.is_dataclass(state):
        items = [(f.name, getattr(state, f.name))
                 for f in dataclasses.fields(state)]
    elif isinstance(state, dict):
        items = list(state.items())
    elif isinstance(state, (list, tuple)):
        items = list(enumerate(state))
    else:
        return []                     # a static field: not stored
    out = []
    for key, value in items:
        out += _leaves_with_paths(value, f"{prefix}/{key}" if prefix
                                  else str(key))
    return out


def _replace(state, new, prefix=""):
    """``state`` with each tensor replaced by ``new[path]``."""
    if isinstance(state, torch.Tensor):
        return new[prefix]

    def sub(key, value):
        return _replace(value, new, f"{prefix}/{key}" if prefix else str(key))
    if dataclasses.is_dataclass(state):
        return dataclasses.replace(state, **{
            f.name: sub(f.name, getattr(state, f.name))
            for f in dataclasses.fields(state)})
    if isinstance(state, dict):
        return type(state)((k, sub(k, v)) for k, v in state.items())
    if isinstance(state, (list, tuple)):
        return type(state)(sub(i, v) for i, v in enumerate(state))
    return state


def save_state(path: str, state) -> None:
    """Write an optimizer state to a ``.npz`` file (one copy to the host
    per tensor)."""
    np.savez(path, **{key: _array(key.rsplit("/", 1)[-1], t)
                      for key, t in _leaves_with_paths(state)})


def _leaf(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if like.dtype == torch.bfloat16:
        bits = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16))
        t = bits.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.asarray(arr))
    return t.to(dtype=like.dtype, device=like.device)


def load_state(path: str, template):
    """Load a state saved by :func:`save_state` (by either package) into
    the structure of ``template``: the same field paths and shapes, each
    tensor in the template's dtype on the template's device.  Raises
    ``ValueError`` on a structure or shape mismatch."""
    with np.load(path) as data:
        flat = dict(data)
    leaves = _leaves_with_paths(template)
    keys = {key for key, _ in leaves}
    if keys != set(flat):
        raise ValueError("checkpoint structure mismatch: "
                         f"{sorted(keys ^ set(flat))}")
    new = {}
    for key, like in leaves:
        arr = flat[key]
        if arr.shape != tuple(like.shape):
            raise ValueError(
                f"checkpoint leaf {key!r} has shape {arr.shape}, "
                f"template has {tuple(like.shape)}")
        new[key] = _leaf(arr, like)
    return _replace(template, new)

